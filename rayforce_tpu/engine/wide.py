"""High-cardinality grouping (n_codes > dense_max, up to ~n_rows
groups): the analogue of the reference's radix-partitioned hash
grouping (core/index.c:2556-2729), built on the same sort+segment
design as engine/sortagg.py but with:

- group keys packed into MULTIPLE i64 sort words (a 6-key group-by
  whose dense code space exceeds 2^62 still works losslessly — no
  hashing, no collisions); the row position rides the last word's low
  bits, so first/last-row ids come from segment boundaries exactly;
- a trash bit above word 0 routes where-masked rows to the end;
- first-appearance output ordering via ONE more sort that carries the
  result lanes alongside the first-row-id key (n_groups can be ~n_rows,
  so NCAP-sized gathers would be full-width gathers; whether a gather
  or a carried sort is cheaper on the GPU has not been measured);
- outputs stay ON DEVICE (DevPendingSliced); the host fetches one
  scalar (the group count), so a q7-style 10M-group result is not
  copied to the host.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import types as T
from ..core.obj import Obj, table, DevPendingSliced
from . import device as dev
from . import groupby as G

_BIG = np.int32(1 << 30)
_TRASH_SHIFT = 61

SUM_OUT = {T.U8: T.I64, T.I16: T.I64, T.I32: T.I32, T.I64: T.I64}
NARROW32 = (T.B8, T.U8, T.I16, T.I32, T.DATE, T.TIME)


class _WPlan:
    __slots__ = ("fn", "col_objs", "key_meta", "aggs", "n_rows",
                 "out_meta")


def _dt_null(rt):
    return T.NULL_BY_TYPE.get(rt)


def build_plan(src, n_rows, cw, key_cs, key_meta, aggs):
    if n_rows >= (1 << 30) or n_rows == 0:
        return None
    if any(a.name in ("med", "dev") for a in aggs):
        return None   # host path covers these at extreme cardinality
    pos_bits = max((n_rows - 1).bit_length(), 1)

    # --- pack key dims into i64 words (word 0 keeps bit 61 for trash) --
    dims = []   # (bits, lo) per key dim
    for _nm, lo, rng, _rt, _dom in key_meta:
        bits = max(int(rng - 1).bit_length(), 1)
        if bits > 60:
            return None
        dims.append((bits, lo))
    words: list[list] = [[]]   # word -> [(dim_idx, shift, bits)]
    used = [0]
    cap0 = _TRASH_SHIFT
    for di, (bits, _lo) in enumerate(dims):
        cap = cap0 if len(words) == 1 else 62
        if used[-1] + bits > cap:
            words.append([])
            used.append(0)
        words[-1].append((di, 0, bits))
        used[-1] += bits
    # ...assign shifts (big-endian within each word: earlier dims in
    # higher bits so lexicographic word order == dim order)
    for wi, wdims in enumerate(words):
        total = used[wi]
        off = total
        fixed = []
        for di, _sh, bits in wdims:
            off -= bits
            fixed.append((di, off, bits))
        words[wi] = fixed
    # row position into the last word's low bits (or its own word)
    last_cap = cap0 if len(words) == 1 else 62
    if used[-1] + pos_bits <= last_cap:
        for i, (di, sh, bits) in enumerate(words[-1]):
            words[-1][i] = (di, sh + pos_bits, bits)
        pos_word = len(words) - 1
    else:
        words.append([])
        used.append(0)
        pos_word = len(words) - 1
    n_words = len(words)
    code_mask_last = ~((np.int64(1) << pos_bits) - 1) \
        if pos_word == n_words - 1 else np.int64(-1)

    # --- column slots ----------------------------------------------------
    col_objs: list = []
    slot_of: dict = {}

    def assign(ck):
        mapping = []
        for ref in ck.cols:
            key = id(ref.col)
            if key not in slot_of:
                slot_of[key] = len(col_objs)
                col_objs.append(ref.col)
            mapping.append(slot_of[key])
        return mapping

    w_map = assign(cw) if cw is not None else None
    key_maps = [assign(ck) for ck in key_cs]
    agg_maps = {}
    for a in aggs:
        cid = id(a.inner)
        if cid not in agg_maps:
            agg_maps[cid] = assign(a.inner)

    # --- aggregate needs --------------------------------------------------
    def may_null(a):
        if not a.meta.get("plain_col"):
            return True
        return dev.column_has_null(a.inner.cols[0].col)

    cinfo: dict = {}
    need_lidx = any(a.name == "last" for a in aggs)
    need_fvals = any(a.name in ("first", "last") for a in aggs)
    for a in aggs:
        cid = id(a.inner)
        ci = cinfo.setdefault(cid, {
            "rtype": a.inner.rtype, "ops": set(), "agg": a.inner,
            "plain": a.meta.get("plain_col", False)})
        if a.name in ("count", "first", "last"):
            continue
        if a.name in ("sum", "avg"):
            ci["ops"].add("sum")
        elif a.name in ("min", "max"):
            ci["ops"].add(a.name)
        else:
            return None
        if may_null(a):
            ci["ops"].add("null")

    operands: list = []
    op_ix: dict = {}
    for cid in sorted(cinfo):
        ci = cinfo[cid]
        if not ci["ops"]:
            continue
        rt = ci["rtype"]
        if rt == T.F64:
            kind = "f64"
            if ci["plain"]:
                # decimal fixed-point column (qscale stat): exact i32
                # sort operand, dequantized right after (sortagg has
                # the same fast path; see engine/device.py)
                qs = dev.column_qscale(ci["agg"].cols[0].col)
                if qs:
                    kind = ("q32", float(qs))
        elif rt in NARROW32:
            kind = "i32"
        else:
            kind = "i64"
            if ci["plain"] and "null" not in ci["ops"]:
                lo, hi = dev.column_range(ci["agg"].cols[0].col)
                if -(1 << 31) < lo and hi < (1 << 31):
                    kind = "i32"
        op_ix[cid] = len(operands)
        operands.append((cid, kind))

    out_meta: dict = {}
    N = n_rows

    def pipeline(*cols):
        def sub_env(mapping):
            return [cols[i] for i in mapping]

        mask = None
        if cw is not None:
            mask = jnp.asarray(cw.fn(sub_env(w_map))).astype(bool)
        dvals = []
        for ck, mp, (bits, lo) in zip(key_cs, key_maps, dims):
            arr = jnp.asarray(ck.fn(sub_env(mp)))
            dvals.append(arr.astype(jnp.int64) - np.int64(lo))

        wvals = []
        for wi, wdims in enumerate(words):
            w = jnp.zeros(N, jnp.int64)
            for di, sh, bits in wdims:
                w = w | (dvals[di] << np.int64(sh))
            if wi == pos_word:
                w = w | jnp.arange(N, dtype=jnp.int64)
            wvals.append(w)
        if mask is not None:
            trash = jnp.where(mask, jnp.int64(0),
                              jnp.int64(1) << _TRASH_SHIFT)
            wvals[0] = wvals[0] | trash

        arrs = {}
        for cid, ci in cinfo.items():
            if ci["ops"]:
                arrs[cid] = jnp.asarray(ci["agg"].fn(
                    sub_env(agg_maps[cid])))
        ops_in = []
        for cid, kind in operands:
            a = arrs[cid]
            if kind == "f64":
                ops_in.append(a.astype(jnp.float64))
            elif isinstance(kind, tuple):     # ("q32", scale)
                rq = jnp.round(a * jnp.float64(kind[1]))
                ops_in.append(jnp.where(
                    jnp.isnan(a), jnp.int32(np.int32(T.NULL_I32)),
                    rq.astype(jnp.int32)))
            elif kind == "i32":
                ops_in.append(a.astype(jnp.int32))
            else:
                ops_in.append(a.astype(jnp.int64))

        sorted_ = jax.lax.sort(wvals + ops_in, num_keys=n_words,
                               is_stable=False)
        sw = sorted_[:n_words]
        sops = sorted_[n_words:]

        valid = sw[0] < (np.int64(1) << _TRASH_SHIFT)  # trash bit clear
        swc = [sw[i] if i != pos_word else sw[i] & code_mask_last
               for i in range(n_words)]
        diff = None
        for i in range(n_words):
            d = swc[i][1:] != swc[i][:-1]
            diff = d if diff is None else (diff | d)
        flags = valid & jnp.concatenate([jnp.ones(1, bool), diff])
        ng = flags.sum().astype(jnp.int32)

        # REVERSED inclusive segmented scans put every segment's TOTAL
        # on its FIRST row — so all per-group quantities live on the
        # (already known) boundary rows with no boundary compaction
        # and no full-width gathers
        segid = jnp.cumsum(flags.astype(jnp.int32) +
                           (~valid).astype(jnp.int32))
        rsegid = segid[::-1]

        def rsum(x):
            return G.seg_doubling_sum(rsegid, x[::-1])[::-1]

        def rmin(x):
            return G.seg_doubling_min(rsegid, x[::-1])[::-1]

        def rmax(x):
            return G.seg_doubling_max(rsegid, x[::-1])[::-1]

        counts = rsum(jnp.ones(N, jnp.int64))
        posmask = (np.int64(1) << pos_bits) - 1
        pos_row = sw[pos_word] & posmask
        fidx = pos_row          # at a segment start: min pos = fidx
        lidx = rmax(pos_row)    # at a segment start: max pos = lidx

        segres = {}
        nullcnt = {}
        for cid, ci in cinfo.items():
            ops = ci["ops"]
            if not ops:
                continue
            rt = ci["rtype"]
            v = sops[op_ix[cid]]
            kind = operands[op_ix[cid]][1]
            if isinstance(kind, tuple):
                # quantized i32 operand -> f64 values with NaN nulls
                v = jnp.where(v == np.int32(T.NULL_I32),
                              jnp.float64(np.nan),
                              v.astype(jnp.float64) / kind[1])
            if rt == T.F64:
                nul = jnp.isnan(v)
            else:
                nv = _dt_null(rt)
                nul = (v == v.dtype.type(nv)) if nv is not None \
                    else None
                v = v.astype(jnp.int64)
            if "null" in ops and nul is not None:
                nullcnt[cid] = rsum(nul.astype(jnp.int64))
            if "sum" in ops:
                if rt == T.F64:
                    z = jnp.where(jnp.isnan(v), 0.0, v)
                else:
                    z = jnp.where(nul, 0, v) if nul is not None else v
                segres[("sum", cid)] = rsum(z)
            if "min" in ops:
                if rt == T.F64:
                    mv = jnp.where(jnp.isnan(v), jnp.float64(np.inf),
                                   v)
                else:
                    mv = jnp.where(nul, jnp.int64(G.KEY_MAX), v) \
                        if nul is not None else v
                segres[("min", cid)] = rmin(mv)
            if "max" in ops:
                if rt == T.F64:
                    mv = jnp.where(jnp.isnan(v),
                                   jnp.float64(-np.inf), v)
                else:
                    mv = jnp.where(nul, jnp.int64(G.I64_MIN), v) \
                        if nul is not None else v
                segres[("max", cid)] = rmax(mv)

        # ---- un-ordered per-group lanes (live on segment-start rows) ----
        lanes = {}
        code_words = swc

        for a in aggs:
            cid = id(a.inner)
            rt = a.inner.rtype if a.name != "count" else T.I64
            lane = f"{a.name}:{a.sid}"
            if lane in lanes:
                continue
            if a.name == "count":
                lanes[lane] = counts
            elif a.name == "first":
                srcv = cols[agg_maps[cid][0]]
                lanes[lane] = srcv[jnp.clip(fidx, 0, N - 1)]
            elif a.name == "last":
                srcv = cols[agg_maps[cid][0]]
                lanes[lane] = srcv[jnp.clip(lidx, 0, N - 1)]
            elif a.name in ("min", "max"):
                # all-null: plain min keeps typed INF; derived-expr
                # min and any max yield typed NULL (host-pinned)
                v = segres[(a.name, cid)]
                if cid in nullcnt:
                    empty = nullcnt[cid] >= counts
                    plain = a.meta.get("plain_col")
                    if rt == T.F64:
                        if a.name == "max" or not plain:
                            v = jnp.where(empty, jnp.float64(np.nan),
                                          v)
                    elif a.name == "max" or not plain:
                        nv = _dt_null(rt)
                        v = jnp.where(empty, np.int64(
                            nv if nv is not None else T.NULL_I64), v)
                    else:
                        v = jnp.where(empty, np.int64(np.iinfo(
                            T.DTYPE[rt]).max), v)
                if rt != T.F64:
                    v = v.astype(T.DTYPE[rt])
                lanes[lane] = v
            elif a.name == "avg":
                e = counts - nullcnt[cid] if cid in nullcnt else counts
                e = e.astype(jnp.float64)
                s = segres[("sum", cid)].astype(jnp.float64)
                lanes[lane] = jnp.where(e == 0, jnp.float64(np.nan),
                                        s / e)
            elif rt == T.F64:
                s = segres[("sum", cid)]
                if cid in nullcnt and a.meta.get("plain_col"):
                    s = jnp.where(nullcnt[cid] > 0,
                                  jnp.float64(np.nan), s)
                lanes[lane] = s
            else:
                s = segres[("sum", cid)]
                ot = SUM_OUT.get(rt, T.I64)
                if cid in nullcnt and a.meta.get("plain_col"):
                    nv = _dt_null(ot)
                    s = jnp.where(nullcnt[cid] > 0, np.int64(
                        nv if nv is not None else T.NULL_I64), s)
                lanes[lane] = s.astype(T.DTYPE[ot])

        # ---- first-appearance ordering: carry lanes through ONE sort ----
        # narrow carried words where bounds allow: positions fit i32
        # (n_rows < 2^30), counts fit i32 — half the sorted bytes of
        # a 64-bit operand
        fkey = jnp.where(flags, fidx,
                         jnp.int64(0x7FFFFFFF)).astype(jnp.int32)
        carry_names = list(lanes.keys())
        carried = []
        shrunk = set()
        for nm in carry_names:
            ln = lanes[nm]
            if nm.startswith("count:") and n_rows < (1 << 31):
                ln = ln.astype(jnp.int32)
                shrunk.add(nm)
            carried.append(ln)
        sorted2 = jax.lax.sort(
            [fkey] + code_words + carried, num_keys=1,
            is_stable=False)
        cw_o = sorted2[1:1 + n_words]
        lane_o = {}
        for nm, ln in zip(carry_names, sorted2[1 + n_words:]):
            lane_o[nm] = ln.astype(jnp.int64) if nm in shrunk else ln

        # decode key dims from ordered code words (elementwise)
        out = []
        names = []
        for wi, wdims in enumerate(words):
            for di, sh, bits in wdims:
                nm, lo, rng, rt, dom = key_meta[di]
                vals = (cw_o[wi] >> np.int64(sh)) & \
                    ((np.int64(1) << bits) - 1)
                vals = vals + np.int64(lo)
                if rt == T.SYMBOL or dom is not None:
                    arr = vals.astype(jnp.int64)
                else:
                    arr = vals.astype(T.DTYPE[rt])
                names.append(f"key{di}")
                out.append(arr)
        for nm in carry_names:
            names.append(nm)
            out.append(lane_o[nm])

        out_meta["names"] = names
        return (jnp.reshape(ng.astype(jnp.int64), (1,)),) + tuple(out)

    plan = _WPlan()
    plan.fn = jax.jit(pipeline)
    plan.col_objs = col_objs
    plan.key_meta = key_meta
    plan.aggs = aggs
    plan.n_rows = n_rows
    plan.out_meta = out_meta
    return plan


def run(plan: _WPlan):
    cols = [dev.dev_col(c) for c in plan.col_objs]
    outs = plan.fn(*cols)
    ng = int(jax.device_get(outs[0])[0])
    if ng <= 0:
        return "empty"
    lanes = dict(zip(plan.out_meta["names"], outs[1:]))

    out_names: list[int] = []
    out_cols: list[Obj] = []
    for i, (nm, lo, rng, rt, dom) in enumerate(plan.key_meta):
        out_names.append(nm)
        lane = lanes[f"key{i}"]
        if dom is not None:
            out_cols.append(Obj(T.ENUM, DevPendingSliced(lane, ng),
                                domain=dom))
        elif rt == T.SYMBOL:
            out_cols.append(Obj(T.SYMBOL, DevPendingSliced(lane, ng)))
        else:
            out_cols.append(Obj(rt, DevPendingSliced(lane, ng)))
    for a in plan.aggs:
        out_names.append(a.sid)
        rt = a.inner.rtype if a.name != "count" else T.I64
        lane = lanes[f"{a.name}:{a.sid}"]
        if a.name == "count":
            col = Obj(T.I64, DevPendingSliced(lane, ng))
        elif a.name in ("first", "last"):
            src = a.inner.cols[0].col
            if src.t == T.ENUM:
                col = Obj(T.ENUM, DevPendingSliced(lane, ng),
                          domain=src.domain)
            else:
                col = Obj(src.t, DevPendingSliced(lane, ng))
        elif a.name in ("min", "max"):
            col = Obj(rt, DevPendingSliced(lane, ng))
        elif a.name == "avg" or rt == T.F64:
            col = Obj(T.F64, DevPendingSliced(lane, ng))
        else:
            col = Obj(SUM_OUT.get(rt, T.I64),
                      DevPendingSliced(lane, ng))
        out_cols.append(col)
    return table(Obj(T.SYMBOL, np.asarray(out_names, dtype=np.int64)),
                 out_cols)
