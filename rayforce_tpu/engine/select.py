"""Device fast path for select: fused filter + group + aggregate.

The entire query — where-mask, dense group codes, every aggregate, and
the final first-appearance ordering — traces into ONE jitted function.
Aggregates are FINALIZED on device (limb recombination, avg division,
null fixes, output ordering via a dense argsort on first-row ids), so
the fetched lanes are exactly the output columns: the host pays one
execute round trip plus one batched transfer of ~output-table bytes.

Kernel strategy (see engine/groupby.py for the measured playbook —
no scatters, no 64-bit bitcasts, ever):

- dense group codes from cached column ranges (the reference's
  perfect/range-multiplier strategy, core/index.c:2308);
- n_codes <= SMALL_N: one chunked (L, n) broadcast-mask scan computes
  first/last row ids, f64 sums, and min/max directly;
- larger n: counts + exact integer limb sums via factored one-hot
  matmuls; extrema/f64 sums/order ride ONE stable sort
  [codes, iota, payloads...] + log-doubling segmented scans;
- group keys are decoded arithmetically from ordered dense slot ids on
  the host; first/last values are host-side gathers at fetched row ids.

Aggregate null semantics are oracle-pinned (tools/oracle.py against the
reference binary): GROUPED sum PROPAGATES nulls (ADD accumulators) while
a no-by select sums whole-vector and SKIPS them; avg skips; min/max skip
nulls with all-null groups yielding the typed INF sentinel (min) or the
typed null (max); count counts all rows. Group order is first-appearance (core/index.c group-id
assignment). Plans are cached by a structural fingerprint of the query
AST and its column identities.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import types as T
from ..core import symbols
from ..core.obj import Obj, to_np, table, enum_domain
from . import device as dev
from . import groupby as G
from .exprc import compile_expr, split_aggregate

_plan_cache: dict = {}

# last device query's phase timings, readable via the (internals)
# builtin — the analogue of the reference's -t timeit span recorder
# (chrono.h:62-81, printed per REPL eval in app/repl.c:76)
last_profile: dict = {}

INT_LIKE = (T.B8, T.U8, T.I16, T.I32, T.I64, T.DATE, T.TIME,
            T.TIMESTAMP, T.SYMBOL)
# host-parity result types (ops/math.py SUM_TYPE, oracle-pinned)
SUM_OUT = {T.U8: T.I64, T.I16: T.I64, T.I32: T.I32, T.I64: T.I64}
MINMAX_OK = (T.B8, T.U8, T.I16, T.I32, T.I64, T.DATE, T.TIME,
             T.TIMESTAMP, T.F64)
NARROW = (T.B8, T.U8, T.I16, T.I32, T.DATE, T.TIME)  # fits an i32 lane
F64_EXACT = 1 << 53


def _fingerprint(ast: Obj) -> str:
    t = ast.t
    if t == T.LIST:
        return "(" + " ".join(_fingerprint(x) for x in ast.v) + ")"
    if t == T.DICT:
        k, v = ast.v
        return "{" + _fingerprint(k) + ":" + _fingerprint(v) + "}"
    if t in (T.UNARY, T.BINARY, T.VARY):
        return "#" + ast.v.name
    if t == -T.SYMBOL:
        q = "'" if ast.attrs & 1 else ""
        return q + symbols.name_of(int(ast.v))
    if t < 0:
        return f"{t}:{ast.v}"
    if t == T.SYMBOL:
        return "[" + " ".join(symbols.name_of(int(s))
                              for s in to_np(ast)) + "]"
    if T.is_vector(t):
        return f"v{t}:{to_np(ast).tobytes().hex()[:64]}"
    return f"t{t}"


class _Agg:
    __slots__ = ("sid", "name", "inner", "meta")

    def __init__(self, sid, name, inner):
        self.sid = sid
        self.name = name
        self.inner = inner       # Compiled
        self.meta = {}


class _Plan:
    __slots__ = ("fn", "col_objs", "key_meta", "aggs", "n_codes",
                 "lanes_meta", "spmd")


def _null_mask(arr, rtype):
    if rtype == T.F64:
        return jnp.isnan(arr)
    nv = T.NULL_BY_TYPE.get(rtype)
    if nv is None:
        return jnp.zeros(arr.shape, bool)
    return arr == np.int64(nv) if arr.dtype == jnp.int64 else \
        arr == nv


def _minmax_payload(arr, rtype, is_min):
    """Value with nulls mapped to the losing extreme (reference skips
    nulls in MIN/MAX, ops.h:180-190). f64 stays in value space; ints
    are widened to i64."""
    nulls = _null_mask(arr, rtype)
    if rtype == T.F64:
        lim = jnp.float64(np.inf if is_min else -np.inf)
        return jnp.where(nulls, lim, arr)
    a = arr.astype(jnp.int64)
    lim = jnp.int64(G.KEY_MAX if is_min else G.I64_MIN)
    return jnp.where(nulls, lim, a)


def _parse_by(by_ast):
    by_pairs = []
    if by_ast is not None:
        if by_ast.t == -T.SYMBOL and not (by_ast.attrs & 1):
            by_pairs = [(int(by_ast.v), by_ast)]
        elif by_ast.t == T.DICT:
            bkeys, bvals = by_ast.v
            if bkeys.t != T.SYMBOL:
                return None
            bids = to_np(bkeys)
            by_pairs = [(int(bids[i]), bvals.v[i])
                        for i in range(len(bids))]
        else:
            return None
    return by_pairs


def _compile_keys(src, by_pairs):
    """Compile key exprs, returning (key_cs, key_meta, n_codes) where
    n_codes is the full (possibly huge) dense code-space size."""
    key_cs = []
    key_meta = []   # (name, lo, rng, rtype, enum_dom | None)
    n_codes = 1
    for nm, ast in by_pairs:
        dom = None
        ck = compile_expr(src, ast)
        if ck is None or ck.rtype in (T.F64, T.C8):
            return None
        if len(ck.cols) == 1 and ast.t == -T.SYMBOL and \
                ck.cols[0].col.t == T.ENUM:
            # group on raw enum codes; the output column stays ENUM
            # over the same domain (host parity)
            col = ck.cols[0].col
            dom = col.domain
            lo, hi = 0, max(len(enum_domain(col)) - 1, 0)
            slot = ck.cols[0].slot
            ck.fn = (lambda env, s=slot: env[s])
        elif len(ck.cols) == 1 and ast.t == -T.SYMBOL:
            lo, hi = dev.column_range(ck.cols[0].col)
        else:
            arr = jnp.asarray(ck.fn(
                [dev.dev_col(r.col) for r in ck.cols]))
            lo, hi = int(arr.min()), int(arr.max())
        rng = hi - lo + 1
        if rng <= 0:
            return None
        n_codes *= rng
        key_cs.append(ck)
        key_meta.append((nm, lo, rng, ck.rtype, dom))
    return key_cs, key_meta, n_codes


def _compile_aggs(src, outs):
    aggs = []
    for sid, ast in outs:
        sp = split_aggregate(src, ast)
        if sp is None:
            return None
        name, inner = sp
        if name not in ("count", "sum", "avg", "min", "max",
                        "first", "last", "med", "dev"):
            return None
        if name in ("sum", "avg", "med", "dev") and inner.rtype not \
                in (T.U8, T.I16, T.I32, T.I64, T.F64):
            return None  # host raises err_type; keep that behavior
        if name in ("min", "max") and inner.rtype not in MINMAX_OK:
            return None
        if name in ("first", "last") and (
                len(inner.cols) != 1 or ast.v[1].t != -T.SYMBOL):
            return None  # first/last of derived exprs -> host path
        ag = _Agg(sid, name, inner)
        ag.meta["plain_col"] = (name != "count" and
                                len(inner.cols) == 1 and
                                ast.v[1].t == -T.SYMBOL)
        aggs.append(ag)
    return aggs


def _build_plan(src, outs, where_ast, by_ast):
    n_rows = len(src)
    cw = None
    if where_ast is not None:
        cw = compile_expr(src, where_ast)
        if cw is None or cw.rtype != T.B8:
            return None

    by_pairs = _parse_by(by_ast)
    if by_pairs is None:
        return None
    keys = _compile_keys(src, by_pairs)
    if keys is None:
        return None
    key_cs, key_meta, n_codes = keys
    aggs = _compile_aggs(src, outs)
    if aggs is None:
        return None

    small = n_codes <= G.SMALL_N
    has_dev = any(a.name == "dev" for a in aggs)
    if by_pairs and (not small or has_dev):
        m = dev.mesh()
        if m is not None:
            # mesh mode: fan the grouped select out over the chips
            # (partial-aggregate all_to_all exchange) — including
            # beyond the single-chip dense ceiling: the exchange
            # carries raw i64 codes, so any single-word space
            # (< 2^61) distributes; shapes the distributed kernel
            # doesn't cover run single-chip
            from . import dgroup
            dp = dgroup.build_plan(src, n_rows, cw, key_cs, key_meta,
                                   n_codes, aggs, m)
            if dp is not None:
                return dp

    if n_codes > dev._cfg["dense_max"]:
        from . import wide
        return wide.build_plan(src, n_rows, cw, key_cs, key_meta,
                               aggs)

    if by_pairs and (not small or has_dev):
        # mid-cardinality (or dev-needing) grouped select: the
        # sort+compaction engine (engine/sortagg.py)
        from . import sortagg
        return sortagg.build_plan(src, n_rows, cw, key_cs, key_meta,
                                  n_codes, aggs)
    if has_dev:
        return None   # no-by dev: host path

    # --- shared column slots ---------------------------------------------
    col_objs = []
    slot_of = {}

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
    agg_maps = {id(a.inner): assign(a.inner) for a in aggs}

    # per-column requirements (deduped by compiled-expression identity)
    need_nullcnt = set()
    need_limbs = {}        # cid -> (lo, hi) stats or (None, None)
    need_fsum = set()      # f64 sums via the sort path (no stats)
    need_min = set()
    need_max = set()
    need_med = set()       # per-column (codes, value) sorts
    def may_null(a):
        """False only for a plain column whose cached stats prove it
        null-free — lets the plan drop the null-count matmul task."""
        if not a.meta.get("plain_col"):
            return True
        return dev.column_has_null(a.inner.cols[0].col)

    need_isumb = {}        # cid -> (lo, hi): exact f64 bcast-lane sums
    for a in aggs:
        cid = id(a.inner)
        if a.name in ("sum", "avg"):
            if may_null(a):
                need_nullcnt.add(cid)   # eff count for bias/avg
            if a.inner.rtype in INT_LIKE:
                rng_ = (None, None)
                if a.meta["plain_col"]:
                    rng_ = dev.column_range(a.inner.cols[0].col)
                lo_, hi_ = rng_
                if small and lo_ is not None and hi_ >= lo_ and \
                        max(abs(lo_), abs(hi_)) * n_rows < F64_EXACT:
                    # stats-bounded int sum: rides the bcast scan as
                    # an exact f64 lane (integers < 2^53) — no one-hot
                    # matmul task, no limb decomposition. With every
                    # int sum bounded, the small path drops the matmul
                    # scan entirely (the q1/q4 engine-time halving the
                    # round-2 roofline asked for).
                    need_isumb[cid] = rng_
                else:
                    need_limbs[cid] = rng_
            else:
                # f64 sums via the exact bcast-scan accumulator (this
                # path only runs for n_codes <= SMALL_N since
                # engine/sortagg.py took over mid-cardinality; the old
                # fixed-point-quantization task — a rounding hazard
                # near range edges — is gone with it)
                need_fsum.add(cid)
        elif a.name in ("min", "max"):
            if may_null(a):
                need_nullcnt.add(cid)
            (need_min if a.name == "min" else need_max).add(cid)
            if a.meta["plain_col"] and a.inner.rtype in \
                    (T.I64, T.TIMESTAMP, T.SYMBOL):
                a.meta["vrange"] = dev.column_range(a.inner.cols[0].col)
        elif a.name == "med":
            if may_null(a):
                need_nullcnt.add(cid)
            need_med.add(cid)

    def limb_meta(cid, rtype):
        lo, hi = need_limbs[cid]
        if lo is not None and hi >= lo:
            width = max((hi - lo).bit_length(), 1)
            bias = -lo
            bound = max(abs(lo), abs(hi)) * n_rows   # |group sum| bound
        else:
            width, bias, bound = 64, 1 << 63, 1 << 63
        n_limbs = -(-width // G.LIMB_BITS)
        return n_limbs, bias, bound

    NC = n_codes
    lanes_meta = {}
    grouped = bool(by_pairs)   # grouped sum PROPAGATES nulls
    #                            (aggr.c ADD accumulators); a no-by
    #                            select sums whole-vector = SKIPS

    # SPMD: small dense plans distribute over the global mesh — each
    # shard runs the same bcast+matmul pipeline on its rows; dense
    # lanes combine with psum / pmin / pmax collectives (the reference's
    # per-thread partials + AGGR_COLLECT, core/aggr.c:163-181, lifted
    # onto devices). Large/wide plans (global sorts) stay single-chip.
    m = dev.mesh()
    spmd = m is not None and small and not need_med
    if spmd:
        axis = m.axis_names[0]
        n_dev = m.shape[axis]
        rows_local = (n_rows + n_dev - 1) // n_dev
    else:
        axis = None
        rows_local = n_rows

    def _psum(x):
        return jax.lax.psum(x, axis) if spmd else x

    def _pmin(x):
        return jax.lax.pmin(x, axis) if spmd else x

    def _pmax(x):
        return jax.lax.pmax(x, axis) if spmd else x

    def pipeline(*cols):
        def sub_env(mapping):
            return [cols[i] for i in mapping]

        mask = None
        if cw is not None:
            mask = jnp.asarray(cw.fn(sub_env(w_map))).astype(bool)
        if spmd:
            # mask shard padding rows (global row id >= n_rows)
            me = jax.lax.axis_index(axis).astype(jnp.int64)
            gid0 = me * rows_local
            real = gid0 + jnp.arange(rows_local, dtype=jnp.int64) \
                < n_rows
            mask = real if mask is None else (mask & real)
        if key_cs:
            codes = None
            for ck, mp, (_nm, lo, rng, _rt, _dom) in zip(
                    key_cs, key_maps, key_meta):
                arr = jnp.asarray(ck.fn(sub_env(mp)))
                cc = (arr.astype(jnp.int64) - lo).astype(jnp.int32)
                codes = cc if codes is None else codes * rng + cc
        else:
            codes = jnp.zeros(rows_local, dtype=jnp.int32)
        if mask is not None:
            codes = jnp.where(mask, codes, NC)

        arrs = {}
        rtypes = {}
        for a in aggs:
            cid = id(a.inner)
            if a.name != "count" and cid not in arrs:
                arrs[cid] = jnp.asarray(a.inner.fn(sub_env(
                    agg_maps[cid])))
                rtypes[cid] = a.inner.rtype

        # ---- matmul tasks: integer limb sums only; counts/nullcnt
        # ride the bcast scan in the small path so q1/q4-shaped
        # queries skip the one-hot matmul scan entirely ----
        tasks = []
        if not small:
            tasks.append(("counts", jnp.ones(rows_local, jnp.float32)))
            for cid in sorted(need_nullcnt):
                nm = _null_mask(arrs[cid], rtypes[cid])
                tasks.append((f"nullcnt{cid}", nm.astype(jnp.float32)))
        for cid in sorted(need_limbs):
            lo, hi = need_limbs[cid]
            nv = T.NULL_BY_TYPE.get(rtypes[cid])
            limbs, _nw, _b = G.int_limb_weights(arrs[cid], nv, lo, hi)
            for i, lb in enumerate(limbs):
                tasks.append((f"limb{cid}_{i}", lb))

        mm = {}
        if tasks:
            dense = G.matmul_tasks_scan(codes, [w for _, w in tasks],
                                        NC + 1, rows_local)
            mm = {nm: _psum(d[:NC])
                  for (nm, _), d in zip(tasks, dense)}

        agg_raw = {}   # lane name -> dense device array (pre-order)
        if small:
            sums, s_names = [], []
            mins, mn_names = [], []
            maxs, mx_names = [], []
            for cid in sorted(need_nullcnt):
                nm = _null_mask(arrs[cid], rtypes[cid])
                sums.append(nm.astype(jnp.float64))
                s_names.append(f"nullcnt{cid}")
            for cid in sorted(need_isumb):
                arr = arrs[cid]
                nv = T.NULL_BY_TYPE.get(rtypes[cid])
                z = arr.astype(jnp.int64)
                if nv is not None:
                    z = jnp.where(arr == nv, 0, z)
                sums.append(z.astype(jnp.float64))   # exact < 2^53
                s_names.append(f"isum{cid}")
            for cid in sorted(need_fsum):
                arr = arrs[cid]
                sums.append(jnp.where(jnp.isnan(arr), 0.0, arr))
                s_names.append(f"fsum{cid}")
            for cid in sorted(need_min):
                mins.append(_minmax_payload(arrs[cid], rtypes[cid],
                                            True))
                mn_names.append(f"min{cid}")
            for cid in sorted(need_max):
                maxs.append(_minmax_payload(arrs[cid], rtypes[cid],
                                            False))
                mx_names.append(f"max{cid}")
            bc = G.bcast_scan(codes, NC, rows_local, sums=tuple(sums),
                              mins=tuple(mins), maxs=tuple(maxs),
                              want_counts=True, want_fidx=True)
            counts = _psum(bc["counts"]).astype(jnp.float64)
            fidx = bc["fidx"]                # KEY_MAX for empty groups
            lidx = bc["lidx"]
            if spmd:
                off = jax.lax.axis_index(axis).astype(jnp.int64) \
                    * rows_local
                fidx = _pmin(jnp.where(fidx == G.KEY_MAX,
                                       jnp.int64(G.KEY_MAX),
                                       fidx + off))
                lidx = _pmax(jnp.where(lidx < 0, jnp.int64(-1),
                                       lidx + off))
            for i, nm in enumerate(s_names):
                if nm.startswith("nullcnt"):
                    mm[nm] = _psum(bc[f"sum{i}"])
                else:
                    agg_raw[nm] = _psum(bc[f"sum{i}"])
            for i, nm in enumerate(mn_names):
                agg_raw[nm] = _pmin(bc[f"min{i}"])
            for i, nm in enumerate(mx_names):
                agg_raw[nm] = _pmax(bc[f"max{i}"])
        else:
            counts = mm["counts"]                   # f64, exact ints
            # ---- ONE stable sort covers order, extrema, f64 sums ----
            payloads, p_specs = [], []
            for cid in sorted(need_fsum):
                arr = arrs[cid]
                payloads.append(jnp.where(jnp.isnan(arr), 0.0, arr))
                p_specs.append(("fsum", cid))
            for cid in sorted(need_min):
                payloads.append(_minmax_payload(arrs[cid],
                                                rtypes[cid], True))
                p_specs.append(("min", cid))
            for cid in sorted(need_max):
                payloads.append(_minmax_payload(arrs[cid],
                                                rtypes[cid], False))
                p_specs.append(("max", cid))
            iota = jnp.arange(n_rows, dtype=jnp.int32)
            sorted_ = jax.lax.sort([codes, iota] + payloads,
                                   num_keys=1, is_stable=True)
            sc, siota = sorted_[0], sorted_[1]
            spay = sorted_[2:]
            cnt = counts.astype(jnp.int64)
            starts = jnp.concatenate(
                [jnp.zeros(1, jnp.int64), jnp.cumsum(cnt)[:-1]])
            ends = starts + cnt
            sa = jnp.clip(starts, 0, n_rows - 1).astype(jnp.int32)
            ea = jnp.clip(ends - 1, 0, n_rows - 1).astype(jnp.int32)
            occ_d = counts > 0
            fidx = jnp.where(occ_d, siota[sa].astype(jnp.int64),
                             jnp.int64(G.KEY_MAX))
            lidx = siota[ea].astype(jnp.int64)
            for (kind, cid), pay in zip(p_specs, spay):
                if kind == "fsum":
                    agg_raw[f"fsum{cid}"] = G.seg_doubling_sum(
                        sc, pay)[ea]
                elif kind == "min":
                    agg_raw[f"min{cid}"] = G.seg_doubling_min(
                        sc, pay)[ea]
                else:
                    agg_raw[f"max{cid}"] = G.seg_doubling_max(
                        sc, pay)[ea]

        # ---- med: per-column (codes, value) sort + middle gathers ----
        if need_med:
            cnt64 = counts.astype(jnp.int64)
            m_starts = jnp.concatenate(
                [jnp.zeros(1, jnp.int64), jnp.cumsum(cnt64)[:-1]])
        for cid in sorted(need_med):
            arr = arrs[cid]
            if rtypes[cid] == T.F64:
                key = jnp.where(jnp.isnan(arr), jnp.float64(np.inf),
                                arr)          # nulls sort last
            else:
                key = arr.astype(jnp.int64)
                nv = T.NULL_BY_TYPE.get(rtypes[cid])
                if nv is not None:
                    key = jnp.where(key == np.int64(nv),
                                    jnp.int64(G.KEY_MAX), key)
            _sc2, sval = jax.lax.sort([codes, key], num_keys=2)
            e = (counts - mm[f"nullcnt{cid}"]
                 if cid in need_nullcnt else counts).astype(jnp.int64)
            lo_i = m_starts + jnp.maximum(e - 1, 0) // 2
            hi_i = m_starts + e // 2
            lo_i = jnp.clip(lo_i, 0, rows_local - 1).astype(jnp.int32)
            hi_i = jnp.clip(hi_i, 0, rows_local - 1).astype(jnp.int32)
            v = (sval[lo_i].astype(jnp.float64)
                 + sval[hi_i].astype(jnp.float64)) / 2.0
            agg_raw[f"med{cid}"] = jnp.where(e == 0,
                                             jnp.float64(np.nan), v)

        # ---- device-side finalization: order, decode, narrow ----
        ordi = jnp.argsort(fidx).astype(jnp.int32)
        n_occ = (counts > 0).sum().astype(jnp.int32)

        P = G.Packer()
        P.add("nocc", jnp.reshape(n_occ, (1,)))
        P.add("slots", ordi)                        # i32: dense codes
        counts_o = counts[ordi]
        eff_cache = {}

        def eff(cid):
            if cid not in eff_cache:
                if cid in need_nullcnt:
                    eff_cache[cid] = counts_o - \
                        mm[f"nullcnt{cid}"][ordi]
                else:
                    eff_cache[cid] = counts_o
            return eff_cache[cid]

        emitted = set()
        for a in aggs:
            cid = id(a.inner)
            rt = a.inner.rtype if a.name != "count" else T.I64
            lane = f"{a.name}:{a.sid}"
            if lane in emitted:
                continue
            emitted.add(lane)
            if a.name == "count":
                P.add(lane, counts_o.astype(
                    jnp.int32 if n_rows < (1 << 31) else jnp.int64))
            elif a.name == "first":
                P.add(lane, fidx[ordi].astype(jnp.int32))
            elif a.name == "last":
                P.add(lane, lidx[ordi].astype(jnp.int32))
            elif a.name in ("min", "max"):
                # all-null groups: min keeps the typed INF init, max
                # yields typed NULL (aggr.c:1158-1256, oracle-pinned)
                v = agg_raw[f"{a.name}{cid}"][ordi]
                nullable = cid in need_nullcnt
                plainc = a.meta.get("plain_col")
                if nullable:
                    empty = mm[f"nullcnt{cid}"][ordi] == counts_o
                if rt == T.F64:
                    if nullable and (a.name == "max" or not plainc):
                        # derived-expr min follows whole-vector
                        # semantics: all-null -> 0Nf (host-pinned)
                        v = jnp.where(empty, jnp.float64(np.nan), v)
                    # plain min: nulls mapped +inf; all-null stays +inf
                    P.add(lane, v)
                else:
                    narrow = rt in NARROW
                    if not narrow and not nullable and \
                            "vrange" in a.meta:
                        vlo, vhi = a.meta["vrange"]
                        narrow = -(1 << 31) <= vlo and vhi < (1 << 31)
                    if nullable:
                        if a.name == "max" or not plainc:
                            # derived-expr min = whole-vector
                            # semantics: all-null -> typed NULL
                            fillv = np.int64(T.NULL_BY_TYPE.get(
                                rt, T.NULL_I64))
                        else:   # plain min: typed INF (iinfo max)
                            fillv = np.int64(np.iinfo(
                                T.DTYPE[rt]).max)
                        v = jnp.where(empty, fillv, v)
                        narrow = rt in NARROW
                    P.add(lane, v.astype(jnp.int32) if narrow else v)
            elif a.name == "med":
                P.add(lane, agg_raw[f"med{cid}"][ordi])
            elif rt == T.F64:   # f64 sum / avg
                s = agg_raw[f"fsum{cid}"][ordi]
                if a.name == "avg":
                    e = eff(cid)
                    s = jnp.where(e == 0, jnp.float64(np.nan), s / e)
                elif grouped and cid in need_nullcnt and \
                        a.meta.get("plain_col"):
                    # grouped sum of a PLAIN column propagates nulls;
                    # derived exprs sum per-group vectors which SKIP
                    # them (oracle-pinned)
                    s = jnp.where(mm[f"nullcnt{cid}"][ordi] > 0,
                                  jnp.float64(np.nan), s)
                P.add(lane, s)
            else:               # integer sum / avg
                if cid in need_isumb:
                    lo_, hi_ = need_isumb[cid]
                    bound = max(abs(lo_), abs(hi_)) * n_rows
                    n_limbs = 0
                else:
                    n_limbs, bias, bound = limb_meta(cid, rt)
                if bound < F64_EXACT:
                    if cid in need_isumb:
                        tot = agg_raw[f"isum{cid}"][ordi]
                    else:
                        tot = jnp.zeros(NC, jnp.float64)
                        for i in range(n_limbs):
                            tot = tot + mm[f"limb{cid}_{i}"] * float(
                                1 << (G.LIMB_BITS * i))
                        tot = tot[ordi] - eff(cid) * float(bias)
                    if a.name == "avg":
                        e = eff(cid)
                        P.add(lane, jnp.where(
                            e == 0, jnp.float64(np.nan), tot / e))
                    else:
                        v = tot.astype(jnp.int64)
                        if grouped and cid in need_nullcnt and \
                                a.meta.get("plain_col"):
                            ot = SUM_OUT.get(rt, T.I64)
                            nv = np.int64(T.NULL_BY_TYPE.get(
                                ot, T.NULL_I64))
                            v = jnp.where(
                                mm[f"nullcnt{cid}"][ordi] > 0, nv, v)
                            P.add(lane, v)
                        else:
                            P.add(lane, v.astype(jnp.int32)
                                  if bound < (1 << 31) else v)
                else:
                    # full-width fallback: host recombines exactly
                    for i in range(n_limbs):
                        P.add(f"limb{cid}_{i}", mm[f"limb{cid}_{i}"
                                                   ][ordi])
                    nc = (mm[f"nullcnt{cid}"][ordi]
                          if cid in need_nullcnt
                          else jnp.zeros(NC, jnp.float64))
                    P.add(f"ncnt{cid}", nc.astype(jnp.int64))
                    P.add(f"cnt{cid}", counts_o.astype(jnp.int64))

        bufs, layout = P.pack()
        lanes_meta["layout"] = layout
        return bufs

    plan = _Plan()
    if spmd:
        from jax.sharding import PartitionSpec as P

        smapped = jax.shard_map(
            pipeline, mesh=m,
            in_specs=tuple(P(axis) for _ in col_objs),
            out_specs=(P(), P(), P()), check_vma=False)
        plan.fn = jax.jit(smapped)
        plan.spmd = True
    else:
        plan.fn = jax.jit(pipeline)
        plan.spmd = False
    plan.col_objs = col_objs
    plan.key_meta = key_meta
    plan.aggs = aggs
    plan.n_codes = n_codes
    plan.lanes_meta = lanes_meta

    for a in aggs:
        cid = id(a.inner)
        if a.name in ("sum", "avg") and a.inner.rtype in INT_LIKE:
            if cid in need_isumb:
                a.meta["limb_fallback"] = False
                continue
            n_limbs, bias, bound = limb_meta(cid, a.inner.rtype)
            a.meta["limb_fallback"] = bound >= F64_EXACT
            a.meta["n_limbs"] = n_limbs
            a.meta["bias"] = bias
            a.meta["cid"] = cid
    return plan


def _host_gather(col_obj: Obj, idx: np.ndarray) -> Obj:
    """first/last: gather column values at group row ids on the host."""
    from ..ops.compose import gather
    return gather(col_obj, idx.astype(np.int64))


def try_select_device(interp, src: Obj, outs, where_ast, by_ast, lim,
                      empty_to_none=True):
    """empty_to_none=False returns the string "empty" for an
    all-filtered result instead of collapsing it to None — parted
    streaming uses it to tell an EMPTY partition (skip it) from an
    UNSUPPORTED shape (host fallback)."""
    if not dev.available() or not dev.should_use(len(src)):
        return None
    if not outs:
        return None
    # NOTE: the cache entry PINS src. Keys include id(src); a transient
    # table could die and CPython could hand its id to a NEW same-length
    # table, silently serving a stale plan that computes on the OLD
    # captured columns (observed via the parted streaming tests'
    # per-partition sub-tables). Holding src in the entry makes id
    # reuse impossible while the entry lives.
    key = (id(src), len(src),
           _fingerprint(where_ast) if where_ast is not None else "",
           _fingerprint(by_ast) if by_ast is not None else "",
           tuple((sid, _fingerprint(ast)) for sid, ast in outs))
    from ..core import profiler as _prof
    ent = _plan_cache.get(key)
    plan = ent[0] if ent is not None else None
    if plan is None:
        plan = _build_plan(src, outs, where_ast, by_ast)
        _prof.tick("device: build plan")
        if plan is None:
            _plan_cache[key] = ("unsupported", src)
            return None
        _plan_cache[key] = (plan, src)
        if len(_plan_cache) > 512:
            # FIFO eviction: long-running servers must not pin tables
            # (and their HBM columns) forever
            _plan_cache.pop(next(iter(_plan_cache)))
    if plan == "unsupported":
        return None

    from . import dgroup as _dg
    if isinstance(plan, _dg._DPlan):
        import time as _t
        t0 = _t.perf_counter()
        r = _dg.run(plan)
        last_profile.clear()
        last_profile.update({"engine": "dist-group",
                             "exec_ms": (_t.perf_counter() - t0) * 1e3})
        return (None if empty_to_none else r) \
            if isinstance(r, str) else r

    from . import sortagg as _sa
    if isinstance(plan, _sa._SAPlan):
        import time as _t
        t0 = _t.perf_counter()
        r = _sa.run(plan)
        last_profile.clear()
        last_profile.update({"engine": "sortagg",
                             "exec_ms": (_t.perf_counter() - t0) * 1e3,
                             "n_codes": plan.n_codes,
                             "exact": plan.exact})
        return (None if empty_to_none else r) \
            if isinstance(r, str) else r

    from . import wide as _wd
    if isinstance(plan, _wd._WPlan):
        import time as _t
        t0 = _t.perf_counter()
        r = _wd.run(plan)
        last_profile.clear()
        last_profile.update({"engine": "wide",
                             "exec_ms": (_t.perf_counter() - t0) * 1e3})
        return (None if empty_to_none else r) \
            if isinstance(r, str) else r

    import time as _t
    t0 = _t.perf_counter()
    if plan.spmd:
        m = dev.mesh()
        cols = [dev.dev_col_sharded(c, m) for c in plan.col_objs]
    else:
        cols = [dev.dev_col(c) for c in plan.col_objs]
    bufs = plan.fn(*cols)
    t1 = _t.perf_counter()
    if plan.spmd:
        # inline psum/pmin/pmax combines: ~2*(n-1)*replicated bytes
        from ..parallel import dist as _dist
        nd = m.shape[m.axis_names[0]]
        rb = sum(b.nbytes for b in jax.tree_util.tree_leaves(bufs))
        _dist.stats["exchanged_bytes"] += 2 * (nd - 1) * rb
        _dist.stats["kernel_calls"] += 1
    bufs = jax.device_get(bufs)     # ONE batched device->host transfer
    t2 = _t.perf_counter()
    lanes = G.unpack(bufs, plan.lanes_meta["layout"])
    last_profile.clear()
    last_profile.update({"engine": "bcast-spmd" if plan.spmd else "bcast",
                         "dispatch_ms": (t1 - t0) * 1000,
                         "exec+fetch_ms": (t2 - t1) * 1000,
                         "n_codes": plan.n_codes,
                         "spmd": plan.spmd})

    k = int(lanes["nocc"][0])
    if k == 0:
        # every row filtered out: the host path carries the empty/
        # no-by result semantics (a no-by select still yields ONE row
        # of whole-vector-over-empty aggregates, e.g. avg -> 0Nf)
        return None if empty_to_none else "empty"
    slots = lanes["slots"][:k].astype(np.int64)

    out_names: list[int] = []
    out_cols: list[Obj] = []

    # decode key values arithmetically from dense slot ids
    muls = []
    m = 1
    for _nm, _lo, rng, _rt, _dom in reversed(plan.key_meta):
        muls.append(m)
        m *= rng
    muls.reverse()
    for (nm, lo, rng, rt, dom), mul in zip(plan.key_meta, muls):
        vals = (slots // mul) % rng + lo
        out_names.append(nm)
        if dom is not None:
            out_cols.append(Obj(T.ENUM, vals.astype(np.int64),
                                domain=dom))
        elif rt == T.SYMBOL:
            out_cols.append(Obj(T.SYMBOL, vals.astype(np.int64)))
        else:
            out_cols.append(Obj(rt, vals.astype(T.DTYPE[rt])))

    for a in plan.aggs:
        out_names.append(a.sid)
        rt = a.inner.rtype if a.name != "count" else T.I64
        lane = f"{a.name}:{a.sid}"
        if a.name == "count":
            out_cols.append(Obj(T.I64,
                                lanes[lane][:k].astype(np.int64)))
        elif a.name in ("first", "last"):
            out_cols.append(_host_gather(a.inner.cols[0].col,
                                         lanes[lane][:k]))
        elif a.name in ("min", "max"):
            v = lanes[lane][:k]
            if rt == T.F64:
                out_cols.append(Obj(T.F64, v.astype(np.float64)))
            else:
                out_cols.append(Obj(rt, v.astype(T.DTYPE[rt])))
        elif a.name == "med":
            out_cols.append(Obj(T.F64,
                                lanes[lane][:k].astype(np.float64)))
        elif rt == T.F64 or a.name == "avg":
            if a.meta.get("limb_fallback"):
                out_cols.append(self_recombine(a, lanes, k, avg=True,
                    grouped=bool(plan.key_meta) and bool(a.meta.get("plain_col"))))
            else:
                out_cols.append(Obj(T.F64,
                                    lanes[lane][:k].astype(np.float64)))
        else:  # integer sum
            if a.meta.get("limb_fallback"):
                out_cols.append(self_recombine(a, lanes, k, avg=False,
                    grouped=bool(plan.key_meta) and bool(a.meta.get("plain_col"))))
            else:
                ot = SUM_OUT.get(rt, T.I64)
                out_cols.append(Obj(ot,
                                    lanes[lane][:k].astype(T.DTYPE[ot])))

    return table(Obj(T.SYMBOL, np.asarray(out_names, dtype=np.int64)),
                 out_cols)


def self_recombine(a: _Agg, lanes, k, avg: bool,
                   grouped: bool = True) -> Obj:
    """Host-exact recombination for full-width integer sums whose
    bound exceeds 2^53 (rare: full-range i64 columns)."""
    cid = a.meta["cid"]
    limb_sums = [lanes[f"limb{cid}_{i}"][:k]
                 for i in range(a.meta["n_limbs"])]
    nullc = lanes[f"ncnt{cid}"][:k]
    counts = lanes[f"cnt{cid}"][:k]
    tot = G.recombine_limbs(limb_sums, a.meta["bias"], counts, nullc)
    if avg:
        eff = (counts - nullc).astype(np.float64)
        num = np.array([float(x) for x in tot], dtype=np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            v = num / eff
        v = np.where(eff == 0, T.NULL_F64, v)
        return Obj(T.F64, v)
    wrapped = ((tot.astype(object) + (1 << 63)) % (1 << 64)) - (1 << 63)
    vals = np.array([int(x) for x in wrapped], dtype=np.int64)
    ot = SUM_OUT.get(a.inner.rtype, T.I64)
    if grouped:   # grouped sum propagates nulls (oracle-pinned)
        nv = T.NULL_BY_TYPE.get(ot, T.NULL_I64)
        vals = np.where(nullc > 0, np.int64(nv), vals)
    return Obj(ot, vals.astype(T.DTYPE[ot]))
