"""Mesh-mode grouped selects: the interpreter route that fans a
mid/high-cardinality group-by out over the device mesh.

When RAYFORCE_MESH is active, a grouped select whose shape the
distributed kernels cover — any single-word code space (< 2^61), EVERY
aggregate (count/sum/avg/min/max/first/last/dev/med) over plain
nullable columns plus derived expressions whose values provably fit
the f64 lanes — runs distributed instead of single-chip:

- count/sum/avg/min/max/first/last/dev ride the partial-aggregate
  all_to_all exchange of parallel/dist.py:dist_wide_groupby — the
  reference's radix-partition grouping (core/index.c:2556) across
  chips. Each distinct (combiner, column, transform) triple is one
  f64 lane with the matching decomposable combiner (AGGR_COLLECT
  merge, core/aggr.c:163-181); nullable columns add exact flag lanes
  (any-null for plain-sum propagation, any-non-null for min/max
  all-null groups: typed-INF min init per aggr.c:1241, typed-NULL
  max); first/last resolve positionally by global row id; dev rides
  globally-shifted sum moments.
- med (not decomposable) rides the raw-row hash shuffle of
  dist_med_groupby: complete groups per chip + local sorted
  selection, aligned to the partial kernel by first-row ids.

Unsupported shapes fall back to the single-chip sortagg/wide plans
(still correct: columns land unsharded).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import types as T
from ..core.obj import Obj, table, DevPendingSliced
from . import device as dev

SUM_OUT = {T.U8: T.I64, T.I16: T.I64, T.I32: T.I32, T.I64: T.I64}

_NUMERIC = (T.U8, T.I16, T.I32, T.I64, T.F64)


class _DPlan:
    __slots__ = ("mesh", "run_kernel", "run_med", "col_objs",
                 "key_meta", "aggs", "n_rows", "agg_lane", "lane_ops")


def build_plan(src, n_rows, cw, key_cs, key_meta, n_codes, aggs, mesh):
    """Distributed grouped-select plan, or None when the shape is not
    covered (caller falls back to the single-chip engines)."""
    if n_codes > (1 << 61) or n_rows == 0:
        return None
    # aggregates: count / sum / avg / min / max over plain numeric
    # columns; one f64 exchange lane per distinct (combiner, column,
    # transform). Nullable columns add exact flag lanes instead of
    # sentinel-compare tricks (so +/-inf DATA values stay correct).
    lane_ops: list = []     # combiner per lane: sum | min | max
    lane_exprs: list = []   # (value expr, transform) per lane
    lane_of: dict = {}      # (op, col id, transform) -> lane index
    med_exprs: list = []    # value exprs for the median shuffle kernel
    med_of: dict = {}       # col id -> median lane index
    agg_lane: dict = {}     # agg position -> lane-role dict or None
    nullable: dict = {}     # col id -> bool
    for ai, a in enumerate(aggs):
        if a.name == "count":
            agg_lane[ai] = None
            continue
        if a.name not in ("sum", "avg", "min", "max", "first",
                          "last", "dev", "med"):
            return None
        if a.inner.rtype not in _NUMERIC:
            return None
        plain = bool(a.meta.get("plain_col"))
        # plain single-column aggs key lanes by the COLUMN, so
        # `sum v` and `avg v` (distinct Compiled objects) share one
        # sum lane instead of exchanging it twice
        cid = id(a.inner.cols[0].col) if plain else id(a.inner)
        lo = hi = None
        if plain:
            try:
                col = a.inner.cols[0].col
                if cid not in nullable:
                    nullable[cid] = bool(dev.column_has_null(col))
                lo, hi = dev.column_range(col)
                if a.inner.rtype != T.F64:
                    reach = max(abs(int(lo)), abs(int(hi)))
                    # all lanes are f64: sums need exactness over the
                    # whole column's reach, min/max only per-value
                    lim = (1 << 53) // max(n_rows, 1) \
                        if a.name in ("sum", "avg") else (1 << 53)
                    if reach >= lim:
                        return None
                if a.name == "dev" and not (
                        np.isfinite(lo) and np.isfinite(hi)):
                    return None
            except Exception:
                return None
        else:
            # derived expressions: dev needs stats for its stabilizing
            # shift — single-chip; int-typed results need an interval-
            # arithmetic bound (exprc.expr_range) to prove the f64
            # lanes hold them exactly, F64-typed ones distribute as-is
            if a.name == "dev":
                return None
            if a.inner.rtype != T.F64:
                from . import exprc
                ast = getattr(a.inner, "ast", None)
                tb = getattr(a.inner, "tbl", None)
                r = exprc.expr_range(tb, ast) \
                    if ast is not None and tb is not None else None
                if r is None:
                    return None
                reach = max(abs(r[0]), abs(r[1]))
                lim = (1 << 53) // max(n_rows, 1) \
                    if a.name in ("sum", "avg") else (1 << 53)
                if reach >= lim:
                    return None
            nullable[cid] = True     # null-detect on computed values

        def lane(op, tf):
            lk = (op, cid, tf)
            if lk not in lane_of:
                lane_of[lk] = len(lane_ops)
                lane_ops.append(op)
                lane_exprs.append((a.inner, tf))
            return lane_of[lk]

        nul = nullable[cid]
        if a.name == "sum":
            roles = {"v": lane("sum", "null0" if nul else "raw")}
            if nul and plain:
                # plain sum PROPAGATES nulls (aggr.c ADD accumulators);
                # a DERIVED expression's per-group whole-vector sum
                # SKIPS them (oracle-pinned) — no flag lane
                roles["anynull"] = lane("max", "isnull")
        elif a.name == "avg":
            roles = {"v": lane("sum", "null0" if nul else "raw")}
            if nul:     # avg SKIPS nulls: divide by non-null count
                roles["nn"] = lane("sum", "notnull")
        elif a.name == "min":
            roles = {"v": lane("min", "mininf" if nul else "raw")}
            if nul:
                roles["anyval"] = lane("max", "notnull")
                # derived min all-null -> typed NULL, not INF
                roles["plain"] = plain
        elif a.name == "max":
            roles = {"v": lane("max", "maxninf" if nul else "raw")}
            if nul:
                roles["anyval"] = lane("max", "notnull")
        elif a.name in ("first", "last"):
            # positional, nulls ride through (int null sentinels are
            # powers of two — exact in f64)
            roles = {"v": lane(a.name, "raw")}
        elif a.name == "med":
            # not decomposable: rides the raw-row shuffle kernel
            # (dist_med_groupby) instead of the partial exchange
            if cid not in med_of:
                med_of[cid] = len(med_exprs)
                med_exprs.append((a.inner, "nanify"))
            roles = {"med": med_of[cid]}
        else:           # dev: globally-shifted sum moments (the
            # distributed analogue of sortagg's seg-min shift; the
            # column midpoint conditions E[x'^2]-E[x']^2 well enough
            # for fmt-precision parity since |x'| <= span/2)
            c = float(lo + (hi - lo) / 2.0)
            roles = {"v": lane("sum", ("shift", c)),
                     "v2": lane("sum", ("shiftsq", c))}
            if nul:     # dev SKIPS nulls
                roles["nn"] = lane("sum", "notnull")
        agg_lane[ai] = roles

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
    lane_maps = [assign(e) for e, _tf in lane_exprs]
    med_maps = [assign(e) for e, _tf in med_exprs]

    from ..parallel import dist
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    rows_local = (n_rows + n_dev - 1) // n_dev
    # stage A of dist_wide_groupby packs (code << pos_bits) | pos into
    # one signed i64; when code bits + position bits exceed 62 the
    # shift silently wraps. Such shapes fall back to the single-chip
    # wide engine, which packs multi-word keys correctly.
    code_bits = max(int(n_codes - 1).bit_length(), 1)
    pos_bits = max(int(rows_local - 1).bit_length(), 1)
    if code_bits + pos_bits > 62:
        return None

    plan = _DPlan()
    plan.mesh = mesh
    plan.col_objs = col_objs
    plan.key_meta = key_meta
    plan.aggs = aggs
    plan.n_rows = n_rows
    plan.agg_lane = agg_lane
    plan.lane_ops = tuple(lane_ops)

    def make_builder(exprs, maps):
        """SPMD builder: per-shard codes (i64, -1 = masked/padding)
        followed by one f64 lane per (expr, transform) pair."""
        def builder(*cols):
            def sub_env(mapping):
                return [cols[i] for i in mapping]

            nl = cols[0].shape[0] if cols else rows_local
            me = jax.lax.axis_index(axis).astype(jnp.int64)
            real = me * rows_local + jnp.arange(
                nl, dtype=jnp.int64) < n_rows
            mask = real
            if cw is not None:
                mask = mask & jnp.asarray(
                    cw.fn(sub_env(w_map))).astype(bool)
            codes = None
            for ck, mp, (_nm, lo, rng, _rt, _dom) in zip(
                    key_cs, key_maps, key_meta):
                arr = jnp.asarray(ck.fn(sub_env(mp)))
                cc = arr.astype(jnp.int64) - np.int64(lo)
                codes = cc if codes is None \
                    else codes * np.int64(rng) + cc
            if codes is None:
                codes = jnp.zeros(nl, jnp.int64)
            codes = jnp.where(mask, codes, jnp.int64(-1))

            def mk_lane(e, tf, mp):
                raw = jnp.asarray(e.fn(sub_env(mp)))
                if tf == "raw":
                    return raw.astype(jnp.float64)
                # null predicate on the TYPED values (the int
                # sentinels of core/types.py NULL_BY_TYPE; f64 nulls
                # are NaN)
                if e.rtype == T.F64:
                    nul = jnp.isnan(raw)
                else:
                    nv = T.NULL_BY_TYPE.get(e.rtype)
                    nul = (raw == raw.dtype.type(nv)) \
                        if nv is not None \
                        else jnp.zeros(raw.shape, bool)
                if tf == "isnull":
                    return nul.astype(jnp.float64)
                if tf == "notnull":
                    return (~nul).astype(jnp.float64)
                v = raw.astype(jnp.float64)
                if isinstance(tf, tuple):   # ("shift"|"shiftsq", c)
                    sh = v - jnp.float64(tf[1])
                    m = sh if tf[0] == "shift" else sh * sh
                    return jnp.where(nul, jnp.float64(0.0), m)
                if tf == "nanify":          # nulls -> NaN (sort last)
                    return jnp.where(nul, jnp.float64(np.nan), v)
                if tf == "null0":
                    return jnp.where(nul, jnp.float64(0.0), v)
                if tf == "mininf":
                    return jnp.where(nul, jnp.float64(np.inf), v)
                return jnp.where(nul, jnp.float64(-np.inf),
                                 v)          # maxninf

            lanes = [mk_lane(e, tf, mp)
                     for (e, tf), mp in zip(exprs, maps)]
            return tuple([codes] + lanes)
        return builder

    from jax.sharding import PartitionSpec as P

    def sharded(builder, n_out):
        return jax.shard_map(
            builder, mesh=mesh,
            in_specs=tuple(P(axis) for _ in col_objs),
            out_specs=tuple(P(axis) for _ in range(n_out)),
            check_vma=False)

    code_builder = make_builder(lane_exprs, lane_maps)
    n_lanes = len(lane_ops)
    # per-chip ownership bound (ceil(n_codes/n_dev) codes land on
    # each chip under mod ownership) tightens the merge capacity for
    # dense-ish spaces — buffers shrink from rows_local to
    # ~n_codes/n_dev (dist.dist_wide_groupby docstring); wide spaces
    # keep the row-bound + doubling retry
    cap = [max(min(2 * rows_local, -(-n_codes // n_dev)), 64)]
    kernels = {}

    def make(c):
        base = dist.dist_wide_groupby(mesh, rows_local, c,
                                      plan.lane_ops, n_codes)
        sm = sharded(code_builder, 1 + n_lanes)

        @jax.jit
        def full(*cs):
            outs = sm(*cs)
            return base.inner(outs[0], *outs[1:])
        return full, base.est

    def run_kernel(cols):
        # overflow-safe: retry with doubled merge capacity (rare —
        # needs extreme hash imbalance across group codes)
        while True:
            c = cap[0]
            if c not in kernels:
                kernels[c] = make(c)
            f, est = kernels[c]
            dist.stats["exchanged_bytes"] += int(est())
            dist.stats["kernel_calls"] += 1
            outs = f(*cols)
            ng_, ovf = (int(np.asarray(outs[0])[0]),
                        int(np.asarray(outs[1])[0]))
            if ovf == 0:
                return ng_, outs[2:]
            cap[0] = c * 2

    plan.run_kernel = run_kernel

    if med_exprs:
        med_builder = make_builder(med_exprs, med_maps)
        n_med = len(med_exprs)
        mcaps = [max(2 * rows_local // n_dev, 64),
                 max(2 * rows_local // n_dev, 64)]
        med_kernels = {}

        def make_med(c, oc):
            base = dist.dist_med_groupby(mesh, rows_local, c, oc,
                                         n_med)
            sm = sharded(med_builder, 1 + n_med)

            @jax.jit
            def full(*cs):
                outs = sm(*cs)
                return base.inner(outs[0], *outs[1:])
            return full, base.est

        def run_med(cols):
            while True:
                key = (mcaps[0], mcaps[1])
                if key not in med_kernels:
                    med_kernels[key] = make_med(*key)
                f, est = med_kernels[key]
                dist.stats["exchanged_bytes"] += int(est())
                dist.stats["kernel_calls"] += 1
                out = f(*cols)
                oe = int(np.asarray(out[1])[0])
                oo = int(np.asarray(out[2])[0])
                if oe == 0 and oo == 0:
                    # (codes, fidx, *medians)
                    return out[3:]
                if oe:
                    mcaps[0] *= 2
                if oo:
                    mcaps[1] *= 2

        plan.run_med = run_med
    else:
        plan.run_med = None
    return plan


def run(plan: _DPlan):
    cols = [dev.dev_col_sharded(c, plan.mesh) for c in plan.col_objs]
    ng, outs = plan.run_kernel(cols)
    ocode, ocnt, _fidx = outs[0], outs[1], outs[2]
    olanes = outs[3:]
    if ng <= 0:
        return "empty"
    omeds = None
    if plan.run_med is not None:
        # the shuffle kernel orders groups by the same global
        # first-row ids, so its lanes align with the partial
        # exchange's positions
        omeds = plan.run_med(cols)[2:]

    out_names: list[int] = []
    out_cols: list[Obj] = []
    code64 = ocode.astype(jnp.int64)
    muls = []
    m_ = 1
    for _nm, _lo, rng, _rt, _dom in reversed(plan.key_meta):
        muls.append(m_)
        m_ *= rng
    muls.reverse()
    for (nm, lo, rng, rt, dom), mul in zip(plan.key_meta, muls):
        vals = (code64 // mul) % rng + lo
        out_names.append(nm)
        if dom is not None:
            out_cols.append(Obj(T.ENUM, DevPendingSliced(
                vals.astype(jnp.int64), ng), domain=dom))
        elif rt == T.SYMBOL:
            out_cols.append(Obj(T.SYMBOL, DevPendingSliced(
                vals.astype(jnp.int64), ng)))
        else:
            out_cols.append(Obj(rt, DevPendingSliced(
                vals.astype(T.DTYPE[rt]), ng)))

    for ai, a in enumerate(plan.aggs):
        out_names.append(a.sid)
        roles = plan.agg_lane[ai]
        lane = olanes[roles["v"]] if roles is not None \
            and "v" in roles else None
        rt = a.inner.rtype if a.name != "count" else T.I64
        if a.name == "count":
            out_cols.append(Obj(T.I64, DevPendingSliced(
                ocnt.astype(jnp.int64), ng)))
        elif a.name == "med":
            out_cols.append(Obj(T.F64, DevPendingSliced(
                omeds[roles["med"]], ng)))
        elif a.name == "avg":
            e = olanes[roles["nn"]] if "nn" in roles \
                else ocnt.astype(jnp.float64)
            v = jnp.where(e == 0, jnp.float64(np.nan), lane / e)
            out_cols.append(Obj(T.F64, DevPendingSliced(v, ng)))
        elif a.name == "dev":
            e = olanes[roles["nn"]] if "nn" in roles \
                else ocnt.astype(jnp.float64)
            safe = jnp.where(e == 0, jnp.float64(1.0), e)
            mean = lane / safe
            var = olanes[roles["v2"]] / safe - mean * mean
            v = jnp.sqrt(jnp.maximum(var, 0.0))
            out_cols.append(Obj(T.F64, DevPendingSliced(
                jnp.where(e == 0, jnp.float64(np.nan), v), ng)))
        elif a.name in ("first", "last"):
            # positional values: int null sentinels round-trip the f64
            # lane exactly (powers of two), so a plain cast suffices
            if rt == T.F64:
                out_cols.append(Obj(T.F64, DevPendingSliced(lane, ng)))
            else:
                out_cols.append(Obj(rt, DevPendingSliced(
                    lane.astype(T.DTYPE[rt]), ng)))
        elif a.name in ("min", "max"):
            # all-null groups: plain grouped min keeps the typed INF
            # init (aggr.c:1241), plain grouped max yields typed NULL
            empty = (olanes[roles["anyval"]] == 0) \
                if "anyval" in roles else None
            if rt == T.F64:
                if empty is not None and (
                        a.name == "max"
                        or not roles.get("plain", True)):
                    lane = jnp.where(empty, jnp.float64(np.nan), lane)
                # plain f64 min: all-null stays +inf (typed INF)
                out_cols.append(Obj(T.F64, DevPendingSliced(lane, ng)))
            else:
                # sentinel substitution AFTER the int cast: f64->int
                # conversion near 2^63 is not portable across backends
                li = lane.astype(T.DTYPE[rt])
                if empty is not None:
                    # plain min all-null keeps typed INF (aggr.c:1241);
                    # derived min and any max yield typed NULL
                    sent = np.iinfo(T.DTYPE[rt]).max \
                        if a.name == "min" and roles.get("plain", True)\
                        else T.NULL_BY_TYPE.get(rt, T.NULL_I64)
                    li = jnp.where(empty, T.DTYPE[rt](sent), li)
                out_cols.append(Obj(rt, DevPendingSliced(li, ng)))
        elif rt == T.F64:       # f64 sum: plain sums PROPAGATE nulls
            if "anynull" in roles:
                lane = jnp.where(olanes[roles["anynull"]] > 0,
                                 jnp.float64(np.nan), lane)
            out_cols.append(Obj(T.F64, DevPendingSliced(lane, ng)))
        else:
            ot = SUM_OUT.get(rt, T.I64)
            # exact while |sum| < 2^53 (the f64 exchange lane); columns
            # with larger reach fall back via build_plan's guards
            li = lane.astype(T.DTYPE[ot])
            if "anynull" in roles:
                nv = T.NULL_BY_TYPE.get(ot, T.NULL_I64)
                li = jnp.where(olanes[roles["anynull"]] > 0,
                               T.DTYPE[ot](nv), li)
            out_cols.append(Obj(ot, DevPendingSliced(li, ng)))
    return table(Obj(T.SYMBOL, np.asarray(out_names, dtype=np.int64)),
                 out_cols)
