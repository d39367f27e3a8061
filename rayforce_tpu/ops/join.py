"""Joins: left/inner/asof/window (reference core/join.c + core/index.c
index_*_join_obj).

Key matching uses joint factorization of the key columns of both tables
(the host analogue of the reference's row-hash + hash-table probe;
on device this becomes the sharded hash-join kernel in engine/).
Match semantics: FIRST matching right row per left row.
"""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core import symbols
from ..core.obj import (Obj, DevPending, to_np, list_, table,
                        NULL_OBJ, col_by_name)
from ..core.errors import err_type, err_arity, err_length
from .compose import gather
from .group import _col_codes
from .items import ray_at, ray_union, ray_except


def _joint_codes(lcols: list, rcols: list):
    """Per-row integer codes such that equal key rows (across both tables)
    get equal codes."""
    ln = len(lcols[0]) if lcols[0].t >= 0 else 1
    rn = len(rcols[0]) if rcols[0].t >= 0 else 1
    mats = []
    for lc, rc in zip(lcols, rcols):
        both = np.concatenate([_col_codes(lc), _col_codes(rc)])
        # factorize to compact ids so multi-column mixing can't overflow
        _, inv = np.unique(both, return_inverse=True)
        mats.append(inv.astype(np.int64))
    if len(mats) == 1:
        joint = mats[0]
    else:
        mat = np.stack(mats, axis=1)
        _, joint = np.unique(mat, axis=0, return_inverse=True)
        joint = joint.astype(np.int64)
    return joint[:ln], joint[ln:]


def _first_index_map(codes: np.ndarray):
    """code -> first index with that code."""
    n_codes = int(codes.max()) + 1 if len(codes) else 0
    first = np.full(n_codes, -1, dtype=np.int64)
    # reversed so earlier indices win
    first[codes[::-1]] = np.arange(len(codes) - 1, -1, -1, dtype=np.int64)
    return first


def left_join_ids(lkeys: list, rkeys: list) -> np.ndarray:
    """Per-left-row first-matching right row id, NULL_I64 when absent
    (index_left_join_obj, index.c:2886)."""
    lc, rc = _joint_codes(lkeys, rkeys)
    n_codes = int(max(lc.max() if len(lc) else -1,
                      rc.max() if len(rc) else -1)) + 1
    table_ = np.full(n_codes, T.NULL_I64, dtype=np.int64)
    if len(rc):
        table_[rc[::-1]] = np.arange(len(rc) - 1, -1, -1, dtype=np.int64)
    return table_[lc]


def _merge_columns(ltab: Obj, rtab: Obj, key_syms: Obj, lkey_cols: list,
                   rids: np.ndarray) -> Obj:
    """__left_join_inner (join.c:83): key cols from left; other columns
    take the right value on match, left value otherwise."""
    lnames, lcols = ltab.v
    rnames, rcols = rtab.v
    un = ray_union(lnames, rnames)
    rest = ray_except(un, key_syms)
    if len(rest) == 0:
        raise err_length("no non-key columns")
    out_names = list(to_np(key_syms)) + list(to_np(rest))
    out_cols: list = list(lkey_cols)
    n = len(ltab)
    has_match = rids != T.NULL_I64
    safe_rids = np.where(has_match, rids, 0)
    for sid in to_np(rest):
        nm = symbols.name_of(int(sid))
        c1 = col_by_name(ltab, nm)
        c2 = col_by_name(rtab, nm)
        if c2 is None:
            out_cols.append(c1)
            continue
        if c1 is None:
            # right-only column: unmatched rows hold the untyped Null, so
            # the column degrades to a LIST (reference select_column builds
            # through ins_obj of NULL_OBJ, join.c:38-66)
            if has_match.all():
                out_cols.append(gather(c2, safe_rids))
            else:
                from ..core.obj import at_idx
                items = [at_idx(c2, int(r)) if m else NULL_OBJ
                         for r, m in zip(safe_rids, has_match)]
                out_cols.append(list_(items))
            continue
        if _basic_type(c1) != _basic_type(c2):
            raise err_type("join column type mismatch")
        g2 = to_np(_materialize(gather(c2, safe_rids)))
        g1 = to_np(_materialize(c1))
        if c1.t == T.GUID:
            merged = np.where(has_match[:, None], g2, g1)
        else:
            merged = np.where(has_match, g2, g1)
        out_cols.append(Obj(_basic_type(c1), merged, domain=c1.domain))
    return table(Obj(T.SYMBOL, np.asarray(out_names, dtype=np.int64)),
                 out_cols)


def _basic_type(c: Obj) -> int:
    return c.t


def _materialize(c: Obj) -> Obj:
    if c.t == T.ENUM:
        from .items import ray_value
        return ray_value(c)
    return c


def _mask_nulls(g: Obj, mask: np.ndarray) -> Obj:
    t = g.t
    a = to_np(g).copy()
    if t in T.NULL_BY_TYPE:
        a[mask] = T.NULL_BY_TYPE[t]
    elif t == T.ENUM:
        a[mask] = T.NULL_I64
    elif t == T.GUID:
        a[mask] = 0
    else:
        a[mask] = 0
    return Obj(t, a, domain=g.domain)


def _check_join_args(args: list):
    if len(args) != 3:
        raise err_arity("join needs 3 args")
    keys, lt, rt = args
    if keys.t != T.SYMBOL:
        raise err_type("join keys must be symbols")
    if lt.t != T.TABLE or rt.t != T.TABLE:
        raise err_type("join needs tables")
    return keys, lt, rt


def _key_cols(tbl: Obj, keys: Obj) -> list:
    out = []
    for sid in to_np(keys):
        c = col_by_name(tbl, symbols.name_of(int(sid)))
        if c is None:
            raise err_type("missing join key column")
        out.append(c)
    return out


_DEV_COL_OK = (T.B8, T.U8, T.I16, T.I32, T.I64, T.DATE, T.TIME,
               T.TIMESTAMP, T.SYMBOL, T.F64, T.ENUM)


def _try_device_join(keys, lt, rt, lk, rk, mode: str):
    """Sort-merge join on the device (engine/join.py); returns the merged
    table with lazily device-resident columns, or None to fall back."""
    from ..engine import device as dv
    if not dv.available() or not dv.should_use(len(lt) + len(rt)):
        return None
    from ..engine import join as ej
    lnames, _ = lt.v
    rnames, _ = rt.v
    un = ray_union(lnames, rnames)
    rest = ray_except(un, keys)
    if len(rest) == 0:
        return None
    plan_cols = []
    for sid in to_np(rest):
        nm = symbols.name_of(int(sid))
        c1 = col_by_name(lt, nm)
        c2 = col_by_name(rt, nm)
        if c2 is None:
            plan_cols.append((sid, "left", c1))
            continue
        if c2.t not in _DEV_COL_OK:
            return None
        if c1 is not None:
            if c1.t != c2.t:
                return None  # host path raises the matching error
            if c2.t == T.ENUM and c1.domain is not c2.domain:
                return None
            plan_cols.append((sid, "overlay", (c1, c2)))
        else:
            plan_cols.append((sid, "right", c2))
    if mode == "asof":
        rids = ej.match_ids_device(lk[:-1], rk[:-1], ltime=lk[-1],
                                   rtime=rk[-1], mode="asof")
    else:
        rids = ej.match_ids_device(lk, rk)
    if rids is None:
        return None
    right_only_list = False
    if mode != "inner" and any(k == "right" for _s, k, _c
                               in plan_cols):
        # unmatched rows in a right-only column degrade to a LIST
        # of untyped nulls (join.c:38-66); stays lazy on device
        right_only_list = not ej.all_matched(rids)

    out_names = list(to_np(keys)) + [s for s, _k, _c in plan_cols]
    if mode == "inner":
        # compact matched rows by carrying every left-side column
        # through ONE sort instead of one gather per column
        carry_cols = list(lk) + [c for _s, k, c in plan_cols
                                 if k == "left"]
        carried = ej.inner_carry(rids, carry_cols)
        if carried is not None:
            n_match, rsel_lane, lanes = carried
            # every output lane materializes through ONE batched
            # executable (slices + right gathers) instead of one
            # dispatch per column
            right_cols = [c[1] if kind == "overlay" else c
                          for _sid, kind, c in plan_cols
                          if kind != "left"]
            thunks = ej.finalize_inner(n_match, rsel_lane, lanes,
                                       right_cols)
            it = iter(thunks[:len(lanes)])
            rit = iter(thunks[len(lanes):])

            def _col(th, like):
                o = Obj(like.t,
                        DevPending(thunk=th, shape=(n_match,)),
                        domain=like.domain)
                o.meta = {}
                return o
            out_cols = [_col(next(it), c) for c in lk]
            for _sid, kind, c in plan_cols:
                if kind == "left":
                    out_cols.append(_col(next(it), c))
                elif kind == "overlay":
                    out_cols.append(_col(next(rit), c[1]))
                else:
                    out_cols.append(_col(next(rit), c))
            return table(Obj(T.SYMBOL, np.asarray(
                out_names, dtype=np.int64)), out_cols)
        lids, rsel, n_match = ej.compact_ids(rids)
        out_cols = [ej.lazy_take_col(c, lids, n_match) for c in lk]
        for _sid, kind, c in plan_cols:
            if kind == "left":
                out_cols.append(ej.lazy_take_col(c, lids, n_match))
            elif kind == "overlay":
                out_cols.append(ej.lazy_take_col(c[1], rsel,
                                                 n_match))
            else:
                out_cols.append(ej.lazy_take_col(c, rsel, n_match))
    else:
        n_l = len(lt)
        out_cols = list(lk)
        for _sid, kind, c in plan_cols:
            if kind == "left":
                out_cols.append(c)
            elif kind == "overlay":
                out_cols.append(ej.lazy_gather_col(c[1], rids,
                                                   c[0], n_l))
            elif right_only_list:
                out_cols.append(ej.lazy_right_only_col(c, rids,
                                                       n_l))
            else:
                out_cols.append(ej.lazy_gather_col(c, rids, None,
                                                   n_l))
    return table(Obj(T.SYMBOL, np.asarray(out_names,
                                          dtype=np.int64)),
                 out_cols)


def ray_left_join(args: list) -> Obj:
    keys, lt, rt = _check_join_args(args)
    if len(lt) == 0 or len(rt) == 0:
        return lt
    lk = _key_cols(lt, keys)
    rk = _key_cols(rt, keys)
    fast = _try_device_join(keys, lt, rt, lk, rk, "left")
    if fast is not None:
        return fast
    rids = left_join_ids(lk, rk)
    return _merge_columns(lt, rt, keys, lk, rids)


def ray_inner_join(args: list) -> Obj:
    keys, lt, rt = _check_join_args(args)
    if len(lt) == 0 or len(rt) == 0:
        return lt
    lk = _key_cols(lt, keys)
    rk = _key_cols(rt, keys)
    fast = _try_device_join(keys, lt, rt, lk, rk, "inner")
    if fast is not None:
        return fast
    rids = left_join_ids(lk, rk)
    has = rids != T.NULL_I64
    lids = np.nonzero(has)[0].astype(np.int64)
    rsel = rids[has]
    # all columns: right value preferred (get_column join.c:67)
    lnames, _ = lt.v
    rnames, _ = rt.v
    un = ray_union(lnames, rnames)
    rest = ray_except(un, keys)
    if len(rest) == 0:
        raise err_length("no non-key columns")
    out_names = list(to_np(keys)) + list(to_np(rest))
    out_cols = [gather(c, lids) for c in _key_cols(lt, keys)]
    for sid in to_np(rest):
        nm = symbols.name_of(int(sid))
        c1 = col_by_name(lt, nm)
        c2 = col_by_name(rt, nm)
        if c2 is not None:
            if c1 is not None and _basic_type(c1) != _basic_type(c2):
                raise err_type("join column type mismatch")
            out_cols.append(gather(c2, rsel))
        else:
            out_cols.append(gather(c1, lids))
    return table(Obj(T.SYMBOL, np.asarray(out_names, dtype=np.int64)),
                 out_cols)


def asof_ids(lkeys: list, rkeys: list) -> np.ndarray:
    """Per-left-row id of the LAST right row with equal leading keys and
    right temporal <= left temporal (index_asof_join_obj, index.c:3194).
    The last element of the key lists is the temporal column; right rows
    are assumed in ascending time order per key group (as in the
    reference, which relies on insertion order)."""
    lt_time = to_np(lkeys[-1]).astype(np.int64)
    rt_time = to_np(rkeys[-1]).astype(np.int64)
    nl = len(lt_time)
    if len(lkeys) == 1:
        # pure temporal asof: searchsorted over right times
        order = np.argsort(rt_time, kind="stable")
        pos = np.searchsorted(rt_time[order], lt_time, side="right") - 1
        return np.where(pos >= 0, order[np.clip(pos, 0, None)],
                        T.NULL_I64)
    lc, rc = _joint_codes(lkeys[:-1], rkeys[:-1])
    # Vectorized last-<= probe: compact time ranks so (key, time) packs
    # into one i64, then a single searchsorted does every left row at once.
    all_times = np.concatenate([rt_time, lt_time])
    uniq_t, inv_t = np.unique(all_times, return_inverse=True)
    r_rank = inv_t[:len(rt_time)].astype(np.int64)
    l_rank = inv_t[len(rt_time):].astype(np.int64)
    span = len(uniq_t) + 1
    r_comb = rc * span + r_rank
    l_comb = lc * span + l_rank
    order = np.argsort(r_comb, kind="stable")
    r_sorted = r_comb[order]
    pos = np.searchsorted(r_sorted, l_comb, side="right") - 1
    valid = pos >= 0
    safe = np.clip(pos, 0, None)
    same_key = (r_sorted[safe] // span) == lc
    out = np.where(valid & same_key, order[safe], T.NULL_I64)
    return out.astype(np.int64)


def ray_asof_join(args: list) -> Obj:
    keys, lt, rt = _check_join_args(args)
    if len(lt) == 0 or len(rt) == 0:
        return lt
    lk = _key_cols(lt, keys)
    rk = _key_cols(rt, keys)
    fast = _try_device_join(keys, lt, rt, lk, rk, "asof")
    if fast is not None:
        return fast
    rids = asof_ids(lk, rk)
    return _merge_columns(lt, rt, keys, lk, rids)


def window_ranges(lkeys: list, rkeys_sorted: list, lo: np.ndarray,
                  hi: np.ndarray, tp: int):
    """Per-left-row [li, ri] into the xasc-sorted right table
    (index_window_join_obj + AGGR_ITER INDEX_TYPE_WINDOW, aggr.c:133-158).

    tp=0 (window-join): li = last right row with time <= lo (prevailing),
    tp=1 (window-join1): li = first right row with time >= lo;
    ri = last right row with time <= hi. Both default to the group start
    when the search finds nothing (reference indexr/indexl_bin default 0).
    A row is invalid when time[li] > hi, or for tp=1 when time[ri] < lo.
    """
    from .group import WindowIndex
    rt = to_np(rkeys_sorted[-1]).astype(np.int64)
    nl = len(to_np(lkeys[-1]))
    nr = len(rt)
    if len(lkeys) > 1:
        lc, rc = _joint_codes(lkeys[:-1], rkeys_sorted[:-1])
        # right is sorted by keys: group ranges are contiguous
        n_codes = int(max(lc.max() if nl else -1,
                          rc.max() if nr else -1)) + 1
        fi = np.searchsorted(rc, np.arange(n_codes), side="left")
        ti = np.searchsorted(rc, np.arange(n_codes), side="right") - 1
        g_fi = fi[lc]
        g_ti = ti[lc]
        has_group = g_fi <= g_ti
    else:
        g_fi = np.zeros(nl, dtype=np.int64)
        g_ti = np.full(nl, nr - 1, dtype=np.int64)
        has_group = np.full(nl, nr > 0)
    # clamp searches inside each group slice: use global searchsorted and
    # clip to the group's range (right times ascending within a group)
    sf = np.clip(g_fi, 0, max(nr - 1, 0))
    # positions within group: searchsorted over full array then clip is
    # wrong across groups, so offset searches per group via the trick of
    # restricting bounds with np.searchsorted(sorter=...) — instead use
    # composite search: times are only sorted within groups, so search
    # with group-local slices through the interleaved-bounds approach.
    li = np.empty(nl, dtype=np.int64)
    ri = np.empty(nl, dtype=np.int64)
    # composite key search: (group_code, time) is globally sorted
    if len(lkeys) > 1:
        all_t = np.concatenate([rt, lo, hi])
        _, inv_t = np.unique(all_t, return_inverse=True)
        span = inv_t.max() + 2
        r_comb = rc * span + inv_t[:nr]
        lo_comb = lc * span + inv_t[nr:nr + nl]
        hi_comb = lc * span + inv_t[nr + nl:]
        p_lo_r = np.searchsorted(r_comb, lo_comb, side="right") - 1
        p_lo_l = np.searchsorted(r_comb, lo_comb, side="left")
        p_hi_r = np.searchsorted(r_comb, hi_comb, side="right") - 1
    else:
        p_lo_r = np.searchsorted(rt, lo, side="right") - 1
        p_lo_l = np.searchsorted(rt, lo, side="left")
        p_hi_r = np.searchsorted(rt, hi, side="right") - 1
    # defaults to group start when out of range (reference bin default 0)
    li_r = np.where(p_lo_r < g_fi, g_fi, np.minimum(p_lo_r, g_ti))
    li_l = np.where((p_lo_l > g_ti) | (p_lo_l < g_fi), g_fi,
                    np.maximum(p_lo_l, g_fi))
    li = li_r if tp == 0 else li_l
    ri = np.where(p_hi_r < g_fi, g_fi, np.minimum(p_hi_r, g_ti))
    safe_li = np.clip(li, 0, max(nr - 1, 0))
    safe_ri = np.clip(ri, 0, max(nr - 1, 0))
    valid = has_group & (rt[safe_li] <= hi) if nr else \
        np.zeros(nl, dtype=bool)
    if tp == 1 and nr:
        valid &= rt[safe_ri] >= lo
    return WindowIndex(np.where(valid, li, 0),
                       np.where(valid, ri, -1), valid)


_WJ_AGGS = ("sum", "avg", "min", "max", "count", "first", "last",
            "dev")


def _try_device_window_join(interp, keys, windows, lt, rt, aggd, tp):
    """Device window join (engine/wjoin.py): event-sort boundaries +
    cumsum / sparse-table range aggregates. Falls back to the host on
    any unsupported shape."""
    from ..engine import device as dv
    if not dv.available() or not dv.should_use(len(lt) + len(rt)):
        return None
    from ..engine import wjoin as ew
    from ..core.interp import Builtin
    lk = _key_cols(lt, keys)
    rk = _key_cols(rt, keys)
    akeys, avals = aggd.v
    aggs = []
    for i, sid in enumerate(to_np(akeys)):
        ast = avals.v[i]
        if ast.t != T.LIST or len(ast.v) != 2:
            return None
        head = ast.v[0]
        nm = head.v.name if head.t in (T.UNARY, T.BINARY, T.VARY) \
            and isinstance(head.v, Builtin) else None
        if nm not in _WJ_AGGS:
            return None
        carg = ast.v[1]
        if carg.t != -T.SYMBOL or (carg.attrs & 1):
            return None
        col = col_by_name(rt, symbols.name_of(int(carg.v)))
        if col is None or col.t in (T.LIST, T.C8, T.GUID) or \
                col.t in T.UNPARTED_OF:
            return None
        aggs.append((int(sid), nm, col,
                     col.t if col.t != T.ENUM else T.ENUM))
    def _wbound(o):
        """Window bound column, device-resident when it already
        lives in HBM (e.g. built by the device arithmetic fast
        path) — the host conversion + re-upload of 10M+ rows costs
        more than the whole join."""
        p = o.pending()
        if p is not None:
            return p.arr
        m = o.meta if isinstance(o.meta, dict) else None
        if m is not None and "dev" in m:
            return m["dev"]
        return to_np(o).astype(np.int64)
    lo = _wbound(windows.v[0])
    hi = _wbound(windows.v[1])
    if len(lo) != len(lt) or len(hi) != len(lt):
        return None
    res = ew.window_join_device(lk, rk, lo, hi, aggs, tp)
    if res is None:
        return None
    out_names = list(to_np(lt.v[0])) + [s for s, _n, _c, _t
                                        in aggs]
    out_cols = list(lt.v[1]) + [res[s] for s, _n, _c, _t in aggs]
    return table(Obj(T.SYMBOL, np.asarray(out_names,
                                          dtype=np.int64)),
                 out_cols)


def ray_window_join(interp, args: list, tp: int) -> Obj:
    """(window-join [keys] windows ltab rtab aggdict) (join.c:358-489)."""
    from ..ops.sort import ray_xasc
    from ..ops.group import mapgroup
    from ..core.interp import QueryCtx, collect_lazy
    from ..ops.items import ray_value
    if len(args) != 5:
        raise err_arity("window-join needs 5 args")
    keys, windows, lt, rt, aggd = args
    if keys.t != T.SYMBOL:
        raise err_type("window-join keys must be symbols")
    if windows.t != T.LIST or len(windows.v) != 2:
        raise err_type("window-join windows must be a 2-list")
    if lt.t != T.TABLE or rt.t != T.TABLE:
        raise err_type("window-join needs tables")
    if aggd.t != T.DICT:
        raise err_type("window-join needs an aggregation dict")
    fast = _try_device_window_join(interp, keys, windows, lt, rt, aggd,
                                   tp)
    if fast is not None:
        return fast
    jtab = ray_xasc(rt, keys)
    lk = _key_cols(lt, keys)
    rk = _key_cols(jtab, keys)
    lo = to_np(windows.v[0]).astype(np.int64)
    hi = to_np(windows.v[1]).astype(np.int64)
    widx = window_ranges(lk, rk, lo, hi, tp)
    # aggregation dict evaluated with jtab columns wrapped as windowed
    # MAPGROUPs
    jnames, jcols = jtab.v
    lazy = table(jnames, [mapgroup(c, widx) for c in jcols])
    akeys, avals = aggd.v
    out_names = list(to_np(lt.v[0])) + [int(s) for s in to_np(akeys)]
    out_cols = list(lt.v[1])
    interp.qctx.append(QueryCtx(lazy))
    try:
        for ast in avals.v:
            v = interp.eval(ast)
            v = collect_lazy(v)
            if v.t == T.ENUM:
                v = ray_value(v)
            out_cols.append(v)
    finally:
        interp.qctx.pop()
    return table(Obj(T.SYMBOL, np.asarray(out_names, dtype=np.int64)),
                 out_cols)
