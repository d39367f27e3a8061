"""Sorting: iasc/idesc/asc/desc/xasc/xdesc/rank/xrank
(reference core/sort.c LSD radix of indices, core/order.c wrappers).

Ordering contract (tests/sort.c): nulls sort first ascending; f64 NaN sorts
as the smallest; symbols sort in STRING order (not id order). The host path
uses numpy stable argsort; the device path uses jax.argsort via the engine.
"""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core import symbols
from ..core.obj import Obj, to_np, list_, table
from ..core.errors import err_type
from .compose import gather


def sort_key(col: Obj) -> np.ndarray:
    t = col.t
    if t == T.LIST:
        # lists order lexicographically by element (the reference's
        # merge-sort path for strings/lists, sort.c:119-159;
        # oracle-pinned: (iasc (list "b" "a" "c")) -> [1 0 2])
        def key_of(e):
            if e.t == T.C8:
                return (0, to_np(e).tobytes())
            if e.t == -T.SYMBOL:
                return (0, symbols.name_of(int(e.v)).encode())
            if e.t < 0:
                return (1, (float(e.v),))
            return (2, tuple(np.asarray(to_np(e),
                                        dtype=np.float64).tolist()))
        ks = [key_of(e) for e in col.v]
        kinds = {k[0] for k in ks}
        if len(kinds) != 1:
            raise err_type("cannot sort mixed list")
        out = np.empty(len(ks), dtype=object)
        for i, k in enumerate(ks):
            out[i] = k[1]
        return out
    if t in T.UNPARTED_OF:
        # parted column: raze partitions before keying (the reference
        # type-errors on sorting PARTED vectors; we order the razed
        # rows instead — a strict superset)
        from .parted import parted_raze
        return sort_key(parted_raze(col))
    a = to_np(col)
    if t == T.F64:
        return np.where(np.isnan(a), -np.inf, a)
    if t == T.SYMBOL:
        return np.asarray([symbols.name_of(int(x))
                           if int(x) != int(T.NULL_I64) else ""
                           for x in a])
    if t == T.ENUM:
        from .items import ray_value
        return sort_key(ray_value(col))
    if t == T.GUID:
        return np.asarray([a[i].tobytes() for i in range(len(a))])
    return a


def ray_iasc(o: Obj) -> Obj:
    if o.t < 0:
        raise err_type("iasc of atom")
    k = sort_key(o)
    return Obj(T.I64, np.argsort(k, kind="stable").astype(np.int64))


def ray_idesc(o: Obj) -> Obj:
    if o.t < 0:
        raise err_type("idesc of atom")
    k = sort_key(o)
    # stable descending: reverse of stable ascending over reversed input
    n = len(k)
    rev = np.argsort(k[::-1], kind="stable")
    return Obj(T.I64, (n - 1 - rev)[::-1].copy().astype(np.int64))


def ray_asc(o: Obj) -> Obj:
    idx = to_np(ray_iasc(o))
    out = gather(o, idx)
    out.attrs |= 2  # ATTR_ASC
    return out


def ray_desc(o: Obj) -> Obj:
    idx = to_np(ray_idesc(o))
    out = gather(o, idx)
    out.attrs |= 4  # ATTR_DESC
    return out


def ray_rank(o: Obj) -> Obj:
    idx = to_np(ray_iasc(o))
    out = np.empty(len(idx), dtype=np.int64)
    out[idx] = np.arange(len(idx), dtype=np.int64)
    return Obj(T.I64, out)


def _table_order(tbl: Obj, by: Obj, desc: bool) -> np.ndarray:
    from ..core.obj import col_by_name
    if by.t == -T.SYMBOL:
        names = [symbols.name_of(int(by.v))]
    elif by.t == T.SYMBOL:
        names = [symbols.name_of(int(s)) for s in to_np(by)]
    else:
        raise err_type("sort keys must be symbols")
    keys = []
    for nm in names:
        c = col_by_name(tbl, nm)
        if c is None:
            raise err_type(f"no column {nm}")
        keys.append(sort_key(c))
    # lexsort: last key is primary
    order = np.lexsort(tuple(reversed(keys)))
    if desc:
        order = order[::-1].copy()
    return order.astype(np.int64)


def _try_device_xsort(tbl: Obj, by: Obj, desc: bool):
    from ..engine import device as dv
    if not dv.available() or not dv.should_use(len(tbl)):
        return None
    from ..core.obj import col_by_name
    from ..engine.sort import xsort_device
    if by.t == -T.SYMBOL:
        names = [symbols.name_of(int(by.v))]
    elif by.t == T.SYMBOL:
        names = [symbols.name_of(int(s)) for s in to_np(by)]
    else:
        return None
    key_cols = []
    for nm in names:
        c = col_by_name(tbl, nm)
        if c is None:
            return None
        key_cols.append(c)
    return xsort_device(tbl, key_cols, desc)


def ray_xasc(tbl: Obj, by: Obj) -> Obj:
    """(xasc table 'col) / (xasc table [cols]) (order.c:246)."""
    if tbl.t != T.TABLE:
        raise err_type("xasc needs a table")
    fast = _try_device_xsort(tbl, by, False)
    if fast is not None:
        return fast
    order = _table_order(tbl, by, False)
    names, cols = tbl.v
    return table(names, [gather(c, order) for c in cols])


def ray_xdesc(tbl: Obj, by: Obj) -> Obj:
    if tbl.t != T.TABLE:
        raise err_type("xdesc needs a table")
    fast = _try_device_xsort(tbl, by, True)
    if fast is not None:
        return fast
    order = _table_order(tbl, by, True)
    names, cols = tbl.v
    return table(names, [gather(c, order) for c in cols])


def ray_xrank(o: Obj, n: Obj) -> Obj:
    """(xrank data n): n equal-frequency buckets by rank (order.c:598)."""
    if n.t >= 0 or -n.t not in (T.I16, T.I32, T.I64, T.U8):
        raise err_type("xrank bucket count must be an integer atom")
    buckets = int(n.v)
    r = to_np(ray_rank(o))
    ln = len(r)
    return Obj(T.I64, (r * buckets // max(ln, 1)).astype(np.int64))
