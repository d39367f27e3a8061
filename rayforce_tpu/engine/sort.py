"""Device table sort (xasc/xdesc) over device-resident columns.

One multi-key stable lax.sort with an iota payload produces the row
order; every output column is a lazy device take (DevPending), so a
10M-row sort copies nothing to the host. Key semantics mirror the host
(ops/sort.py sort_key): integer/temporal keys compare raw (typed nulls
are the most-negative value and sort first, tests/sort.c:50-60), f64
maps NaN to -inf, symbol/enum keys compare in STRING order via a
host-computed rank table (the reference merge-sorts symbols by string,
core/sort.c:119-159).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import types as T
from ..core import symbols
from ..core.obj import Obj, to_np, enum_domain
from . import device as dev
from .join import lazy_take_col, _DEV_COL_OK_SORT

_order_cache: dict = {}


def _sym_rank_key(ids_dev, id_space_np):
    """Device key = string rank of each symbol id. id_space_np: the
    distinct ids to rank (host); unseen ids can't occur."""
    names = [symbols.name_of(int(i)) if int(i) != int(T.NULL_I64)
             else "" for i in id_space_np]
    order = np.argsort(np.asarray(names), kind="stable")
    hi = int(id_space_np.max()) if len(id_space_np) else 0
    rank_of_id = np.zeros(hi + 2, dtype=np.int64)
    rank_of_id[id_space_np[order]] = np.arange(len(order))
    lut = jnp.asarray(rank_of_id)
    safe = jnp.clip(ids_dev, 0, hi + 1)
    key = lut[safe]
    return jnp.where(ids_dev == np.int64(T.NULL_I64), jnp.int64(-1),
                     key)


def _key_array(col: Obj):
    """Device sort key for one column, or None when unsupported."""
    t = col.t
    if t == T.F64:
        a = dev.dev_col(col)
        return jnp.where(jnp.isnan(a), jnp.float64(-np.inf), a)
    if t == T.SYMBOL:
        a = dev.dev_col(col)
        ids = np.unique(to_np(col))
        ids = ids[ids != T.NULL_I64]
        return _sym_rank_key(a, ids)
    if t == T.ENUM:
        codes = dev.dev_col(col)
        dom = to_np(enum_domain(col))
        names = [symbols.name_of(int(i)) for i in dom]
        order = np.argsort(np.asarray(names), kind="stable")
        rank = np.empty(max(len(dom), 1), dtype=np.int64)
        rank[order] = np.arange(len(order))
        lut = jnp.asarray(rank)
        safe = jnp.clip(codes, 0, max(len(dom) - 1, 0))
        key = lut[safe]
        return jnp.where(codes == np.int64(T.NULL_I64),
                         jnp.int64(-1), key)
    if t in (T.B8, T.U8, T.I16, T.I32, T.I64, T.DATE, T.TIME,
             T.TIMESTAMP):
        return dev.dev_col(col).astype(jnp.int64)
    return None


_mesh_sort_cache: dict = {}
last_profile: dict = {}    # {"engine": "dist-sort" | "device-sort"}


def _mesh_order(m, keys, n, desc):
    """Mesh-mode row order via the distributed sample sort
    (parallel/dist.py:dist_sort — per-chip sorts + splitter-routed
    all_to_all range exchange, the reference's parallel order-by
    core/order.c:246 lifted onto the mesh). Returns the replicated
    i64 permutation."""
    from ..parallel import dist
    from jax.sharding import NamedSharding, PartitionSpec as P
    axis = m.axis_names[0]
    n_dev = m.shape[axis]
    sharded = []
    for k in keys:
        pad = (-n) % n_dev
        if pad:
            k = jnp.concatenate(
                [k, jnp.zeros(pad, dtype=k.dtype)])
        sharded.append(jax.device_put(k, NamedSharding(m, P(axis))))
    sig = (id(m), n, tuple(str(k.dtype) for k in keys))
    run = _mesh_sort_cache.get(sig)
    if run is None:
        run = dist.dist_sort_auto(m, n,
                                  tuple(k.dtype for k in keys))
        _mesh_sort_cache[sig] = run
    order = run(*sharded)
    return jnp.flip(order) if desc else order


def table_order_device(key_cols: list, desc: bool):
    """Row order (device i32 array) or None when unsupported."""
    keys = []
    for c in key_cols:
        k = _key_array(c)
        if k is None:
            return None
        keys.append(k)
    n = int(keys[0].shape[0])
    nk = len(keys)
    m = dev.mesh()
    if m is not None and n > 0:
        last_profile["engine"] = "dist-sort"
        return _mesh_order(m, keys, n, desc)
    last_profile["engine"] = "device-sort"
    sig = (n, nk, tuple(str(k.dtype) for k in keys), desc)
    f = _order_cache.get(sig)
    if f is None:
        def fn(*ks):
            iota = jnp.arange(n, dtype=jnp.int32)
            out = jax.lax.sort(list(ks) + [iota], num_keys=nk,
                               is_stable=True)
            o = out[-1]
            return jnp.flip(o) if desc else o
        f = jax.jit(fn)
        _order_cache[sig] = f
    return f(*keys)


def xsort_device(tbl: Obj, key_cols: list, desc: bool):
    """Sorted table with lazy device-resident columns, or None."""
    names, cols = tbl.v
    for c in cols:
        if c.t not in _DEV_COL_OK_SORT:
            return None
    order = table_order_device(key_cols, desc)
    if order is None:
        return None
    n = len(tbl)
    from ..core.obj import table as table_
    out = [lazy_take_col(c, order, n) for c in cols]
    return table_(names, out)
