"""Device engine: device-resident column cache + per-table stats.

The compute kernels live in engine/groupby.py (group-by building
blocks) and engine/select.py (the fused query pipeline). This module
owns:

- the per-column device cache (columns are uploaded once and reused
  by every later query);
- cached column min/max stats, fetched in ONE batched transfer per
  table;
- config knobs (row threshold for the device path, dense code-space
  cap — the analogue of the reference's perfect-hash range guard,
  core/index.c:2308-2424).
"""
from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR
# itself; otherwise the cache lives at one fixed path inside the
# checkout, so every later process on the same tree hits it.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not d:
        d = CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return d


configure_compile_cache()

from ..core import types as T
from ..core.obj import Obj, to_np

# -- configuration ----------------------------------------------------------

# Both limits are correctness-neutral: every shape they route runs on
# an engine with the same semantics. Their values have not been
# re-derived for the GPU yet.
_cfg = {
    "enabled": None,       # auto-detect
    "threshold": 1 << 17,  # rows below this stay on the host numpy path
    "dense_max": 1 << 20,  # max dense group-code space (H*W <= ~1M)
}


def available() -> bool:
    """The device engine runs on a GPU backend. RAYFORCE_DEVICE=1
    forces it on any backend (the CPU tests run the device kernels
    that way)."""
    if _cfg["enabled"] is None:
        _cfg["enabled"] = jax.default_backend() == "gpu" or \
            os.environ.get("RAYFORCE_DEVICE", "") == "1"
    return bool(_cfg["enabled"])


def set_enabled(flag) -> None:
    _cfg["enabled"] = flag


def set_threshold(n: int) -> None:
    _cfg["threshold"] = n


def should_use(n_rows: int) -> bool:
    return available() and n_rows >= _cfg["threshold"]


_mesh_state = {"mesh": None, "checked": False}


def _maybe_init_distributed():
    """Multi-process runtime init, env-gated: each process sets
    RAYFORCE_COORDINATOR=host:port, RAYFORCE_NUM_PROCS and
    RAYFORCE_PROC_ID, and jax.distributed.initialize makes
    jax.devices() span every process, so RAYFORCE_MESH=auto builds a
    global mesh. Single-process runs skip it entirely."""
    coord = os.environ.get("RAYFORCE_COORDINATOR")
    if not coord or _mesh_state.get("dist_init"):
        return
    _mesh_state["dist_init"] = True
    import jax as _jax
    kw = {"coordinator_address": coord}
    if os.environ.get("RAYFORCE_NUM_PROCS"):
        kw["num_processes"] = int(os.environ["RAYFORCE_NUM_PROCS"])
    if os.environ.get("RAYFORCE_PROC_ID"):
        kw["process_id"] = int(os.environ["RAYFORCE_PROC_ID"])
    _jax.distributed.initialize(**kw)


def mesh():
    """The global device mesh when multi-device mode is active
    (RAYFORCE_MESH=N or 'auto'), else None. Selects over row-sharded
    columns then run as SPMD shard_map pipelines with collective
    combines. Raises when RAYFORCE_MESH asks for more devices than
    exist."""
    if not _mesh_state["checked"]:
        spec = os.environ.get("RAYFORCE_MESH")
        if spec:
            _maybe_init_distributed()
            n = len(jax.devices()) if spec == "auto" else int(spec)
            if n > 1:
                from ..parallel.dist import make_mesh
                _mesh_state["mesh"] = make_mesh(n)
        _mesh_state["checked"] = True
    return _mesh_state["mesh"]


def dev_col_sharded(col: Obj, m):
    """Row-sharded device copy (padded to the mesh size; the select
    pipeline masks pad rows via global row ids)."""
    if isinstance(col.meta, dict) and "dev_sh" in col.meta:
        return col.meta["dev_sh"]
    from jax.sharding import NamedSharding, PartitionSpec as P
    a = to_np(col)
    n = m.shape[m.axis_names[0]]
    pad = (-len(a)) % n
    if pad:
        a = np.concatenate([a, np.zeros(pad, dtype=a.dtype)])
    arr = jax.device_put(a, NamedSharding(m, P(m.axis_names[0])))
    if not isinstance(col.meta, dict):
        col.meta = {}
    col.meta["dev_sh"] = arr
    return arr


# -- column device cache ----------------------------------------------------

_STATLESS = (T.GUID, T.C8, T.LIST)


def dev_col(col: Obj):
    """Device copy of a column's payload, cached on the Obj. A column
    whose payload is still device-resident (DevPending) is used as-is."""
    if isinstance(col.meta, dict) and "dev" in col.meta:
        return col.meta["dev"]
    p = col.pending()
    arr = p.arr if p is not None else jnp.asarray(to_np(col))
    if not isinstance(col.meta, dict):
        col.meta = {}
    col.meta["dev"] = arr
    return arr


# decimal fixed-point scales probed by the column-stats kernel: an f64
# column whose finite values all sit on one of these grids (and fit
# i32 when scaled) can ride group-by sorts as an EXACT i32 operand,
# half the sorted bytes of an f64 one. The tolerance absorbs the
# rounding of the scaling multiply; accepted off-grid error is
# <= tol/scale per element, orders below the engine's f64
# accumulation budget.
QSCALES = (1.0, 1e2, 1e4, 1e6)


@jax.jit
def _k_minmax_all(cols):
    """Per column: (min, max, has_null, qscale) skipping nulls/NaNs.
    has_null lets query plans drop per-group null-count work; qscale
    (f64 cols only; 0 = none) is the smallest decimal grid the values
    provably sit on, enabling i32 sort operands."""
    outs = []
    for a in cols:
        if a.dtype == jnp.float64:
            nulls = jnp.isnan(a)
            lo = jnp.where(nulls, jnp.float64(np.inf), a).min()
            hi = jnp.where(nulls, jnp.float64(-np.inf), a).max()
            qscale = jnp.float64(0.0)
            for s in reversed(QSCALES):
                vs = a * jnp.float64(s)
                rv = jnp.round(vs)
                err = jnp.abs(vs - rv)
                tol = 1e-7 + jnp.abs(vs) * 1e-13
                ok = jnp.where(
                    nulls, True,
                    (err <= tol) & (jnp.abs(rv) <= (1 << 31) - 2)
                ).all()
                qscale = jnp.where(ok, jnp.float64(s), qscale)
            outs.append(jnp.stack(
                [lo, hi, nulls.any().astype(jnp.float64), qscale]))
            continue
        nv = None
        if a.dtype == jnp.int64:
            nv = np.int64(T.NULL_I64)
        elif a.dtype == jnp.int32:
            nv = np.int32(T.NULL_I32)
        elif a.dtype == jnp.int16:
            nv = np.int16(T.NULL_I16)
        x = a.astype(jnp.int64)
        if nv is not None:
            nulls = a == nv
            lo = jnp.where(nulls, jnp.int64(0x7FFFFFFFFFFFFFFF),
                           x).min()
            hi = jnp.where(nulls, jnp.int64(-0x8000000000000000),
                           x).max()
            anyn = nulls.any().astype(jnp.int64)
        else:
            lo = x.min()
            hi = x.max()
            anyn = jnp.int64(0)
        outs.append(jnp.stack([lo, hi, anyn, jnp.int64(0)]))
    return outs


def put_table(tbl: Obj) -> None:
    """Pre-stage all columns of a table on the device and batch-compute
    column min/max stats (null/NaN-skipping) with a single transfer."""
    _, cols = tbl.v
    statless = []
    arrs = []
    for c in cols:
        if c.t == T.LIST or c.t < 0 or c.t in T.UNPARTED_OF:
            continue
        a = dev_col(c)
        if c.t not in _STATLESS and not (
                isinstance(c.meta, dict) and "range" in c.meta):
            statless.append(c)
            arrs.append(a)
    if arrs:
        mm = jax.device_get(_k_minmax_all(arrs))
        for c, lh in zip(statless, mm):
            _cache_stats(c, lh)


def _cache_stats(c, lh):
    if c.t == T.F64:
        c.meta["range"] = (float(lh[0]), float(lh[1]))
        c.meta["qscale"] = float(lh[3]) or None
    else:
        c.meta["range"] = (int(lh[0]), int(lh[1]))
    c.meta["has_null"] = bool(lh[2])


def _ensure_stats(col: Obj):
    if not (isinstance(col.meta, dict) and "range" in col.meta):
        lh = jax.device_get(_k_minmax_all([dev_col(col)]))[0]
        if not isinstance(col.meta, dict):
            col.meta = {}
        _cache_stats(col, lh)


def column_range(col: Obj):
    """(min, max) of a column ignoring nulls/NaNs, cached. Integer
    ranges are exact; f64 ranges are the device's values."""
    _ensure_stats(col)
    return col.meta["range"]


def column_has_null(col: Obj) -> bool:
    _ensure_stats(col)
    return col.meta["has_null"]


def column_qscale(col: Obj):
    """Decimal fixed-point scale S (1/100/1e4/1e6) such that every
    finite value of this F64 column is (within the stats kernel's
    tolerance) an integer multiple of 1/S with |v*S| < 2^31 — or None.
    Lets sort engines ride the column as an exact i32 operand."""
    if col.t != T.F64:
        return None
    _ensure_stats(col)
    return col.meta.get("qscale")
