"""The device engine's start-up: when it turns on, where its compile
cache lives, that its errors reach the caller, the mesh it builds, the
exactness of its matmul segment sums, and the comparison helpers of
chip_smoke.py."""
import importlib
import os
import sys

import numpy as np
import pytest

import jax

from rayforce_tpu import Runtime
from rayforce_tpu.core import symbols, types as T
from rayforce_tpu.core.obj import Obj, table, vec_sym
from rayforce_tpu.engine import device as dev
from rayforce_tpu.engine import groupby as G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.fixture
def device_cfg():
    """Restore the engine switches a test changes."""
    saved = dict(dev._cfg)
    yield dev._cfg
    dev._cfg.clear()
    dev._cfg.update(saved)


@pytest.fixture
def forced(device_cfg):
    dev.set_enabled(True)
    dev.set_threshold(1)


@pytest.mark.parametrize("backend,forced_env,expect", [
    ("gpu", None, True),
    ("cpu", None, False),
    ("cpu", "1", True),
])
def test_available_by_backend(monkeypatch, device_cfg, backend,
                              forced_env, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if forced_env is None:
        monkeypatch.delenv("RAYFORCE_DEVICE", raising=False)
    else:
        monkeypatch.setenv("RAYFORCE_DEVICE", forced_env)
    dev.set_enabled(None)
    assert dev.available() is expect


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_compile_cache_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    calls = _record_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert dev.configure_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls


def test_compile_cache_fixed_dir_in_checkout(monkeypatch):
    calls = _record_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = dev.configure_compile_cache()
    second = dev.configure_compile_cache()
    assert first == second == os.path.join(REPO, ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == first


def _boom(*_a, **_k):
    raise RuntimeError("injected device failure")


@pytest.mark.parametrize("target,query", [
    ("rayforce_tpu.engine.groupby.bcast_scan",
     "(select {s: (sum v) from: t by: k})"),
    ("rayforce_tpu.engine.join.match_ids_device",
     "(inner-join [k] t t)"),
    ("rayforce_tpu.engine.sort.table_order_device", "(xasc t [k])"),
    ("rayforce_tpu.engine.wjoin.window_join_device",
     "(window-join1 [k ts] (map-left + [-5 5] (at t 'ts)) t t "
     "{m: (max v)})"),
])
def test_device_error_propagates(monkeypatch, forced, target, query):
    """An error inside a device kernel reaches the caller instead of
    being answered by the host kernels."""
    rt = Runtime()
    n = 1000
    rng = np.random.default_rng(3)
    t = table(vec_sym(["k", "ts", "v"]),
              [Obj(T.I64, rng.integers(0, 10, n).astype(np.int64)),
               Obj(T.I64, np.arange(n, dtype=np.int64)),
               Obj(T.F64, rng.uniform(0, 1, n))])
    rt.interp.globals[symbols.intern("t")] = t
    mod, fn = target.rsplit(".", 1)
    monkeypatch.setattr(importlib.import_module(mod), fn, _boom)
    from rayforce_tpu.engine import select
    select._plan_cache.clear()
    with pytest.raises(Exception, match="injected device failure"):
        rt.eval_str(query)


def test_mesh_larger_than_devices_raises(monkeypatch):
    saved = dict(dev._mesh_state)
    monkeypatch.setenv("RAYFORCE_MESH", str(len(jax.devices()) + 1))
    dev._mesh_state.update({"mesh": None, "checked": False})
    try:
        with pytest.raises(RuntimeError, match="devices"):
            dev.mesh()
    finally:
        dev._mesh_state.clear()
        dev._mesh_state.update(saved)


def test_matmul_tasks_scan_matches_bincount_exactly():
    """8-bit limb weights over several full 65536-row chunks: every
    chunk partial stays below 2^24, so the f32 matmul sums are exact."""
    rng = np.random.default_rng(11)
    n_cells, n_rows = 700, 3 * G.L_CHUNK + 123
    codes = rng.integers(0, n_cells, n_rows).astype(np.int32)
    limbs = [rng.integers(0, 256, n_rows).astype(np.float32)
             for _ in range(3)]
    got = G.matmul_tasks_scan(jax.numpy.asarray(codes),
                              [jax.numpy.asarray(w) for w in limbs],
                              n_cells, n_rows)
    for w, g in zip(limbs, got):
        want = np.bincount(codes, weights=w.astype(np.float64),
                           minlength=n_cells)
        assert np.array_equal(np.asarray(g), want)


def _smoke_runtime(rows=200_000):
    rt = Runtime()
    rng = np.random.default_rng(5)
    chip_smoke.bind(rt, "t", chip_smoke.make_g1(rng, rows))
    chip_smoke.bind(rt, "r", chip_smoke.make_right(rng, rows // 10))
    return rt


@pytest.mark.parametrize("name", ["q1", "q3", "inner-join"])
def test_smoke_check_query_small(forced, name):
    """chip_smoke's device-vs-host check on the device forced onto the
    CPU, at a small size."""
    rt = _smoke_runtime()
    _n, query, module, engines, tolerant = next(
        q for q in chip_smoke.QUERIES if q[0] == name)
    got = chip_smoke.check_query(rt, name, query, module, engines,
                                 tolerant, chip_smoke.CompileClock())
    assert len(got) >= 2


def test_smoke_compare_flags_differences():
    a = [("k", T.I64, np.array([1, 2, 3])),
         ("s", T.F64, np.array([1.0, 2.0, np.nan]))]
    b = [("k", T.I64, np.array([1, 2, 3])),
         ("s", T.F64, np.array([1.0, 2.0 * (1 + 1e-12), np.nan]))]
    assert chip_smoke.compare(a, b, tolerant=("s",)) < 2e-12
    with pytest.raises(AssertionError, match="column s"):
        chip_smoke.compare(a, b)
    c = [("k", T.I64, np.array([1, 3, 2])), a[1]]
    with pytest.raises(AssertionError, match="column k"):
        chip_smoke.compare(c, a)


def test_smoke_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU found"):
        chip_smoke.main([])


@pytest.mark.chip
def test_engine_on_by_default_on_gpu(gpu, device_cfg):
    """On a GPU backend the engine turns itself on, and a grouped
    select runs on it and agrees with the host kernels."""
    dev.set_enabled(None)
    assert dev.available()
    rt = _smoke_runtime(rows=1 << 18)
    _n, query, module, engines, tolerant = chip_smoke.QUERIES[0]
    chip_smoke.check_query(rt, "q1", query, module, engines, tolerant,
                           chip_smoke.CompileClock())
