"""Test harness config.

The suite runs on the CPU with an 8-device virtual mesh unless
JAX_PLATFORMS names a platform explicitly; `JAX_PLATFORMS=cuda python
-m pytest -m chip tests/` runs the tests that need a GPU. Tests marked
`chip` take the `gpu` fixture, which skips them elsewhere."""
import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a GPU backend (skips elsewhere)")
    import jax
    if not os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX backend is {jax.default_backend()}")


def _map_count() -> int:
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except Exception:
        return 0


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules once the process
    map count gets high. Every jitted plan pins mapped code pages for
    the life of the process; across the full suite that exhausts
    vm.max_map_count (65530) and XLA dies with MemoryError/segfaults
    mid-compile (reproduced: the map count marches to ~65.4k right
    before the crash). Clearing only above a threshold keeps warm-jit
    speed for most modules; engine plan caches are cleared too so no
    stale plan holds a dropped executable."""
    yield
    if _map_count() > 30_000:
        import jax
        from rayforce_tpu.engine import select as _sel
        _sel._plan_cache.clear()
        jax.clear_caches()
