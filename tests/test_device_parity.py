"""Device-engine parity: the full device query paths (select, joins,
window joins, sorts) must produce byte-identical formatted output to
the host kernels. Runs on the CPU backend with the device engine
force-enabled — the same XLA programs the GPU executes.
"""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["RAYFORCE_DEVICE"] = "1"

from rayforce_tpu import Runtime                       # noqa: E402
from rayforce_tpu.engine import device as dev          # noqa: E402
from rayforce_tpu.core.obj import Obj, table, vec_sym  # noqa: E402
from rayforce_tpu.core import types as T, symbols      # noqa: E402
from rayforce_tpu.core.fmt import format_top as fmt    # noqa: E402


@pytest.fixture(scope="module")
def rt():
    dev.set_threshold(1)
    dev.set_enabled(True)
    rng = np.random.default_rng(42)
    N = 4000
    id1 = rng.integers(0, 7, N).astype(np.int64)
    id3 = rng.integers(0, 1200, N).astype(np.int64)
    v1 = rng.integers(-3, 6, N).astype(np.int64)
    v1[rng.integers(0, N, 40)] = T.NULL_I64
    v2 = rng.integers(0, 100, N).astype(np.int32)
    v3 = rng.uniform(-50, 100, N)
    v3[rng.integers(0, N, 40)] = np.nan
    big = rng.integers(-2**62, 2**62, N).astype(np.int64)
    t = table(vec_sym(["id1", "id3", "v1", "v2", "v3", "big"]),
              [Obj(T.I64, id1), Obj(T.I64, id3), Obj(T.I64, v1),
               Obj(T.I32, v2), Obj(T.F64, v3), Obj(T.I64, big)])
    NR = 2500
    r = table(vec_sym(["id3", "w", "ts"]),
              [Obj(T.I64, rng.integers(0, 2400, NR).astype(np.int64)),
               Obj(T.F64, rng.uniform(0, 10, NR)),
               Obj(T.I64, np.sort(rng.integers(
                   0, 1_000_000, NR)).astype(np.int64))])
    lt = table(vec_sym(["id3", "ts"]),
               [Obj(T.I64, rng.integers(0, 2400, N).astype(np.int64)),
                Obj(T.I64, np.sort(rng.integers(
                    0, 1_000_000, N)).astype(np.int64))])
    runtime = Runtime()
    g = runtime.interp.globals
    g[symbols.intern("t")] = t
    g[symbols.intern("r")] = r
    g[symbols.intern("lt")] = lt
    dev.put_table(t)
    dev.put_table(r)
    dev.put_table(lt)
    return runtime


QUERIES = [
    # dense small / large group-by, nulls, filters, multi-key
    "(select {s: (sum v1) c: (count v1) from: t by: id1})",
    "(select {a: (avg v3) s: (sum v3) from: t by: id1})",
    "(select {mx: (max v1) mn: (min v3) from: t by: id1})",
    "(select {f: (first v2) l: (last v2) from: t by: id1})",
    "(select {s: (sum big) from: t by: id3})",
    "(select {s: (sum v2) a: (avg v1) from: t by: id3 "
    "where: (> v3 0)})",
    "(select {mx: (max v3) mn: (min v1) from: t by: id3})",
    "(select {s: (sum v1) from: t by: {id1: id1 id3: id3}})",
    "(select {s: (sum v1) a: (avg v3) from: t})",
    "(select {m1: (med v2) m2: (med v3) from: t by: id1})",
    "(select {m: (med v3) s: (sum v1) from: t by: id3})",
    # joins
    "(inner-join [id3] t r)",
    "(left-join [id3] t r)",
    "(asof-join [id3 ts] lt r)",
    # window joins
    "(window-join [id3 ts] (map-left + [-5000 5000] (at lt 'ts)) "
    "lt r {mx: (max w) mn: (min w) s: (sum w) c: (count w)})",
    "(window-join1 [id3 ts] (map-left + [-5000 5000] (at lt 'ts)) "
    "lt r {a: (avg w) f: (first w) l: (last w)})",
    # sorts
    "(xasc t [id1 v2])",
    "(xdesc t 'v3)",
]


@pytest.mark.parametrize("q", QUERIES)
def test_device_matches_host(rt, q):
    dev.set_enabled(True)
    r_dev = rt.eval_str(q)
    s_dev = fmt(r_dev)
    dev.set_enabled(False)
    try:
        r_host = rt.eval_str(q)
        s_host = fmt(r_host)
    finally:
        dev.set_enabled(True)
    assert s_dev == s_host


def test_wide_engine_matches_host(rt):
    dev.set_enabled(True)
    old = dev._cfg["dense_max"]
    dev._cfg["dense_max"] = 512      # force the wide-code engine
    try:
        from rayforce_tpu.engine import select as sel
        sel._plan_cache.clear()
        q = ("(select {s: (sum v3) c: (count v1) from: t by: "
             "{id1: id1 id3: id3}})")
        s_dev = fmt(rt.eval_str(q))
        dev.set_enabled(False)
        s_host = fmt(rt.eval_str(q))
        assert s_dev == s_host
    finally:
        dev._cfg["dense_max"] = old
        dev.set_enabled(True)
