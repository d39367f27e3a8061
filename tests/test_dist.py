"""Distributed (multi-chip) kernels on a virtual 8-device CPU mesh.

The reference has no distributed tests (SURVEY §4); this is the
single-process multi-device simulation story the device build adds:
shard_map SPMD kernels validated against numpy ground truth.
"""
import os
import sys

import numpy as np
import pytest

# must run in a subprocess-isolated jax config: force 8 CPU devices
# before any backend use


@pytest.fixture(scope="module")
def mesh8():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    try:
        jax.config.update("jax_num_cpu_devices", 8)
    except Exception:
        pass
    if len(jax.devices()) < 8:
        pytest.skip("cannot create 8 virtual devices "
                    "(backend already initialized)")
    from rayforce_tpu.parallel import dist
    return dist.make_mesh(8)


def test_dist_groupby_sum(mesh8):
    from rayforce_tpu.parallel import dist
    rng = np.random.default_rng(0)
    n_codes = 37
    n = 8 * 512
    codes = rng.integers(0, n_codes, n).astype(np.int32)
    vals = rng.uniform(0, 10, n).astype(np.float32)
    cd, _ = dist.shard_rows(mesh8, codes)
    vd, _ = dist.shard_rows(mesh8, vals)
    f = dist.dist_groupby_sum(mesh8, n_codes)
    got = np.asarray(f(cd, vd))[:n_codes]
    ref = np.zeros(n_codes)
    np.add.at(ref, codes, vals.astype(np.float64))
    assert np.allclose(got, ref, rtol=1e-5)


def test_dist_select_small(mesh8):
    from rayforce_tpu.parallel import dist
    import jax.numpy as jnp
    from rayforce_tpu.engine import groupby as G
    rng = np.random.default_rng(1)
    n_codes = 20
    per = 1024
    n = 8 * per
    codes = rng.integers(0, n_codes, n).astype(np.int32)
    mask = rng.random(n) > 0.3
    codes_m = np.where(mask, codes, n_codes).astype(np.int32)
    vals = rng.uniform(-5, 5, n)
    ints = rng.integers(0, 200, n).astype(np.int64)

    cd, _ = dist.shard_rows(mesh8, codes_m)
    sd, _ = dist.shard_rows(mesh8, vals)
    mind, _ = dist.shard_rows(mesh8, np.where(mask, ints,
                                              G.KEY_MAX))
    maxd, _ = dist.shard_rows(mesh8, np.where(mask, ints,
                                              G.I64_MIN))
    taskd, _ = dist.shard_rows(mesh8, ints.astype(np.float32))

    f = dist.dist_select_small(mesh8, n_codes, per, n_sums=1,
                               n_mins=1, n_maxs=1, n_int_tasks=1)
    out = f(cd, taskd, sd, mind, maxd)
    out = {k: np.asarray(v) for k, v in out.items()}

    keep = mask
    ref_cnt = np.bincount(codes[keep], minlength=n_codes)
    assert np.array_equal(out["counts"].astype(np.int64), ref_cnt)

    ref_sum = np.zeros(n_codes)
    np.add.at(ref_sum, codes[keep], vals[keep])
    assert np.allclose(out["sum0"], ref_sum, atol=1e-9)

    ref_isum = np.zeros(n_codes)
    np.add.at(ref_isum, codes[keep], ints[keep].astype(np.float64))
    assert np.allclose(out["task0"], ref_isum)

    ref_min = np.full(n_codes, G.KEY_MAX)
    np.minimum.at(ref_min, codes[keep], ints[keep])
    assert np.array_equal(out["min0"], ref_min)
    ref_max = np.full(n_codes, G.I64_MIN)
    np.maximum.at(ref_max, codes[keep], ints[keep])
    assert np.array_equal(out["max0"], ref_max)

    # first-appearance index per group (global row ids)
    ref_fidx = np.full(n_codes, G.KEY_MAX, dtype=np.int64)
    idx = np.arange(n)
    for g in range(n_codes):
        rows = idx[(codes == g) & keep]
        if len(rows):
            ref_fidx[g] = rows[0]
    assert np.array_equal(out["fidx"], ref_fidx)


def test_dist_shuffle_routing(mesh8):
    from rayforce_tpu.parallel import dist
    rng = np.random.default_rng(2)
    n = 8 * 256
    keys = rng.integers(0, 5000, n).astype(np.int64)
    vals = rng.integers(0, 100, n).astype(np.int64)
    kd, _ = dist.shard_rows(mesh8, keys)
    vd, _ = dist.shard_rows(mesh8, vals)
    f = dist.dist_shuffle(mesh8, capacity=512)
    rk, rv, valid, ovf = f(kd, vd)
    assert int(np.asarray(ovf)[0]) == 0
    rk = np.asarray(rk).reshape(8, -1)
    valid = np.asarray(valid).reshape(8, -1)
    for d in range(8):
        got = rk[d][valid[d]]
        assert (got % 8 == d).all()
    assert int(valid.sum()) == n

    # tight capacity -> overflow REPORTED (not silently dropped), and
    # the auto wrapper retries until everything routes
    f2 = dist.dist_shuffle(mesh8, capacity=8)
    _rk, _rv, v2, ovf2 = f2(kd, vd)
    dropped = int(np.asarray(ovf2)[0])
    assert dropped > 0
    assert int(np.asarray(v2).sum()) + dropped == n
    rk3, _rv3, v3 = dist.dist_shuffle_auto(mesh8, 8)(kd, vd)
    assert int(np.asarray(v3).sum()) == n


def test_spmd_select_parity(mesh8):
    """End-to-end mesh-mode select (RAYFORCE_MESH): the interpreter's
    device path runs the fused pipeline under shard_map with collective
    combines, matching the host kernels exactly."""
    import numpy as np
    from rayforce_tpu import Runtime
    from rayforce_tpu.engine import device as dev, select as sel
    from rayforce_tpu.core.obj import Obj, table, vec_sym
    from rayforce_tpu.core import types as T, symbols
    from rayforce_tpu.core.fmt import format_top as fmt

    old_state = dict(dev._mesh_state)
    old_thresh = dev._cfg["threshold"]
    os.environ["RAYFORCE_MESH"] = "8"
    dev._mesh_state.update({"mesh": None, "checked": False})
    dev.set_threshold(1)
    dev.set_enabled(True)
    try:
        assert dev.mesh() is not None
        rng = np.random.default_rng(4)
        N = 5003   # deliberately not divisible by 8
        v1 = rng.integers(-3, 6, N).astype(np.int64)
        v1[rng.integers(0, N, 40)] = T.NULL_I64
        t = table(vec_sym(["id1", "v1", "v3"]),
                  [Obj(T.I64, rng.integers(0, 9, N).astype(np.int64)),
                   Obj(T.I64, v1),
                   Obj(T.F64, rng.uniform(-50, 100, N))])
        rt = Runtime()
        rt.interp.globals[symbols.intern("t")] = t
        n_spmd0 = sum(1 for p, _s in sel._plan_cache.values()
                      if p != "unsupported" and getattr(p, "spmd", 0))
        for q in [
            "(select {s: (sum v1) c: (count v1) from: t by: id1})",
            "(select {a: (avg v3) mx: (max v3) mn: (min v1) from: t "
            "by: id1 where: (> v3 0)})",
        ]:
            s_dev = fmt(rt.eval_str(q))
            dev.set_enabled(False)
            s_host = fmt(rt.eval_str(q))
            dev.set_enabled(True)
            assert s_dev == s_host, q
        n_spmd = sum(1 for p, _s in sel._plan_cache.values()
                     if p != "unsupported" and getattr(p, "spmd", 0))
        assert n_spmd > n_spmd0, "distributed plans were not used"
    finally:
        os.environ.pop("RAYFORCE_MESH", None)
        dev._mesh_state.update(old_state)
        dev._cfg["threshold"] = old_thresh


def test_dist_wide_groupby(mesh8):
    """q7-shaped distributed group-by: partial-aggregate exchange via
    all_to_all, zero-drop by construction, first-appearance order."""
    from rayforce_tpu.parallel import dist
    rng = np.random.default_rng(3)
    per = 1024
    n = 8 * per
    codes = rng.integers(0, 3000, n).astype(np.int64)
    codes[rng.random(n) < 0.1] = -1        # masked (filtered) rows
    vals = rng.uniform(0, 10, n)
    cd, _ = dist.shard_rows(mesh8, codes)
    vd, _ = dist.shard_rows(mesh8, vals)
    run = dist.dist_wide_groupby_auto(mesh8, per)
    ng, code, cnt, fidx, s = run(cd, vd)
    ng = int(np.asarray(ng)[0])
    code = np.asarray(code)[:ng]
    s = np.asarray(s)[:ng]
    cnt = np.asarray(cnt)[:ng]

    # numpy ground truth in first-appearance order
    keep = codes >= 0
    seen = {}
    for i, c in enumerate(codes):
        if c >= 0 and c not in seen:
            seen[c] = i
    ref_codes = sorted(seen, key=lambda c: seen[c])
    assert ng == len(ref_codes)
    assert np.array_equal(code, np.asarray(ref_codes))
    ref_sum = {c: 0.0 for c in seen}
    ref_cnt = {c: 0 for c in seen}
    for c, v in zip(codes[keep], vals[keep]):
        ref_sum[c] += v
        ref_cnt[c] += 1
    assert np.allclose(s, [ref_sum[c] for c in ref_codes], atol=1e-9)
    assert np.array_equal(cnt, [ref_cnt[c] for c in ref_codes])


def test_dist_wide_groupby_skewed(mesh8):
    """One heavy-hitter key owning 60% of rows: the pre-aggregation
    combiner keeps the exchange balanced (<= 1 partial per chip per
    group) and results exact."""
    from rayforce_tpu.parallel import dist
    rng = np.random.default_rng(4)
    per = 512
    n = 8 * per
    codes = rng.integers(0, 500, n).astype(np.int64)
    codes[rng.random(n) < 0.6] = 137       # heavy hitter
    vals = rng.uniform(0, 1, n)
    cd, _ = dist.shard_rows(mesh8, codes)
    vd, _ = dist.shard_rows(mesh8, vals)
    run = dist.dist_wide_groupby_auto(mesh8, per)
    ng, code, cnt, fidx, s = run(cd, vd)
    ng = int(np.asarray(ng)[0])
    code = np.asarray(code)[:ng]
    cnt = np.asarray(cnt)[:ng]
    hh = np.nonzero(code == 137)[0]
    assert len(hh) == 1
    assert cnt[hh[0]] == int((codes == 137).sum())
    s_hh = float(np.asarray(s)[hh[0]])
    assert abs(s_hh - vals[codes == 137].sum()) < 1e-9


def test_dist_wide_groupby_lanes(mesh8):
    """Multi-lane exchange: sum, min, and max combiners over two value
    columns in one kernel (the decomposable AGGR_COLLECT merges)."""
    from rayforce_tpu.parallel import dist
    rng = np.random.default_rng(7)
    per = 512
    n = 8 * per
    codes = rng.integers(0, 900, n).astype(np.int64)
    codes[rng.random(n) < 0.15] = -1
    va = rng.uniform(-50, 50, n)
    vb = rng.uniform(0, 1000, n)
    cd, _ = dist.shard_rows(mesh8, codes)
    vad, _ = dist.shard_rows(mesh8, va)
    vbd, _ = dist.shard_rows(mesh8, vb)
    run = dist.dist_wide_groupby_auto(
        mesh8, per, lane_ops=("sum", "min", "max", "first", "last"))
    ng, code, cnt, fidx, s, mn, mx, fv, lv = run(
        cd, vad, vad, vbd, vbd, vbd)
    ng = int(np.asarray(ng)[0])
    code = np.asarray(code)[:ng]
    s = np.asarray(s)[:ng]
    mn = np.asarray(mn)[:ng]
    mx = np.asarray(mx)[:ng]
    fv = np.asarray(fv)[:ng]
    lv = np.asarray(lv)[:ng]
    keep = codes >= 0
    for i, c in enumerate(code):
        sel = np.nonzero(keep & (codes == c))[0]
        assert abs(s[i] - va[sel].sum()) < 1e-8, c
        assert mn[i] == va[sel].min(), c
        assert mx[i] == vb[sel].max(), c
        assert fv[i] == vb[sel[0]], c
        assert lv[i] == vb[sel[-1]], c


def test_dist_left_probe(mesh8):
    from rayforce_tpu.parallel import dist
    rng = np.random.default_rng(5)
    n = 8 * 512
    nr = 700
    lk = rng.integers(0, 1000, n).astype(np.int64)
    rk = rng.permutation(2000)[:nr].astype(np.int64)  # unique keys
    import jax
    ld, _ = dist.shard_rows(mesh8, lk)
    rd = jax.device_put(rk)
    f = dist.dist_left_probe(mesh8)
    rid, has = f(ld, rd)
    rid = np.asarray(rid)
    has = np.asarray(has)
    pos = {k: i for i, k in enumerate(rk)}
    for i in range(n):
        if lk[i] in pos:
            assert has[i] and rid[i] == pos[lk[i]], i
        else:
            assert not has[i], i


def test_dist_asof_probe(mesh8):
    from rayforce_tpu.parallel import dist
    rng = np.random.default_rng(6)
    per = 256
    n = 8 * per
    nr = 8 * 384
    lk = rng.integers(0, 40, n).astype(np.int64)
    lt = rng.integers(0, 1_000_000, n).astype(np.int64)
    rk = rng.integers(0, 40, nr).astype(np.int64)
    rt_ = rng.integers(0, 1_000_000, nr).astype(np.int64)
    rv = rng.uniform(0, 100, nr)
    ld, _ = dist.shard_rows(mesh8, lk)
    ltd, _ = dist.shard_rows(mesh8, lt)
    rd, _ = dist.shard_rows(mesh8, rk)
    rtd, _ = dist.shard_rows(mesh8, rt_)
    rvd, _ = dist.shard_rows(mesh8, rv)
    f = dist.dist_asof_probe(mesh8)
    val, has = f(ld, ltd, rd, rtd, rvd)
    val = np.asarray(val)[:n]
    has = np.asarray(has)[:n]

    # numpy ground truth: last right row with same key and ts <= lt
    order = np.lexsort((rt_, rk))
    rks, rts, rvs = rk[order], rt_[order], rv[order]
    for i in range(0, n, 37):
        m = (rks == lk[i]) & (rts <= lt[i])
        if m.any():
            j = np.nonzero(m)[0][-1]
            assert has[i], i
            assert abs(val[i] - rvs[j]) < 1e-12, i
        else:
            assert not has[i], i


def test_mesh_wide_select_parity(mesh8):
    """End-to-end mesh-mode HIGH-CARDINALITY grouped select through the
    interpreter: the dist-group (all_to_all exchange) engine must match
    the host kernels exactly, including first-appearance order."""
    from rayforce_tpu import Runtime
    from rayforce_tpu.engine import device as dev, select as sel
    from rayforce_tpu.core.obj import Obj, table, vec_sym
    from rayforce_tpu.core import types as T, symbols
    from rayforce_tpu.core.fmt import format_top as fmt

    old_state = dict(dev._mesh_state)
    old_thresh = dev._cfg["threshold"]
    os.environ["RAYFORCE_MESH"] = "8"
    dev._mesh_state.update({"mesh": None, "checked": False})
    dev.set_threshold(1)
    dev.set_enabled(True)
    try:
        assert dev.mesh() is not None
        rng = np.random.default_rng(12)
        n = 8 * 1000 + 5
        k1 = rng.integers(0, 900, n).astype(np.int64)
        k2 = rng.integers(0, 50, n).astype(np.int64)
        v = rng.uniform(0, 10, n)
        w = rng.integers(0, 100, n).astype(np.int64)
        # nullable columns: f64 with NaNs, i64 with sentinel nulls —
        # dense enough that some groups are ALL-null
        nf = rng.uniform(0, 10, n)
        nf[rng.random(n) < 0.5] = np.nan
        ni = rng.integers(-20, 20, n).astype(np.int64)
        ni[rng.random(n) < 0.5] = T.NULL_I64
        rt = Runtime()
        rt.interp.globals[symbols.intern("t")] = table(
            vec_sym(["k1", "k2", "v", "w", "nf", "ni"]),
            [Obj(T.I64, k1), Obj(T.I64, k2), Obj(T.F64, v),
             Obj(T.I64, w), Obj(T.F64, nf), Obj(T.I64, ni)])
        for q in [
            "(select {s: (sum v) c: (count v) from: t "
            "by: {k1: k1 k2: k2}})",
            "(select {a: (avg v) from: t by: {k1: k1 k2: k2} "
            "where: (> w 30)})",
            "(select {s: (sum w) from: t by: k1})",
            # multi-lane: min/max combiners + two distinct columns
            "(select {mx: (max v) mn: (min w) s: (sum v) from: t "
            "by: k1})",
            "(select {mn: (min v) mx: (max v) c: (count v) from: t "
            "by: {k1: k1 k2: k2} where: (< w 70)})",
            # nullable lanes: null-propagating plain sums, null-
            # skipping avg/min/max, all-null groups (typed INF min /
            # typed NULL max / NaN avg)
            "(select {s: (sum nf) a: (avg nf) mn: (min nf) "
            "mx: (max nf) c: (count nf) from: t by: k1})",
            "(select {s: (sum ni) a: (avg ni) mn: (min ni) "
            "mx: (max ni) from: t by: {k1: k1 k2: k2}})",
            # positional first/last lanes (incl. null values riding
            # through the f64 exchange exactly)
            "(select {f: (first v) l: (last w) fi: (first ni) "
            "ln: (last nf) from: t by: k1})",
            # dev via globally-shifted sum moments (incl. nullable
            # and int columns)
            "(select {d: (dev v) a: (avg v) from: t by: k1})",
            "(select {d: (dev nf) di: (dev w) from: t by: k1})",
            # beyond the single-chip dense ceiling (4.5M-code space):
            # the exchange distributes what used to go to wide.py
            "(select {s: (sum v) c: (count v) from: t "
            "by: {a: k1 b: k2 c2: w}})",
            # med rides the raw-row shuffle kernel next to partial-
            # exchange lanes (nullable + int columns included)
            "(select {m: (med v) s: (sum v) from: t by: k1})",
            "(select {m: (med nf) mi: (med w) c: (count v) from: t "
            "by: {k1: k1 k2: k2}})",
            # DERIVED f64 expressions: per-group whole-vector null
            # semantics (sum SKIPS nulls, min all-null -> typed NULL);
            # first/last of derived exprs are an ERROR in the
            # reference (length) so they never reach the device plans
            "(select {s: (sum (* v nf)) mn: (min (+ nf v)) "
            "mx: (max (* nf 2.0)) from: t by: k1})",
            "(select {a: (avg (- v nf)) m: (med (+ v nf)) "
            "from: t by: {k1: k1 k2: k2}})",
            # INT-typed derived exprs: interval arithmetic
            # (exprc.expr_range) proves f64-lane exactness; nullable
            # int input ni gives whole-vector null semantics
            "(select {s: (sum (+ w ni)) mn: (min (* ni 3)) "
            "a: (avg (- w ni)) from: t by: k1})",
        ]:
            dev.set_enabled(True)
            s_dev = fmt(rt.eval_str(q))
            eng = sel.last_profile.get("engine")
            dev.set_enabled(False)
            s_host = fmt(rt.eval_str(q))
            dev.set_enabled(True)
            assert s_dev == s_host, q
            assert eng == "dist-group", (q, eng)
    finally:
        os.environ.pop("RAYFORCE_MESH", None)
        dev._mesh_state.clear()
        dev._mesh_state.update(old_state)
        dev._cfg["threshold"] = old_thresh


def test_mesh_join_parity(mesh8):
    """End-to-end mesh-mode left/inner join through the interpreter:
    the broadcast-build probe fans over the chips and must match the
    host join exactly."""
    from rayforce_tpu import Runtime
    from rayforce_tpu.engine import device as dev
    from rayforce_tpu.core.obj import Obj, table, vec_sym
    from rayforce_tpu.core import types as T, symbols
    from rayforce_tpu.core.fmt import format_top as fmt

    old_state = dict(dev._mesh_state)
    old_thresh = dev._cfg["threshold"]
    os.environ["RAYFORCE_MESH"] = "8"
    dev._mesh_state.update({"mesh": None, "checked": False})
    dev.set_threshold(1)
    dev.set_enabled(True)
    try:
        assert dev.mesh() is not None
        rng = np.random.default_rng(31)
        n = 8 * 600 + 3
        lk = rng.integers(0, 400, n).astype(np.int64)
        lv = rng.uniform(0, 10, n)
        rk = rng.permutation(800)[:300].astype(np.int64)
        rw = rng.integers(0, 1000, 300).astype(np.int64)
        rt = Runtime()
        rt.interp.globals[symbols.intern("l")] = table(
            vec_sym(["k", "v"]), [Obj(T.I64, lk), Obj(T.F64, lv)])
        rt.interp.globals[symbols.intern("r")] = table(
            vec_sym(["k", "w"]), [Obj(T.I64, rk), Obj(T.I64, rw)])
        for q in ["(left-join [k] l r)", "(inner-join [k] l r)"]:
            dev.set_enabled(True)
            s_dev = fmt(rt.eval_str(q))
            dev.set_enabled(False)
            s_host = fmt(rt.eval_str(q))
            dev.set_enabled(True)
            assert s_dev == s_host, q
    finally:
        os.environ.pop("RAYFORCE_MESH", None)
        dev._mesh_state.clear()
        dev._mesh_state.update(old_state)
        dev._cfg["threshold"] = old_thresh


def test_mesh_asof_join_parity(mesh8):
    """End-to-end mesh-mode asof join through the interpreter: both
    sides hash-partition by key over the chips; results match the
    host kernel exactly."""
    from rayforce_tpu import Runtime
    from rayforce_tpu.engine import device as dev
    from rayforce_tpu.core.obj import Obj, table, vec_sym
    from rayforce_tpu.core import types as T, symbols
    from rayforce_tpu.core.fmt import format_top as fmt

    old_state = dict(dev._mesh_state)
    old_thresh = dev._cfg["threshold"]
    os.environ["RAYFORCE_MESH"] = "8"
    dev._mesh_state.update({"mesh": None, "checked": False})
    dev.set_threshold(1)
    dev.set_enabled(True)
    try:
        assert dev.mesh() is not None
        rng = np.random.default_rng(41)
        nl, nr = 8 * 400 + 5, 8 * 700 + 3
        rt = Runtime()
        rt.interp.globals[symbols.intern("tr")] = table(
            vec_sym(["s", "ts", "q"]),
            [Obj(T.I64, rng.integers(0, 50, nl).astype(np.int64)),
             Obj(T.I64, np.sort(rng.integers(0, 1 << 20, nl))
                 .astype(np.int64)),
             Obj(T.I64, rng.integers(1, 10, nl).astype(np.int64))])
        rt.interp.globals[symbols.intern("qt")] = table(
            vec_sym(["s", "ts", "px"]),
            [Obj(T.I64, rng.integers(0, 50, nr).astype(np.int64)),
             Obj(T.I64, np.sort(rng.integers(0, 1 << 20, nr))
                 .astype(np.int64)),
             Obj(T.F64, rng.uniform(1, 100, nr))])
        q = "(asof-join [s ts] tr qt)"
        s_dev = fmt(rt.eval_str(q))
        dev.set_enabled(False)
        s_host = fmt(rt.eval_str(q))
        dev.set_enabled(True)
        assert s_dev == s_host
    finally:
        os.environ.pop("RAYFORCE_MESH", None)
        dev._mesh_state.clear()
        dev._mesh_state.update(old_state)
        dev._cfg["threshold"] = old_thresh


@pytest.mark.parametrize("seed", range(3))
def test_mesh_select_fuzz(mesh8, seed):
    """Randomized mesh-vs-host select parity: the same generated
    table/query space as test_device_fuzz, but with RAYFORCE_MESH
    active — every query either runs on a distributed engine
    (spmd-small or dist-group) or falls back, and must match the host
    kernels exactly either way."""
    import random
    from test_device_fuzz import _mk_table, _mk_query
    from rayforce_tpu import Runtime
    from rayforce_tpu.engine import device as dev
    from rayforce_tpu.core import symbols
    from rayforce_tpu.core.fmt import format_top as fmt

    old_state = dict(dev._mesh_state)
    old_thresh = dev._cfg["threshold"]
    os.environ["RAYFORCE_MESH"] = "8"
    dev._mesh_state.update({"mesh": None, "checked": False})
    dev.set_threshold(1)
    dev.set_enabled(True)
    try:
        assert dev.mesh() is not None
        rng = np.random.default_rng(500 + seed)
        rnd = random.Random(500 + seed)
        rt = Runtime()
        rt.interp.globals[symbols.intern("t")] = _mk_table(
            rng, rnd.choice([1013, 4001]))
        for _ in range(6):
            q = _mk_query(rnd)
            dev.set_enabled(True)
            s_dev = fmt(rt.eval_str(q))
            dev.set_enabled(False)
            s_host = fmt(rt.eval_str(q))
            dev.set_enabled(True)
            assert s_dev == s_host, q
    finally:
        os.environ.pop("RAYFORCE_MESH", None)
        dev._mesh_state.clear()
        dev._mesh_state.update(old_state)
        dev._cfg["threshold"] = old_thresh


def test_dist_med_groupby(mesh8):
    """Distributed median: raw-row shuffle (groups land complete per
    chip) + local sorted selection; NaN nulls skipped; tight capacity
    exercises the doubling retry."""
    from rayforce_tpu.parallel import dist
    rng = np.random.default_rng(21)
    per = 512
    n = 8 * per
    codes = rng.integers(0, 300, n).astype(np.int64)
    codes[rng.random(n) < 0.1] = -1
    va = rng.uniform(-100, 100, n)
    va[rng.random(n) < 0.2] = np.nan
    vb = rng.uniform(0, 50, n)
    cd, _ = dist.shard_rows(mesh8, codes)
    vad, _ = dist.shard_rows(mesh8, va)
    vbd, _ = dist.shard_rows(mesh8, vb)
    run = dist.dist_med_groupby_auto(mesh8, per, 2)
    ng, code, fidx, ma, mb = run(cd, vad, vbd)
    ng = int(np.asarray(ng)[0])
    code = np.asarray(code)[:ng]
    ma = np.asarray(ma)[:ng]
    mb = np.asarray(mb)[:ng]
    keep = codes >= 0
    # first-appearance order
    seen = {}
    for i, c in enumerate(codes):
        if c >= 0 and c not in seen:
            seen[c] = i
    ref_codes = sorted(seen, key=lambda c: seen[c])
    assert ng == len(ref_codes)
    assert np.array_equal(code, np.asarray(ref_codes))
    for i, c in enumerate(code):
        sel = keep & (codes == c)
        a_vals = np.sort(va[sel][~np.isnan(va[sel])])
        if len(a_vals) == 0:
            assert np.isnan(ma[i]), c
        else:
            e = len(a_vals)
            ref = (a_vals[(e - 1) // 2] + a_vals[e // 2]) / 2.0
            assert ma[i] == ref, c
        b_vals = np.sort(vb[sel])
        e = len(b_vals)
        ref = (b_vals[(e - 1) // 2] + b_vals[e // 2]) / 2.0
        assert mb[i] == ref, c


def test_dist_med_groupby_skewed(mesh8):
    """99:1 skewed median (the aj.rfl shape): heavy keys never ride
    the raw-row exchange — their medians come from the distributed
    rank selection — so the kernel succeeds at the INITIAL capacity
    (ovf lanes 0: exchange stays O(rows/n_dev) under any skew) and is
    still exact, nulls included."""
    from rayforce_tpu.parallel import dist
    rng = np.random.default_rng(33)
    per = 512
    n = 8 * per
    n_dev = 8
    # ~99% of rows on 2 heavy keys, remainder over 400 light keys
    codes = rng.integers(0, 400, n).astype(np.int64)
    hot = rng.random(n) < 0.99
    codes[hot] = np.where(rng.random(hot.sum()) < 0.7, 137, 22)
    codes[rng.random(n) < 0.02] = -1
    va = rng.uniform(-1000, 1000, n)
    va[rng.random(n) < 0.15] = np.nan
    vb = rng.standard_normal(n) * 1e6
    cd, _ = dist.shard_rows(mesh8, codes)
    vad, _ = dist.shard_rows(mesh8, va)
    vbd, _ = dist.shard_rows(mesh8, vb)
    cap = max(2 * per // n_dev, 64)       # the auto wrapper's initial
    run = dist.dist_med_groupby(mesh8, per, cap, cap, 2)
    out = run(cd, vad, vbd)
    assert int(np.asarray(out[1])[0]) == 0   # no exchange ballooning
    assert int(np.asarray(out[2])[0]) == 0
    ng = int(np.asarray(out[0])[0])
    code = np.asarray(out[3])[:ng]
    ma = np.asarray(out[5])[:ng]
    mb = np.asarray(out[6])[:ng]
    keep = codes >= 0
    seen = {}
    for i, c in enumerate(codes):
        if c >= 0 and c not in seen:
            seen[c] = i
    ref_codes = sorted(seen, key=lambda c: seen[c])
    assert ng == len(ref_codes)
    assert np.array_equal(code, np.asarray(ref_codes))
    for i, c in enumerate(code):
        sel = keep & (codes == c)
        for vals, got in ((va, ma[i]), (vb, mb[i])):
            v = np.sort(vals[sel][~np.isnan(vals[sel])])
            if len(v) == 0:
                assert np.isnan(got), c
            else:
                e = len(v)
                assert got == (v[(e - 1) // 2] + v[e // 2]) / 2.0, c


# first 4 seeds of the deep sweep run in the DEFAULT suite (the
# exchange/merge paths are where rare-input bugs live); the rest stay
# opt-in behind RAYFORCE_FUZZ_EXTENDED
@pytest.mark.parametrize(
    "seed",
    range(700, 716) if os.environ.get("RAYFORCE_FUZZ_EXTENDED")
    else range(700, 704))
def test_mesh_select_fuzz_extended(mesh8, seed):
    """16-seed deep mesh sweep (opt-in): same generator as the default
    mesh fuzzer, more seeds and more queries per table."""
    import random
    from test_device_fuzz import _mk_table, _mk_query
    from rayforce_tpu import Runtime
    from rayforce_tpu.engine import device as dev
    from rayforce_tpu.core import symbols
    from rayforce_tpu.core.fmt import format_top as fmt

    old_state = dict(dev._mesh_state)
    old_thresh = dev._cfg["threshold"]
    os.environ["RAYFORCE_MESH"] = "8"
    dev._mesh_state.update({"mesh": None, "checked": False})
    dev.set_threshold(1)
    dev.set_enabled(True)
    try:
        assert dev.mesh() is not None
        rng = np.random.default_rng(seed)
        rnd = random.Random(seed)
        rt = Runtime()
        rt.interp.globals[symbols.intern("t")] = _mk_table(
            rng, rnd.choice([1013, 4001, 9001]))
        for _ in range(10):
            q = _mk_query(rnd)
            dev.set_enabled(True)
            s_dev = fmt(rt.eval_str(q))
            dev.set_enabled(False)
            s_host = fmt(rt.eval_str(q))
            dev.set_enabled(True)
            assert s_dev == s_host, q
    finally:
        os.environ.pop("RAYFORCE_MESH", None)
        dev._mesh_state.clear()
        dev._mesh_state.update(old_state)
        dev._cfg["threshold"] = old_thresh


from contextlib import contextmanager


@contextmanager
def mesh_env():
    """Interpreter-level mesh mode: RAYFORCE_MESH=8 + device threshold
    1, restored on exit (the setup every end-to-end parity test above
    repeats inline)."""
    from rayforce_tpu.engine import device as dev
    old_state = dict(dev._mesh_state)
    old_thresh = dev._cfg["threshold"]
    os.environ["RAYFORCE_MESH"] = "8"
    dev._mesh_state.update({"mesh": None, "checked": False})
    dev.set_threshold(1)
    dev.set_enabled(True)
    try:
        assert dev.mesh() is not None
        yield dev
    finally:
        os.environ.pop("RAYFORCE_MESH", None)
        dev._mesh_state.clear()
        dev._mesh_state.update(old_state)
        dev._cfg["threshold"] = old_thresh


def test_dist_sort(mesh8):
    """Sample-sort kernel vs numpy lexsort: multi-key with duplicates,
    stability via the row-id tie-break, tight capacity exercising the
    overflow retry."""
    from rayforce_tpu.parallel import dist
    rng = np.random.default_rng(77)
    n = 8 * 700 + 0
    k1 = rng.integers(0, 9, n).astype(np.int64)     # heavy duplicates
    k2 = rng.uniform(-5, 5, n)
    cd, _ = dist.shard_rows(mesh8, k1)
    vd, _ = dist.shard_rows(mesh8, k2)
    run = dist.dist_sort_auto(mesh8, n, (np.int64, np.float64))
    order = np.asarray(run(cd, vd))
    ref = np.lexsort((np.arange(n), k2, k1))
    assert np.array_equal(order, ref)


def test_mesh_sort_parity(mesh8):
    """End-to-end mesh-mode xasc/xdesc through the interpreter: the
    distributed sample sort must match the host sort exactly,
    including null/NaN placement and multi-key stability."""
    from rayforce_tpu import Runtime
    from rayforce_tpu.core.obj import Obj, table, vec_sym
    from rayforce_tpu.core import types as T, symbols
    from rayforce_tpu.core.fmt import format_top as fmt

    with mesh_env() as dev:
        rng = np.random.default_rng(55)
        n = 8 * 900 + 5
        k1 = rng.integers(0, 12, n).astype(np.int64)
        k1[rng.integers(0, n, 60)] = T.NULL_I64
        k2 = rng.integers(-4, 4, n).astype(np.int32)
        v = rng.uniform(-50, 50, n)
        v[rng.integers(0, n, 60)] = np.nan
        ts = rng.integers(0, 10**6, n).astype(np.int64)
        sym = np.asarray([symbols.intern(s) for s in
                          rng.choice(["ibm", "aapl", "msft", "goog"],
                                     n)], dtype=np.int64)
        rt = Runtime()
        rt.interp.globals[symbols.intern("t")] = table(
            vec_sym(["k1", "k2", "v", "ts", "s"]),
            [Obj(T.I64, k1), Obj(T.I32, k2), Obj(T.F64, v),
             Obj(T.I64, ts), Obj(T.SYMBOL, sym)])
        from rayforce_tpu.engine import sort as esort
        for q in ["(xasc t [k1])", "(xasc t [k1 k2])",
                  "(xdesc t [k2 v])", "(xasc t [v])",
                  "(xasc t [s ts])", "(xdesc t [k1 ts v])"]:
            dev.set_enabled(True)
            s_dev = fmt(rt.eval_str(q))
            eng = esort.last_profile.get("engine")
            dev.set_enabled(False)
            s_host = fmt(rt.eval_str(q))
            dev.set_enabled(True)
            assert s_dev == s_host, q
            assert eng == "dist-sort", (q, eng)


def test_mesh_window_join_parity(mesh8):
    """End-to-end mesh-mode window-join/window-join1 through the
    interpreter: both tables exchange by key ownership, each chip runs
    the event-sort window kernel on its partition, and every aggregate
    kind must match the host path exactly (incl. nulls, empty and
    prevailing windows)."""
    from rayforce_tpu import Runtime
    from rayforce_tpu.engine import wjoin as ew
    from rayforce_tpu.core.obj import Obj, table, vec_sym
    from rayforce_tpu.core import types as T, symbols
    from rayforce_tpu.core.fmt import format_top as fmt

    with mesh_env() as dev:
        rng = np.random.default_rng(91)
        nl, nr = 8 * 300 + 5, 8 * 500 + 3
        lk = rng.integers(0, 23, nl).astype(np.int64)
        lts = np.sort(rng.integers(0, 50_000, nl)).astype(np.int64)
        rk = rng.integers(0, 23, nr).astype(np.int64)
        rts = np.sort(rng.integers(0, 50_000, nr)).astype(np.int64)
        p = rng.uniform(-100, 100, nr)
        p[rng.integers(0, nr, nr // 25)] = np.nan
        q_ = rng.integers(-50, 50, nr).astype(np.int64)
        q_[rng.integers(0, nr, nr // 25)] = T.NULL_I64
        rt = Runtime()
        rt.interp.globals[symbols.intern("tr")] = table(
            vec_sym(["s", "ts"]), [Obj(T.I64, lk), Obj(T.I64, lts)])
        rt.interp.globals[symbols.intern("qt")] = table(
            vec_sym(["s", "ts", "p", "q"]),
            [Obj(T.I64, rk), Obj(T.I64, rts), Obj(T.F64, p),
             Obj(T.I64, q_)])
        for fn, w in [("window-join", (-1000, 1000)),
                      ("window-join", (-5000, 0)),
                      ("window-join1", (-1000, 1000)),
                      ("window-join1", (0, 0))]:
            for aggs in ["{mx: (max p) mn: (min p) c: (count p)}",
                         "{s: (sum q) a: (avg p) d: (dev p)}",
                         "{f: (first p) l: (last q) mq: (max q)}"]:
                q = (f"({fn} [s ts] (map-left + [{w[0]} {w[1]}] "
                     f"(at tr 'ts)) tr qt {aggs})")
                dev.set_enabled(True)
                s_dev = fmt(rt.eval_str(q))
                eng = ew.last_profile.get("engine")
                dev.set_enabled(False)
                s_host = fmt(rt.eval_str(q))
                dev.set_enabled(True)
                assert s_dev == s_host, (fn, w, aggs)
                assert eng == "dist-wjoin", (fn, w, aggs, eng)


def test_mesh_partitioned_join_parity(mesh8):
    """Partitioned-build distributed left/inner join: right side ~ left
    size, bcast_max forced to 0 so the probe takes the both-sides
    hash-partition path (dist_eq_probe) instead of broadcasting the
    build side; results must match the host joins exactly."""
    from rayforce_tpu import Runtime
    from rayforce_tpu.core.obj import Obj, table, vec_sym
    from rayforce_tpu.core import types as T, symbols
    from rayforce_tpu.core.fmt import format_top as fmt

    with mesh_env() as dev:
        old = dev._cfg.get("bcast_max")
        dev._cfg["bcast_max"] = 0
        try:
            rng = np.random.default_rng(131)
            nl = 8 * 600 + 3
            nr = 8 * 550 + 1
            lk = rng.integers(0, 2000, nl).astype(np.int64)
            rk = rng.permutation(4000)[:nr].astype(np.int64)
            rt = Runtime()
            rt.interp.globals[symbols.intern("l")] = table(
                vec_sym(["k", "v"]),
                [Obj(T.I64, lk), Obj(T.F64, rng.uniform(0, 10, nl))])
            rt.interp.globals[symbols.intern("r")] = table(
                vec_sym(["k", "w"]),
                [Obj(T.I64, rk),
                 Obj(T.I64, rng.integers(0, 1000, nr)
                     .astype(np.int64))])
            for q in ["(left-join [k] l r)", "(inner-join [k] l r)"]:
                dev.set_enabled(True)
                s_dev = fmt(rt.eval_str(q))
                dev.set_enabled(False)
                s_host = fmt(rt.eval_str(q))
                dev.set_enabled(True)
                assert s_dev == s_host, q
        finally:
            if old is None:
                dev._cfg.pop("bcast_max", None)
            else:
                dev._cfg["bcast_max"] = old


def test_dist_eq_probe_dup_keys(mesh8):
    """dist_eq_probe first-match semantics with duplicate right keys:
    the matched id must be the smallest ORIGINAL right row id."""
    from rayforce_tpu.parallel import dist
    rng = np.random.default_rng(17)
    n = 8 * 200
    lk = rng.integers(0, 60, n).astype(np.int64)
    rk = rng.integers(0, 90, n).astype(np.int64)   # many duplicates
    ld, _ = dist.shard_rows(mesh8, lk)
    rd, _ = dist.shard_rows(mesh8, rk)
    f = dist.dist_eq_probe(mesh8, n, 64, 64)
    ovf_l, ovf_r, ovf_b, rid, has = f(ld, rd)
    assert int(np.asarray(ovf_l)[0]) == 0
    assert int(np.asarray(ovf_r)[0]) == 0
    assert int(np.asarray(ovf_b)[0]) == 0
    rid = np.asarray(rid)[:n]
    has = np.asarray(has)[:n]
    first = {}
    for i, k in enumerate(rk):
        first.setdefault(int(k), i)
    for i in range(n):
        if int(lk[i]) in first:
            assert has[i] and rid[i] == first[int(lk[i])], i
        else:
            assert not has[i], i


@pytest.mark.parametrize("seed", range(4))
def test_mesh_join_fuzz(mesh8, seed):
    """Randomized mesh-vs-host parity for JOINS, multi-key SORTS and
    WINDOW JOINS under RAYFORCE_MESH: random tables with duplicate
    right keys, null keys and null payloads drive the ring asof probe,
    the eq/broadcast probes, the sample sort and the wjoin exchange —
    the rare-input exchange/merge paths — on every default suite run
    (round-2 verdict asked for exactly this promotion)."""
    import random
    from test_join_fuzz import _mk_tables, QUERIES
    from rayforce_tpu import Runtime
    from rayforce_tpu.core.obj import Obj, table, vec_sym
    from rayforce_tpu.core import types as T
    from rayforce_tpu.core import symbols
    from rayforce_tpu.core.fmt import format_top as fmt

    with mesh_env() as dev:
        rng = np.random.default_rng(3100 + seed)
        rnd = random.Random(3100 + seed)
        nl = rnd.choice([8 * 150 + 3, 8 * 320 + 1])
        nr = rnd.choice([8 * 100 + 5, 8 * 260 + 7])
        lt, rt_ = _mk_tables(rng, nl, nr, with_nulls=bool(seed % 2))
        rt = Runtime()
        rt.interp.globals[symbols.intern("l")] = lt
        rt.interp.globals[symbols.intern("r")] = rt_
        qs = list(QUERIES) + ["(xasc l [k1 ts])",
                              "(xdesc r [k2 rv])"]
        # window-join tables need time-sorted rows on both sides
        wk = rng.integers(0, 15, nl).astype(np.int64)
        wts = np.sort(rng.integers(0, 50_000, nl)).astype(np.int64)
        qk = rng.integers(0, 15, nr).astype(np.int64)
        qts = np.sort(rng.integers(0, 50_000, nr)).astype(np.int64)
        p = rng.uniform(-100, 100, nr)
        p[rng.integers(0, nr, max(nr // 25, 1))] = np.nan
        rt.interp.globals[symbols.intern("tr")] = table(
            vec_sym(["s", "ts"]), [Obj(T.I64, wk), Obj(T.I64, wts)])
        rt.interp.globals[symbols.intern("qt")] = table(
            vec_sym(["s", "ts", "p"]),
            [Obj(T.I64, qk), Obj(T.I64, qts), Obj(T.F64, p)])
        w = rnd.choice([(-1000, 1000), (-5000, 0), (0, 0)])
        for fn, aggs in [("window-join",
                          "{mx: (max p) s: (sum p) a: (avg p)}"),
                         ("window-join1",
                          "{mn: (min p) c: (count p) d: (dev p)}")]:
            qs.append(f"({fn} [s ts] (map-left + [{w[0]} {w[1]}] "
                      f"(at tr 'ts)) tr qt {aggs})")
        for q in qs:
            dev.set_enabled(True)
            s_dev = fmt(rt.eval_str(q))
            dev.set_enabled(False)
            s_host = fmt(rt.eval_str(q))
            dev.set_enabled(True)
            assert s_dev == s_host, (seed, q)


def test_dist_eq_probe_skew_no_capacity_blowup(mesh8):
    """99:1 hot key on the partitioned-build path: heavy keys resolve
    via the candidate lanes WITHOUT being routed, so the exchange
    succeeds at O(rows/n_dev) capacity — no doubling retries
    (VERDICT r03 item 5; the reference handles this with per-key HT
    chains, core/index.c:2886)."""
    from rayforce_tpu.parallel import dist
    rng = np.random.default_rng(23)
    n = 8 * 512
    # 99% of left rows carry key 7; without skew routing they would
    # all land on chip 7 % 8 and overflow any O(rows/n_dev) bucket
    lk = np.where(rng.random(n) < 0.99, 7,
                  rng.integers(0, 500, n)).astype(np.int64)
    rk = rng.permutation(500)[:300].astype(np.int64)
    nr = 8 * ((len(rk) + 7) // 8)
    rk = np.concatenate([rk, np.full(nr - len(rk), -1,
                                     dtype=np.int64)])
    ld, _ = dist.shard_rows(mesh8, lk)
    rd, _ = dist.shard_rows(mesh8, rk)
    cap = max(2 * (n // 8) // 8, 64)      # the balanced O(rows/n_dev)
    f = dist.dist_eq_probe(mesh8, n, cap, cap, cap_b=cap * 4)
    ovf_l, ovf_r, ovf_b, rid, has = f(ld, rd)
    assert int(np.asarray(ovf_l)[0]) == 0, "hot key was routed"
    assert int(np.asarray(ovf_r)[0]) == 0
    rid = np.asarray(rid)[:n]
    has = np.asarray(has)[:n]
    first = {int(k): i for i, k in reversed(list(enumerate(rk)))
             if k >= 0}
    for i in range(n):
        if int(lk[i]) in first:
            assert has[i] and rid[i] == first[int(lk[i])], i
        else:
            assert not has[i], i
