#!/usr/bin/env python3
"""Benchmark: db-benchmark-style group-by + join suite on the GPU
engine.

Group-by mirrors the reference's headline benchmark (docs group-by.md,
H2OAI G1_1e7_1e2 dataset shape): 10M rows; id1/id2 card 100, id3 card
100k (the reference's string ids are enum codes on device — integer
grouping, identical work), id4/id5 card 100, id6 card 100k, v1 in 1..5,
v2 in 1..15, v3 uniform f64. q7 groups by all six keys (~10M groups).
Joins approximate the db-benchmark join task shapes; baselines from
BASELINE.md.

Timing counts full engine execution: every query's device dispatch is
synchronous through the scalar (group-count) fetch, and result columns
are materialized on the device — the equivalent of the reference
materializing result columns in RAM. Columns are not copied to the
host.

Usage: bench.py — needs a GPU and exits non-zero without one.

bench.py --mesh N [--mesh-out FILE] — a CPU rehearsal of the
weak-scaling harness over the 5 BASELINE.md configs (filter+sum,
multi-key aggregate, join + sort order-by, asof/window joins,
skewed-key suite) on an N-device virtual CPU mesh: per-device rows held
fixed, each config measured at 1 device and N devices, with rows/s and
exchanged bytes per query (parallel/dist.py traffic model). All N
virtual devices share one socket, so the ideal N-device time is N x the
1-device time — virt_eff reports against that; its times say nothing
about a GPU.

Prints ONE JSON line: geometric-mean speedup over the reference
baselines, with the device it ran on. Per-query details go to stderr.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# NOTE on group-by timing: no extra block_until_ready is needed after
# eval. The group-by engines fetch the group-count scalar from the same
# executable that computes every output lane, so when eval_str returns
# the result columns are materialized on the device. (Joins differ:
# their column gathers are lazy thunks, so the join loop below
# explicitly forces and blocks on them.)


def snap_profile(kind):
    """Normalized {engine, exec_ms} from the engine that just ran —
    recorded per query so the artifact says WHAT was measured."""
    from rayforce_tpu.engine import join, select, wjoin
    p = {"group": select, "join": join, "wjoin": wjoin}[kind].last_profile
    out = {}
    if "engine" in p:
        out["engine"] = p["engine"]
    ex = p.get("exec_ms")
    if ex is None and "exec+fetch_ms" in p:
        ex = p.get("dispatch_ms", 0.0) + p["exec+fetch_ms"]
    if ex is not None:
        out["exec_ms"] = round(float(ex), 1)
    return out


# Noise gate: an iteration set whose max/min spread exceeds this is
# rerun (up to MAX_RERUNS times) and flagged if it still does.
SPREAD_LIMIT = 1.5
MAX_RERUNS = 2


def _anomaly(times):
    """Reason string when this iteration set can't be trusted."""
    lo, hi = min(times), max(times)
    if lo > 0 and hi / lo > SPREAD_LIMIT:
        return f"iteration spread {hi/lo:.2f}x"
    return None


def measure(name, once, baseline_ms, iters, kind, stats, results,
            speedups):
    """Warmup + best-of-iters with per-query engine/exec_ms capture;
    noisy iteration sets rerun up to MAX_RERUNS times and the artifact
    records both the rerun count and any still-standing flag. `once`
    -> wall ms (fully forced). A failing query fails the run."""
    once()                              # compile / plan warmup
    reruns = 0
    while True:
        times = [once() for _ in range(iters)]
        prof = snap_profile(kind)
        flag = _anomaly(times)
        if flag is None or reruns >= MAX_RERUNS:
            break
        reruns += 1
        log(f"{name}: anomaly ({flag}) — rerun {reruns}")
    best = min(times)
    st = {"min": round(best, 1),
          "avg": round(sum(times) / len(times), 1),
          "max": round(max(times), 1)}
    st.update(prof)
    if reruns:
        st["reruns"] = reruns
    if flag:
        st["flag"] = flag
    stats[name] = st
    results[name] = best
    if baseline_ms is not None:
        speedups.append(baseline_ms / best)
        extra = f" [{st.get('engine', '?')}" + \
            (f" exec {st['exec_ms']} ms]" if "exec_ms" in st else "]")
        log(f"{name}: {best:.1f} ms (baseline {baseline_ms} ms, "
            f"{baseline_ms/best:.2f}x){extra}"
            + (f" FLAG: {flag}" if flag else ""))
    else:
        log(f"{name}: {best:.1f} ms (detail-only, no published "
            f"baseline)")


def device_info():
    """The device the benchmark runs on; exits when it is not a GPU."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"bench: no GPU found (JAX backend is "
                         f"{backend!r}); the benchmark runs on a GPU only")
    d = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    name, limit = smi.stdout.strip().splitlines()[0].split(",")
    return {"platform": d.platform, "device_kind": d.device_kind,
            "count": len(jax.devices()), "name": name.strip(),
            "power_limit": limit.strip()}


def mesh_main(n_dev, out_path):
    import jax
    # virtual CPU mesh (must precede backend init)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", n_dev)
    from rayforce_tpu import Runtime
    from rayforce_tpu.engine import device as dev
    from rayforce_tpu.parallel import dist
    from rayforce_tpu.core.obj import Obj, table, vec_sym
    from rayforce_tpu.core import types as T, symbols

    R = int(os.environ.get("RAYFORCE_MESHBENCH_ROWS", "500000"))

    def set_mesh(n):
        if n > 1:
            os.environ["RAYFORCE_MESH"] = str(n)
        else:
            os.environ.pop("RAYFORCE_MESH", None)
        dev._mesh_state.clear()
        dev._mesh_state.update({"mesh": None, "checked": False})

    def put(rt, name, cols):
        t_ = table(vec_sym(list(cols)),
                   [Obj(T.F64 if a.dtype == np.float64 else T.I64, a)
                    for a in cols.values()])
        rt.interp.globals[symbols.intern(name)] = t_
        return t_

    def force(res):
        try:
            _, cols_ = res.v
        except Exception:
            return
        arrs = [c.pending().arr for c in cols_
                if hasattr(c, "pending") and c.pending() is not None]
        jax.block_until_ready(arrs)

    def timed(rt, queries):
        """Warm up (compiles), then best-of-2 on the whole query list;
        exchange bytes snapshot around one measured pass."""
        for q in queries:
            force(rt.eval_str(q))
        best = None
        xbytes = 0
        for _ in range(2):
            dist.reset_stats()
            t0 = time.perf_counter()
            for q in queries:
                force(rt.eval_str(q))
            ms = (time.perf_counter() - t0) * 1000
            if best is None or ms < best:
                best = ms
                xbytes = dist.stats["exchanged_bytes"]
        return best, xbytes

    def g1(rng, rows):
        return {"id1": rng.integers(0, 100, rows).astype(np.int64),
                "id2": rng.integers(0, 100, rows).astype(np.int64),
                "id3": rng.integers(0, 100_000, rows)
                .astype(np.int64),
                "v1": rng.integers(1, 6, rows).astype(np.int64),
                "v2": rng.integers(1, 16, rows).astype(np.int64),
                "v3": rng.uniform(0, 100, rows)}

    def build_fs(rt, rows, rng):
        put(rt, "t", g1(rng, rows))
        return ["(select {s: (sum v1) c: (count v1) from: t "
                "where: (> v3 50.0)})"]

    def build_agg(rt, rows, rng):
        put(rt, "t", g1(rng, rows))
        return ["(select {s1: (sum v1) a: (avg v2) from: t "
                "by: {id1: id1 id2: id2}})"]

    def build_joinsort(rt, rows, rng):
        put(rt, "t", g1(rng, rows))
        nr = rows // 2
        put(rt, "r", {"id3": rng.permutation(200_000)[:nr]
                      .astype(np.int64),
                      "w1": rng.uniform(0, 100, nr)})
        return ["(inner-join [id3] t r)", "(xasc t [id3 v1])"]

    def build_asofwj(rt, rows, rng):
        nq = 2 * rows
        put(rt, "tr", {"s": rng.integers(0, 1000, rows)
                       .astype(np.int64),
                       "ts": np.sort(rng.integers(
                           0, 1 << 28, rows)).astype(np.int64),
                       "px": rng.uniform(10, 200, rows)})
        put(rt, "qt", {"s": rng.integers(0, 1000, nq)
                       .astype(np.int64),
                       "ts": np.sort(rng.integers(
                           0, 1 << 28, nq)).astype(np.int64),
                       "p": rng.uniform(10, 200, nq)})
        return ["(asof-join [s ts] tr qt)",
                "(window-join1 [s ts] (map-left + [-100000 100000] "
                "(at tr 'ts)) tr qt {mx: (max p) mn: (min p)})"]

    def build_skew(rt, rows, rng):
        # 99:1 hot key (SURVEY Appendix B's aj.rfl shape)
        hot = rng.uniform(0, 1, rows) < 0.99
        k = np.where(hot, 7, rng.integers(0, 1000, rows))\
            .astype(np.int64)
        put(rt, "t", {"k": k, "v": rng.uniform(0, 100, rows)})
        nr = rows // 2
        rk = np.where(rng.uniform(0, 1, nr) < 0.99, 7,
                      rng.integers(0, 2000, nr)).astype(np.int64)
        put(rt, "r", {"k": rk, "w": rng.uniform(0, 100, nr)})
        return ["(inner-join [k] t r)",
                "(select {m: (med v) s: (sum v) from: t by: k})"]

    configs = [("filter_sum", build_fs),
               ("multikey_agg", build_agg),
               ("join_sort", build_joinsort),
               ("asof_window_join", build_asofwj),
               ("skewed_suite", build_skew)]

    dev.set_enabled(True)
    dev.set_threshold(1)
    report = {}
    effs = []
    for name, build in configs:
        row = {}
        for n in (1, n_dev):
            set_mesh(n)
            rows = R * n
            rt = Runtime()
            rng = np.random.default_rng(7)
            queries = build(rt, rows, rng)
            ms, xb = timed(rt, queries)
            tag = "1" if n == 1 else "N"
            row[f"ms_{tag}"] = round(ms, 1)
            row[f"rows_{tag}"] = rows
            row[f"rows_per_s_{tag}"] = round(rows / (ms / 1000))
            if n > 1:
                row["exchanged_bytes"] = xb
                row["bytes_per_row"] = round(xb / rows, 1)
        row["virt_eff"] = round(n_dev * row["ms_1"] / row["ms_N"], 3)
        effs.append(row["virt_eff"])
        report[name] = row
        log(f"{name}: 1dev {row['ms_1']} ms | {n_dev}dev "
            f"{row['ms_N']} ms | eff {effs[-1]} | "
            f"{row['bytes_per_row']} B/row exchanged")

    geo = float(np.exp(np.mean(np.log(np.maximum(effs, 1e-9)))))
    artifact = {
        "n_devices": n_dev,
        "platform": "cpu-virtual",
        "per_device_rows": R,
        "efficiency_semantics":
            "virt_eff = N*t_1dev / t_Ndev — all N virtual devices "
            "share one socket, so ideal weak scaling is t_N = N*t_1; "
            "exchanged bytes/row is the hardware-transferable signal",
        "configs": report,
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(artifact, f, indent=1)
        log(f"recorded to {out_path}")
    print(json.dumps({
        "metric": "meshbench_eff_geomean",
        "value": round(geo, 3), "unit": "x",
        "platform": "cpu-virtual",
        "detail": {k: v["virt_eff"] for k, v in report.items()},
    }))


def main():
    if "--mesh" in sys.argv:
        i = sys.argv.index("--mesh")
        n = int(sys.argv[i + 1])
        out = None
        if "--mesh-out" in sys.argv:
            out = sys.argv[sys.argv.index("--mesh-out") + 1]
        return mesh_main(n, out)
    from rayforce_tpu import Runtime
    from rayforce_tpu.engine import device as dev
    from rayforce_tpu.core.obj import Obj, table, vec_sym
    from rayforce_tpu.core import types as T, symbols

    import jax
    import jax.numpy as jnp
    from jax import random as jrandom
    from rayforce_tpu.core.obj import DevPending

    device = device_info()
    log(f"device: {device}")

    N = 10_000_000

    def dev_table(names, specs, n):
        """Generate benchmark columns ON DEVICE (no 1GB+ host upload
        in the set-up). Host copies materialize lazily if ever
        needed."""
        @jax.jit
        def gen():
            key = jrandom.PRNGKey(7)
            out = []
            for i, (kind, a, b) in enumerate(specs):
                k = jrandom.fold_in(key, i)
                if kind == "int":
                    out.append(jrandom.randint(
                        k, (n,), a, b, dtype=jnp.int64))
                elif kind == "sorted_int":
                    v = jrandom.randint(k, (n,), a, b,
                                        dtype=jnp.int64)
                    out.append(jnp.sort(v))
                else:
                    v = jrandom.uniform(k, (n,), dtype=jnp.float64,
                                        minval=a, maxval=b)
                    # v3 is round(uniform(0,100), 6) in db-benchmark
                    out.append(jnp.round(v * 1e6) / 1e6)
            return out
        arrs = gen()
        jax.block_until_ready(arrs)
        cols = []
        for (kind, _a, _b), arr in zip(specs, arrs):
            t = T.F64 if kind == "f64" else T.I64
            o = Obj(t, DevPending(arr))
            o.meta = {"dev": arr}
            cols.append(o)
        t_ = table(vec_sym(names), cols)
        dev.put_table(t_)   # batch-computes the column stats
        return t_

    rt = Runtime()
    log(f"generating {N}-row G1 table on device...")
    t0 = time.perf_counter()
    tbl = dev_table(
        ["id1", "id2", "id3", "id4", "id5", "id6",
         "v1", "v2", "v3"],
        [("int", 0, 100), ("int", 0, 100), ("int", 0, 100_000),
         ("int", 0, 100), ("int", 0, 100), ("int", 0, 100_000),
         ("int", 1, 6), ("int", 1, 16), ("f64", 0.0, 100.0)], N)
    rt.interp.globals[symbols.intern("t")] = tbl
    log(f"ready in {time.perf_counter()-t0:.1f}s")

    queries = [
        ("q1", "(select {s: (sum v1) from: t by: id1})", 60.0, 5),
        ("q2", "(select {s: (sum v1) from: t by: "
         "{id1: id1 id2: id2}})", 74.0, 5),
        ("q3", "(select {s: (sum v1) a: (avg v3) from: t by: id3})",
         118.0, 5),
        ("q4", "(select {a1: (avg v1) a2: (avg v2) a3: (avg v3) "
         "from: t by: id4})", 72.0, 5),
        ("q5", "(select {s1: (sum v1) s2: (sum v2) s3: (sum v3) "
         "from: t by: id6})", 122.0, 5),
        ("q6", "(select {mx: (max v1) mn: (min v2) from: t by: id3})",
         104.0, 5),
        ("q7", "(select {s: (sum v3) c: (count v3) from: t by: "
         "{id1: id1 id2: id2 id3: id3 id4: id4 id5: id5 id6: id6}})",
         1394.0, 3),
    ]

    speedups = []
    results = {}
    stats = {}
    for name, q, baseline_ms, iters in queries:
        def gb_once(q=q):
            t0 = time.perf_counter()
            rt.eval_str(q)
            return (time.perf_counter() - t0) * 1000
        measure(name, gb_once, baseline_ms, iters, "group",
                stats, results, speedups)

    # ---- joins: 10M-row x joined with a 1M-row table on an int key ----
    NR = 1_000_000
    rng = np.random.default_rng(7)
    rid = rng.permutation(NR * 2)[:NR].astype(np.int64)  # half match
    rv = rng.uniform(0, 100, NR)
    rtbl = table(vec_sym(["id3", "w1"]),
                 [Obj(T.I64, rid), Obj(T.F64, rv)])
    rt.interp.globals[symbols.intern("r")] = rtbl
    dev.put_table(rtbl)

    def run_join(name, q, baseline_ms, iters=3, kind="join"):
        def once():
            t0 = time.perf_counter()
            res = rt.eval_str(q)
            _, cols_ = res.v
            devarrs = []
            for c in cols_:
                p = c.pending() if hasattr(c, "pending") else None
                if p is not None:
                    devarrs.append(p.arr)   # force the gather
            import jax as _j
            _j.block_until_ready(devarrs)
            return (time.perf_counter() - t0) * 1000
        measure(name, once, baseline_ms, iters, kind,
                stats, results, speedups)

    run_join("ij", "(inner-join [id3] t r)", 1610.0)
    run_join("lj", "(left-join [id3] t r)", 3149.0)

    # ---- window join: 10M trades x 20M quotes, +/-1000 time window ----
    NT, NQ = 10_000_000, 20_000_000
    trades = dev_table(["sym", "ts"],
                       [("int", 0, 18_000),
                        ("sorted_int", 0, 2_000_000_000)], NT)
    quotes = dev_table(["sym", "ts", "p"],
                       [("int", 0, 18_000),
                        ("sorted_int", 0, 2_000_000_000),
                        ("f64", 10.0, 200.0)], NQ)
    rt.interp.globals[symbols.intern("trades")] = trades
    rt.interp.globals[symbols.intern("quotes")] = quotes
    run_join("wj",
             "(window-join1 [sym ts] (map-left + [-1000 1000] "
             "(at trades 'ts)) trades quotes "
             "{mx: (max p) mn: (min p)})", 59145.6, 2, kind="wjoin")

    # asof join, detail-only (the reference publishes no standalone
    # asof baseline; examples/aj.rfl scale: 10M trades x 20M quotes)
    run_join("aj", "(asof-join [sym ts] trades quotes)", None, 2)

    geo = float(np.exp(np.mean(np.log(np.maximum(speedups, 1e-9)))))

    print(json.dumps({
        "metric": "suite_geomean_speedup_vs_reference",
        "value": round(geo, 3),
        "unit": "x",
        "vs_baseline": round(geo, 3),
        "device": device,
        "detail": {k: round(v, 1) for k, v in results.items()},
        # provenance: per-query engine/exec_ms/min/avg/max + noise
        # flags so a bad environment can't silently poison the record
        "queries": stats,
    }))


if __name__ == "__main__":
    main()
