#!/usr/bin/env python3
"""End-to-end check of the query engine on a GPU.

    python chip_smoke.py [--seed N]           # one GPU
    python chip_smoke.py --mesh 4 [--seed N]  # the row-sharded engines

One process drives the main path through the entry points users call
(Runtime.eval_str, which the CLI and the IPC server call too) at the
size of the db-benchmark G1_1e7_1e2_0_0 group-by and join tasks:

1. device   the JAX backend must be a GPU; prints its kind, the device
            count and nvidia-smi's name and power limit.
2. load     G1 (10M rows: id1..id6 of cardinality 100/100/100k/100/100/
            100k, v1 in 1..5, v2 in 1..15, v3 uniform 0-100 rounded to 6
            decimals) written with (set-splayed dir t) and read back with
            (get-splayed dir); a 1M-row right table keyed on id3 (half the
            keys match); trades (10M) and quotes (20M) over 18k symbols.
3. queries  q1-q7, inner-join and left-join, asof-join, window-join1 and
            one xasc. Each must run on a device engine (read from the
            engine's last_profile) and must agree with the host kernels
            of ops/ (the plain reference) on the same data. Then one
            pmap over a lambda, which forks after the device is in use.
4. serve    an IpcServer thread answers three queries sent by a client
            over hopen/write; the answers must equal the in-process ones.

With --mesh N only the mesh phase runs: RAYFORCE_MESH=N over 10M rows
per device, the grouped selects q2 and q3, inner-join, asof-join,
window-join1 and xasc on the distributed engines, each compared with
the host kernels. The two joins on trades/quotes are compared at a
tenth of the size (the host reference alone would take minutes); the
full-size device run is still checked for its engine and shape.

Keys, counts, integer sums, extrema, first/last values and every row
order must be exactly equal. f64 sums and averages must agree within
RTOL: the device sums f64 groups in another order than numpy (cumulative
sums, tree reductions), so results differ in the last bits; 1e-9 leaves
about six decimal digits of headroom over f64 rounding for these sums.

Any failure raises, so the script exits non-zero and prints no result
line. The last line of stdout is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

RTOL = 1e-9

FULL = {"g1": 10_000_000, "right": 1_000_000, "trades": 10_000_000,
        "quotes": 20_000_000, "mesh_rows": 10_000_000,
        "mesh_compare_div": 10}

SELECT_ENGINES = {"bcast", "sortagg", "wide"}
MESH_SELECT_ENGINES = {"dist-group", "bcast-spmd"}

# name, query, engine module, device engines, f64 columns compared
# within RTOL (every other column must be equal)
QUERIES = [
    ("q1", "(select {s: (sum v1) from: t by: id1})",
     "select", SELECT_ENGINES, ()),
    ("q2", "(select {s: (sum v1) from: t by: {id1: id1 id2: id2}})",
     "select", SELECT_ENGINES, ()),
    ("q3", "(select {s: (sum v1) a: (avg v3) from: t by: id3})",
     "select", SELECT_ENGINES, ("a",)),
    ("q4", "(select {a1: (avg v1) a2: (avg v2) a3: (avg v3) from: t "
     "by: id4})", "select", SELECT_ENGINES, ("a1", "a2", "a3")),
    ("q5", "(select {s1: (sum v1) s2: (sum v2) s3: (sum v3) from: t "
     "by: id6})", "select", SELECT_ENGINES, ("s3",)),
    ("q6", "(select {mx: (max v1) mn: (min v2) from: t by: id3})",
     "select", SELECT_ENGINES, ()),
    ("q7", "(select {s: (sum v3) c: (count v3) from: t by: {id1: id1 "
     "id2: id2 id3: id3 id4: id4 id5: id5 id6: id6}})",
     "select", SELECT_ENGINES, ("s",)),
    ("inner-join", "(inner-join [id3] t r)",
     "join", {"device-sortmerge"}, ()),
    ("left-join", "(left-join [id3] t r)",
     "join", {"device-sortmerge"}, ()),
    ("asof-join", "(asof-join [sym ts] trades quotes)",
     "join", {"device-sortmerge"}, ()),
    ("window-join1", "(window-join1 [sym ts] (map-left + [-1000 1000] "
     "(at trades 'ts)) trades quotes {mx: (max p) mn: (min p)})",
     "wjoin", {"device-wjoin"}, ()),
    ("xasc", "(xasc t [id3 v1])", "sort", {"device-sort"}, ()),
]

MESH_QUERIES = {
    "q2": ("select", MESH_SELECT_ENGINES),
    "q3": ("select", MESH_SELECT_ENGINES),
    "inner-join": ("join", {"dist-bcast-probe", "dist-eq"}),
    "asof-join": ("join", {"dist-asof"}),
    "window-join1": ("wjoin", {"dist-wjoin"}),
    "xasc": ("sort", {"dist-sort"}),
}

IPC_QUERIES = ("q1", "q2", "q6")


def say(*a):
    print(*a, flush=True)


# -- data ---------------------------------------------------------------------

def make_g1(rng, n):
    """db-benchmark G1_1e7_1e2_0_0 shape (integer ids, as bench.py)."""
    cols = {}
    for i, card in enumerate((100, 100, 100_000, 100, 100, 100_000), 1):
        cols[f"id{i}"] = rng.integers(0, card, n, dtype=np.int64)
    cols["v1"] = rng.integers(1, 6, n, dtype=np.int64)
    cols["v2"] = rng.integers(1, 16, n, dtype=np.int64)
    cols["v3"] = np.round(rng.uniform(0.0, 100.0, n), 6)
    return cols


def make_right(rng, n):
    return {"id3": rng.permutation(2 * n)[:n].astype(np.int64),
            "w1": rng.uniform(0.0, 100.0, n)}


def make_trades_quotes(rng, nt, nq):
    trades = {"sym": rng.integers(0, 18_000, nt, dtype=np.int64),
              "ts": np.sort(rng.integers(0, 2_000_000_000, nt,
                                         dtype=np.int64))}
    quotes = {"sym": rng.integers(0, 18_000, nq, dtype=np.int64),
              "ts": np.sort(rng.integers(0, 2_000_000_000, nq,
                                         dtype=np.int64)),
              "p": rng.uniform(10.0, 200.0, nq)}
    return trades, quotes


def bind(rt, name, cols):
    """Bind {name: numpy column} as a Rayfall table global."""
    from rayforce_tpu.core import symbols, types as T
    from rayforce_tpu.core.obj import Obj, table, vec_sym
    t = table(vec_sym(list(cols)),
              [Obj(T.F64 if a.dtype == np.float64 else T.I64, a)
               for a in cols.values()])
    rt.interp.globals[symbols.intern(name)] = t
    return t


# -- results ------------------------------------------------------------------

def result_columns(res):
    """[(name, type code, array)] of a result table. A LIST column of
    optional atoms (a left join's right-only column) becomes a
    (values, present) pair with absent values zeroed."""
    from rayforce_tpu.core import symbols, types as T
    from rayforce_tpu.core.obj import DevPendingList, to_np
    if res.t != T.TABLE:
        raise AssertionError(f"expected a table, got type {res.t}")
    names, cols = res.v
    out = []
    for sid, col in zip(to_np(names), cols):
        nm = symbols.name_of(int(sid))
        if col.t == T.LIST:
            p = col.pending()
            if isinstance(p, DevPendingList):
                vals, has = (np.asarray(a) for a in p.arr)
            else:
                items = col.v
                has = np.fromiter((o.t != -T.NULL for o in items),
                                  dtype=bool, count=len(items))
                vals = np.asarray([o.v if o.t != -T.NULL else 0
                                   for o in items])
            vals = np.where(has, vals, np.zeros((), vals.dtype))
            out.append((nm, col.t, (vals, has)))
        else:
            out.append((nm, col.t, np.asarray(to_np(col))))
    return out


def _rel_dev(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        raise AssertionError("null positions differ")
    ok = ~np.isnan(a)
    a, b = a[ok], b[ok]
    if not len(a):
        return 0.0
    scale = np.maximum(np.abs(a), np.abs(b))
    diff = np.abs(a - b)
    rel = np.divide(diff, scale, out=np.zeros_like(diff),
                    where=scale > 0)
    return float(rel.max())


def compare(got, want, tolerant=(), rtol=RTOL):
    """Check a device result against the host reference. Columns named
    in `tolerant` must agree within rtol (relative); every other column
    must be equal, nulls included. Returns the largest relative
    deviation over the tolerant columns."""
    if [(n, t) for n, t, _ in got] != [(n, t) for n, t, _ in want]:
        raise AssertionError(
            f"columns differ: {[(n, t) for n, t, _ in got]} vs "
            f"{[(n, t) for n, t, _ in want]}")
    worst = 0.0
    for (nm, _t, a), (_n, _t2, b) in zip(got, want):
        if isinstance(a, tuple):
            if not (np.array_equal(a[1], b[1])
                    and np.array_equal(a[0], b[0], equal_nan=True)):
                raise AssertionError(f"column {nm} differs")
            continue
        if a.shape != b.shape:
            raise AssertionError(
                f"column {nm}: shape {a.shape} vs {b.shape}")
        if nm in tolerant:
            d = _rel_dev(a, b)
            if d > rtol:
                raise AssertionError(
                    f"column {nm}: relative deviation {d:.3e} > {rtol:g}")
            worst = max(worst, d)
        elif not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
            bad = np.flatnonzero(a != b)
            raise AssertionError(
                f"column {nm}: {len(bad)} rows differ, first at row "
                f"{bad[0]}: {a[bad[0]]!r} vs {b[bad[0]]!r}")
    return worst


# -- measurement --------------------------------------------------------------

class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling."""

    def __init__(self):
        import jax.monitoring
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name, secs, **_kw):
        if name.startswith("/jax/core/compile/"):
            self.total += secs


def peak_bytes():
    import jax
    st = jax.devices()[0].memory_stats()
    return st.get("peak_bytes_in_use") if st else None


class Phase:
    """Prints a phase's wall time, compile seconds and device peak."""

    def __init__(self, name, clock):
        self.name, self.clock = name, clock

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.c0 = self.clock.total
        say(f"== phase {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            say(f"== phase {self.name} ok: wall_s="
                f"{time.perf_counter() - self.t0:.3f} compile_s="
                f"{self.clock.total - self.c0:.3f} "
                f"peak_bytes_in_use={peak_bytes()}")
        return False


def _clear_profiles():
    from rayforce_tpu.engine import join, select, sort, wjoin
    for m in (join, select, sort, wjoin):
        m.last_profile.clear()


def _engine_of(module):
    from rayforce_tpu.engine import join, select, sort, wjoin
    mods = {"join": join, "select": select, "sort": sort, "wjoin": wjoin}
    return mods[module].last_profile.get("engine")


def device_answer(rt, query, module, engines, clock):
    """Run a query on the device engine; returns (columns, engine,
    wall seconds, compile seconds)."""
    from rayforce_tpu.engine import device as dev
    dev.set_enabled(True)
    _clear_profiles()
    c0, t0 = clock.total, time.perf_counter()
    cols = result_columns(rt.eval_str(query))
    wall = time.perf_counter() - t0
    eng = _engine_of(module)
    if eng not in engines:
        raise AssertionError(
            f"engine {eng!r} ran, expected one of {sorted(engines)}")
    return cols, eng, wall, clock.total - c0


def host_answer(rt, query):
    from rayforce_tpu.engine import device as dev
    dev.set_enabled(False)
    try:
        t0 = time.perf_counter()
        cols = result_columns(rt.eval_str(query))
        return cols, time.perf_counter() - t0
    finally:
        dev.set_enabled(True)


def check_query(rt, name, query, module, engines, tolerant, clock,
                compared="full"):
    got, eng, dev_s, comp_s = device_answer(rt, query, module, engines,
                                            clock)
    want, host_s = host_answer(rt, query)
    worst = compare(got, want, tolerant)
    say(f"query {name}: engine={eng} rows={len(got[0][2])} "
        f"compared={compared} "
        f"max_rel_dev={worst:.3e} (rtol {RTOL:g}) device_s={dev_s:.3f} "
        f"compile_s={comp_s:.3f} host_s={host_s:.3f} "
        f"peak_bytes_in_use={peak_bytes()}")
    return got


# -- phases -------------------------------------------------------------------

def phase_device(n_needed):
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX backend is "
                         f"{backend!r}); this check runs on a GPU only")
    devs = jax.devices()
    if len(devs) < n_needed:
        raise SystemExit(f"chip_smoke: needs {n_needed} GPUs, found "
                         f"{len(devs)}")
    say(f"device: platform={devs[0].platform} "
        f"kind={devs[0].device_kind} count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        say(f"nvidia-smi: {line.strip()}")


def phase_load(rt, sizes, seed, workdir):
    rng = np.random.default_rng(seed)
    bind(rt, "g1", make_g1(rng, sizes["g1"]))
    path = os.path.join(workdir, "g1")
    rt.eval_str(f'(set-splayed "{path}" g1)')
    rt.eval_str(f'(set t (get-splayed "{path}"))')
    rt.eval_str("(set g1 0)")
    n = int(rt.eval_str("(count t)").v)
    if n != sizes["g1"]:
        raise AssertionError(f"splayed table has {n} rows")
    bind(rt, "r", make_right(rng, sizes["right"]))
    trades, quotes = make_trades_quotes(rng, sizes["trades"],
                                        sizes["quotes"])
    bind(rt, "trades", trades)
    bind(rt, "quotes", quotes)
    say(f"load: t={n} rows (splayed round trip) r={sizes['right']} "
        f"trades={sizes['trades']} quotes={sizes['quotes']}")


def phase_queries(rt, clock):
    kept = {}
    for name, query, module, engines, tolerant in QUERIES:
        got = check_query(rt, name, query, module, engines, tolerant,
                          clock)
        if name in IPC_QUERIES:
            kept[name] = got
    # pmap forks the process that now holds the device; the children
    # run the lambda on the host kernels
    box = {}
    th = threading.Thread(target=lambda: box.update(
        r=rt.eval_str("(pmap (fn [x] (* x 2)) (til 16))")), daemon=True)
    th.start()
    th.join(120)
    if th.is_alive():
        raise AssertionError("pmap did not return within 120 s")
    from rayforce_tpu.core.obj import to_np
    got = to_np(box["r"])
    if not np.array_equal(got, np.arange(16) * 2):
        raise AssertionError(f"pmap returned {got!r}")
    say("pmap: returned 16 values after the device was in use")
    return kept


def phase_serve(rt, kept):
    from rayforce_tpu import Runtime
    from rayforce_tpu.ipc.server import IpcServer
    server = IpcServer(rt, 0, host="127.0.0.1")
    server.start()
    port = server.listener.getsockname()[1]
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            server.run_once(0.05)

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    try:
        cli = Runtime()
        h = int(cli.eval_str(f'(hopen "127.0.0.1:{port}")').v)
        for name, query, *_ in QUERIES:
            if name not in IPC_QUERIES:
                continue
            got = result_columns(cli.eval_str(
                f"(write {h} {json.dumps(query)})"))
            compare(got, kept[name])
            say(f"serve {name}: {len(got[0][2])} rows over IPC equal "
                f"the in-process answer")
        cli.eval_str(f"(hclose {h})")
    finally:
        stop.set()
        th.join(timeout=5)
        server.stop()


def phase_mesh(n_dev, seed, sizes, clock):
    from rayforce_tpu import Runtime
    from rayforce_tpu.engine import device as dev
    os.environ["RAYFORCE_MESH"] = str(n_dev)
    dev._mesh_state.update({"mesh": None, "checked": False})
    m = dev.mesh()
    say(f"mesh: {dict(m.shape)} over {n_dev} devices")
    rng = np.random.default_rng(seed)
    rows = sizes["mesh_rows"] * n_dev
    rt = Runtime()
    bind(rt, "t", make_g1(rng, rows))
    bind(rt, "r", make_right(rng, sizes["right"]))
    say(f"mesh load: t={rows} rows r={sizes['right']}")
    by_name = {q[0]: q for q in QUERIES}
    for name in ("q2", "q3", "inner-join", "xasc"):
        _n, query, _m, _e, tolerant = by_name[name]
        module, engines = MESH_QUERIES[name]
        check_query(rt, name, query, module, engines, tolerant, clock)
    rt.eval_str("(set t 0)")
    # the trades/quotes joins: full size on the device, compared with
    # the host at a fraction of it
    div = sizes["mesh_compare_div"]
    for n_t, compared in ((rows, None), (rows // div, f"1/{div}")):
        trades, quotes = make_trades_quotes(rng, n_t, 2 * n_t)
        bind(rt, "trades", trades)
        bind(rt, "quotes", quotes)
        del trades, quotes
        for name in ("asof-join", "window-join1"):
            _n, query, _m, _e, tolerant = by_name[name]
            module, engines = MESH_QUERIES[name]
            if compared is None:
                got, eng, dev_s, comp_s = device_answer(
                    rt, query, module, engines, clock)
                if len(got[0][2]) != n_t:
                    raise AssertionError(f"{name}: {len(got[0][2])} rows")
                say(f"query {name}: engine={eng} rows={n_t} "
                    f"compared=shape-only device_s={dev_s:.3f} "
                    f"compile_s={comp_s:.3f} "
                    f"peak_bytes_in_use={peak_bytes()}")
            else:
                check_query(rt, name, query, module, engines, tolerant,
                            clock, compared=f"{compared} ({n_t} rows)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run only the row-sharded phase over N GPUs")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import rayforce_tpu  # noqa: F401  (x64 + compile cache first)
    from rayforce_tpu import Runtime
    import jax

    phase_device(max(args.mesh, 1))
    clock = CompileClock()
    if args.mesh:
        with Phase(f"mesh{args.mesh}", clock):
            phase_mesh(args.mesh, args.seed, FULL, clock)
    else:
        rt = Runtime()
        workdir = tempfile.mkdtemp(prefix=".smoke-", dir=REPO)
        try:
            with Phase("load", clock):
                phase_load(rt, FULL, args.seed, workdir)
            with Phase("queries", clock):
                kept = phase_queries(rt, clock)
            with Phase("serve", clock):
                phase_serve(rt, kept)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
