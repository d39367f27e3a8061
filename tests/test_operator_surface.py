"""Operator-surface completions from round 2: `row`, `group` of LIST,
parallel `pmap`, and grouped `dev` on host + device."""
import os

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from rayforce_tpu import Runtime                       # noqa: E402
from rayforce_tpu.core.fmt import format_top as fmt    # noqa: E402


def _rt():
    import jax
    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass
    return Runtime()


def test_row_grouped():
    rt = _rt()
    rt.eval_str("(set t (table [k v] (list [1 2 1 2 1] "
                "[10 20 30 40 50])))")
    out = fmt(rt.eval_str("(select {r: (row v) from: t by: k})"))
    assert "[0 2 4]" in out and "[1 3]" in out


def test_row_filtered_keeps_original_ids():
    rt = _rt()
    rt.eval_str("(set t (table [k v] (list [1 2 1 2 1] "
                "[10 20 30 40 50])))")
    out = fmt(rt.eval_str(
        "(select {r: (row v) from: t by: k where: (> v 15)})"))
    assert "[2 4]" in out and "[1 3]" in out


def test_row_plain_is_count():
    rt = _rt()
    assert fmt(rt.eval_str("(row [5 6 7])")) == "3"


def test_group_of_list():
    rt = _rt()
    out = fmt(rt.eval_str('(group (list 1 "ab" 1 [1 2] "ab" [1 2]))'))
    assert "1: [0 2]" in out
    assert "ab: [1 4]" in out
    assert "[1 2]: [3 5]" in out


def test_group_vector_unchanged():
    rt = _rt()
    out = fmt(rt.eval_str("(group [3 1 3 1 2])"))
    assert "3: [0 2]" in out and "1: [1 3]" in out and "2: [4]" in out


def test_pmap_semantics():
    rt = _rt()
    assert fmt(rt.eval_str("(pmap (fn [x] (* x x)) [1 2 3 4 5])")) \
        == "[1 4 9 16 25]"
    assert fmt(rt.eval_str("(pmap + [1 2 3] [10 20 30])")) \
        == "[11 22 33]"
    # order preserved across worker chunks
    assert fmt(rt.eval_str("(pmap (fn [x] (neg x)) (til 20))")) == \
        fmt(rt.eval_str("(map (fn [x] (neg x)) (til 20))"))


def test_pmap_lambda_with_globals():
    rt = _rt()
    rt.eval_str("(set base 100)")
    assert fmt(rt.eval_str("(pmap (fn [x] (+ x base)) [1 2 3])")) \
        == "[101 102 103]"


def test_dev_grouped_host():
    rt = _rt()
    rt.eval_str("(set t (table [k v] (list [1 1 1 2 2] "
                "[2.0 4.0 6.0 5.0 5.0])))")
    out = fmt(rt.eval_str("(select {d: (dev v) from: t by: k})"))
    # std([2,4,6]) = 1.633, std([5,5]) = 0
    assert "1.63" in out and "0" in out


def test_error_span_recorded():
    """Runtime errors carry the failing subexpression's source span
    (the reference nfo discipline, parse.c:45-61); the REPL renders an
    underline from it (app/repl.py _print_span)."""
    from rayforce_tpu.core.errors import RayError
    from rayforce_tpu.app.repl import _print_span
    import io, sys as _s
    rt = _rt()
    src = '(+ 1 (sum "abc"))'
    try:
        rt.eval_str(src)
        assert False, "should have raised"
    except RayError as e:
        assert e.span is not None
        ln, c0, c1 = e.span
        assert ln == 0 and src[c0] == "(" and "sum" in src[c0:c1]
        old = _s.stderr
        _s.stderr = cap = io.StringIO()
        try:
            _print_span(src, e.span)
        finally:
            _s.stderr = old
        out = cap.getvalue()
        assert "^^^" in out and '(sum "abc")' in out


def test_profiler_spans():
    from rayforce_tpu.core import profiler
    profiler.enabled = True
    try:
        profiler.reset()
        rt = _rt()
        rt.eval_str("(set t (table [k v] (list [1 2 1] [1 2 3])))")
        profiler.reset()
        rt.eval_str("(select {s: (sum v) from: t by: k})")
        labels = [l for l, _ in profiler.spans()]
        assert any("select" in l for l in labels)
        assert profiler.report()
    finally:
        profiler.enabled = False


def test_leveled_logging(capsys):
    from rayforce_tpu.core import log
    log.set_level("warn")
    try:
        log.debug("hidden %d", 1)
        log.warn("shown %d", 2)
        err = capsys.readouterr().err
        assert "hidden" not in err and "shown 2" in err
        assert "WARN" in err
    finally:
        log.set_level(None)
    log.error("also hidden when disabled")
    assert "also hidden" not in capsys.readouterr().err


def test_progress_noop_without_tty():
    from rayforce_tpu.core.progress import Progress
    p = Progress("x", 10)
    for _ in range(10):
        p.step()
    p.finish()   # must not raise or print when stderr isn't a tty


def test_update_over_device_result():
    """update/insert over a table whose columns are device-resident
    query-result lanes (DevPendingSliced) materializes transparently."""
    from rayforce_tpu.engine import device as dev
    import numpy as np
    rt = _rt()
    dev.set_threshold(1)
    dev.set_enabled(True)
    try:
        rng = np.random.default_rng(5)
        from rayforce_tpu.core.obj import Obj, table, vec_sym
        from rayforce_tpu.core import types as T, symbols
        n = 3000
        rt.interp.globals[symbols.intern("t")] = table(
            vec_sym(["k", "v"]),
            [Obj(T.I64, rng.integers(0, 600, n).astype(np.int64)),
             Obj(T.I64, rng.integers(0, 50, n).astype(np.int64))])
        rt.eval_str("(set g (select {s: (sum v) from: t by: k}))")
        rt.eval_str("(set g (update {s: (+ s 1) from: g "
                    "where: (> s 100)}))")
        out = fmt(rt.eval_str("(select {mx: (max s) c: (count s) "
                              "from: g})"))
        dev.set_enabled(False)
        rt.eval_str("(set g2 (select {s: (sum v) from: t by: k}))")
        rt.eval_str("(set g2 (update {s: (+ s 1) from: g2 "
                    "where: (> s 100)}))")
        out2 = fmt(rt.eval_str("(select {mx: (max s) c: (count s) "
                               "from: g2})"))
        assert out == out2
    finally:
        dev.set_enabled(True)


def test_pmap_process_pool_correctness(monkeypatch):
    """LAMBDA pmap takes the fork+serde process pool (ops/iter.py
    _pmap_procs — the reference's per-executor VMs, iter.c:135-173,
    as OS processes). Forced to 4 workers regardless of core count:
    results must be order-exact, globals visible in children, error
    semantics preserved via the thread fallback, mixed result types
    unified."""
    import rayforce_tpu.ops.iter as it
    monkeypatch.setenv("RAYFORCE_PMAP_WORKERS", "4")
    calls = []
    orig = it._pmap_procs

    def probe(*a):
        r = orig(*a)
        calls.append(True)
        return r

    monkeypatch.setattr(it, "_pmap_procs", probe)
    rt = _rt()
    rt.eval_str("(set mult 3)")
    assert fmt(rt.eval_str(
        "(pmap (fn [x] (* x mult)) (til 40))")) == \
        fmt(rt.eval_str("(map (fn [x] (* x mult)) (til 40))"))
    assert calls, "process pool did not engage"
    # lambda raising inside a child -> thread fallback raises properly
    import pytest as _pytest
    from rayforce_tpu.core.errors import RayError
    with _pytest.raises(RayError):
        rt.eval_str('(pmap (fn [x] (raise "boom")) (til 16))')


def test_pmap_process_pool_speedup(monkeypatch):
    """On 4+ real cores, pmap of a pure-interpreter lambda beats map
    (the GIL-bound thread pool could not).

    THE ONE ENVIRONMENT-GATED SKIP in the suite: this asserts a
    wall-clock PARALLEL SPEEDUP (pmap < 0.7x map), which is physically
    unmeasurable on fewer than ~4 real cores — forked workers just
    time-slice one CPU and the assertion would flake on scheduler
    noise, not code. pmap CORRECTNESS (process pool engages, results
    match map, child errors propagate) is covered unconditionally by
    test_pmap_process_pool above; only the speedup claim needs real
    parallel hardware (a host with 1 vCPU cannot show a speedup)."""
    import os as _os
    import time
    if (_os.cpu_count() or 1) < 4:
        import pytest as _pytest
        _pytest.skip("parallel speedup unmeasurable on "
                     f"{_os.cpu_count()} core(s); correctness covered "
                     "by test_pmap_process_pool")
    rt = _rt()
    body = "(fn [x] (fold + 0 (til 30000)))"
    rt.eval_str(f"(set work {body})")
    t0 = time.perf_counter()
    rt.eval_str("(map work (til 32))")
    t_map = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt.eval_str("(pmap work (til 32))")
    t_pmap = time.perf_counter() - t0
    assert t_pmap < t_map * 0.7, (t_map, t_pmap)
