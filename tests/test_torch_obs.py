"""The port's observability layer (``repro_torch.obs``) and the guard
helpers of the serving layer, against the reference's on the CPU.

The registry, histograms, exporters and the counter-word / status helpers
are host code: the port must give the reference's answers for the same
inputs (``Histogram`` quantiles bucket for bucket, the metrics schema, the
Prometheus names), record nothing while disabled, fence ``Timer`` on the
device of what the timed call returns, and show a ``span`` in a
``torch.profiler`` trace.  The reference's ``tools/check_metrics_schema.py``
reads a log of the port CLI's metrics lines.
"""
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.ft import guards as jg
from repro.obs import counters as jc
from repro.obs import export as jexport
from repro.obs import metrics as jm
from repro_torch import obs
from repro_torch.ft import guards as tg
from repro_torch.obs import counters as tc
from repro_torch.obs import export as texport
from repro_torch.obs import metrics as tm

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_registry():
    tm.reset()
    tm.disable()
    yield
    tm.reset()
    tm.disable()


def test_obs_exports_the_reference_names():
    import repro.obs as robs
    assert sorted(obs.__all__) == sorted(robs.__all__)
    for name in obs.__all__:
        assert hasattr(obs, name), name


# ------------------------------------------------------------- registry
def test_disabled_mode_records_nothing():
    """Disabled: span() is the shared null span, and counter / gauge /
    observe / event / Timer leave NO state behind."""
    assert not tm.enabled()
    assert tm.span("a") is tm.span("b")
    with tm.span("a"):
        pass
    tm.counter_inc("c", 5)
    tm.gauge_set("g", 1.0)
    tm.observe("h", 3.0)
    tm.event("e", detail=1)
    tm.Timer("t").time(lambda: torch.ones(4) + 1)
    reg = tm.get_registry()
    assert reg["counters"] == {} and reg["gauges"] == {}
    assert reg["histograms"] == {} and not tm.events()


def test_enabled_registry_records():
    tm.enable()
    tm.counter_inc("c", 2)
    tm.counter_inc("c", 3)
    tm.gauge_set("g", 7.5)
    tm.observe("h", 100.0)
    tm.event("e", k="v")
    with tm.span("sp"):
        pass
    reg = tm.get_registry()
    assert reg["counters"]["c"] == 5 and reg["gauges"]["g"] == 7.5
    assert "h" in reg["histograms"]
    assert tm.events("e")[0][1]["k"] == "v"
    assert "span.sp.us" in tm.histograms()


def test_event_ring_keeps_the_last_4096():
    tm.enable()
    for i in range(tm._MAX_EVENTS + 10):
        tm.event("e", i=i)
    ev = tm.events()
    assert len(ev) == 4096 and ev[0][1]["i"] == 10


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "ties"])
def test_histogram_quantiles_equal_the_reference(dist):
    """Same samples, same bucket edges, same p50 / p99 / as_dict."""
    rng = np.random.default_rng(7)
    vals = {"lognormal": rng.lognormal(4, 2, 5000),
            "uniform": rng.uniform(0, 2e8, 3000),
            "ties": np.repeat([1.0, 10.0, 5623.413252], 300)}[dist]
    ht, hj = tm.Histogram(), jm.Histogram()
    assert ht.edges == hj.edges
    for v in vals:
        ht.record(float(v))
        hj.record(float(v))
    assert ht.counts == hj.counts
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ht.quantile(q) == hj.quantile(q), q
    assert ht.as_dict() == hj.as_dict()
    assert tm.Histogram().p99 == jm.Histogram().p99 == 0.0


def test_timer_fences_and_records(monkeypatch):
    """Timer records the dispatch and the fenced wall time, and fences
    on the devices of the tensors the call returns (none for CPU
    tensors; one synchronize per CUDA device)."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev))
    tm.enable()
    t = tm.Timer("t")
    out = t.time(lambda: torch.ones((64, 64)) @ torch.ones((64, 64)))
    assert out.shape == (64, 64) and t.wall_us >= t.dispatch_us > 0
    us = t.timeit(lambda: torch.ones(8) + 1, repeats=3, warmup=1)
    assert us > 0 and len(t.samples_us) == 4
    assert "timer.t.us" in tm.histograms()
    assert synced == []
    assert tm._cuda_devices((torch.ones(2), [torch.zeros(1)], {"a": 3}),
                            set()) == set()


def test_span_shows_in_a_profiler_trace():
    from torch.profiler import ProfilerActivity, profile
    tm.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tm.span("serve.tick"):
            torch.ones(16).sum()
    assert "serve.tick" in {e.key for e in prof.key_averages()}


# ------------------------------------------------------------- exporters
def test_schema_constants_equal_the_reference():
    assert texport.SCHEMA_VERSION == jexport.SCHEMA_VERSION
    assert texport.METRICS_PREFIX == jexport.METRICS_PREFIX
    assert texport.METRICS_REQUIRED == jexport.METRICS_REQUIRED
    assert texport.METRICS_MODE_REQUIRED == jexport.METRICS_MODE_REQUIRED
    assert texport.TELEMETRY_REQUIRED == jexport.TELEMETRY_REQUIRED


def test_metrics_line_schema_validation():
    good = dict(schema_version=texport.SCHEMA_VERSION, mode="multi-tenant",
                tenants=2, ticks=4, served=10, failed=0, p50_ms=1.0,
                p99_ms=2.0, throughput_rps=100.0, evictions=0, stale=0,
                realized_evals=123, per_tenant={})
    texport.validate_metrics_line(good)
    with pytest.raises(ValueError):
        texport.validate_metrics_line({k: v for k, v in good.items()
                                       if k != "realized_evals"})
    bad = dict(good, schema_version=texport.SCHEMA_VERSION + 1)
    with pytest.raises(ValueError):
        texport.validate_metrics_line(bad)
    buf = io.StringIO()
    line = texport.emit_jsonl(dict(mode="graph-stream", n=8), stream=buf)
    assert buf.getvalue() == texport.METRICS_PREFIX + line + "\n"
    assert json.loads(line)["schema_version"] == texport.SCHEMA_VERSION


def test_telemetry_block_backend_is_the_device_type():
    blk = texport.telemetry_block(wall_us=12.5, realized_evals=42,
                                  device="cpu")
    texport.validate_telemetry_block(blk, path="unit")
    jexport.validate_telemetry_block(blk, path="unit")
    assert blk["backend"] == "cpu" and blk["fenced"] is True
    assert blk["realized_evals"] == 42
    with pytest.raises(ValueError):
        texport.validate_telemetry_block({"schema_version": 1}, path="u")


def test_prometheus_text_equals_the_reference():
    """The same registry contents give the reference's text, line for
    line."""
    for m in (tm, jm):
        m.reset()
        m.enable()
        m.counter_inc("serve.requests", 3)
        m.gauge_set("resident", 2.0)
        for v in (50.0, 70.0, 9000.0):
            m.observe("lat.us", v)
    try:
        txt = texport.prometheus_text()
        assert txt == jexport.prometheus_text()
        assert "repro_serve_requests 3" in txt and "repro_lat_us" in txt
    finally:
        jm.reset()
        jm.disable()


def test_reference_schema_tool_reads_the_port_cli(tmp_path, monkeypatch):
    """A log of the port CLI's metrics lines (both modes) passes the
    reference's ``tools/check_metrics_schema.py --no-bench``."""
    from repro_torch.launch import serve
    monkeypatch.delenv("REPRO_CHECKS", raising=False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert serve.main(["--device", "cpu", "--serve-tenants", "2",
                           "--requests", "8", "--ticks", "1"]) == 0
        assert serve.main(["--device", "cpu", "--graph-stream", "256",
                           "--ticks", "1"]) == 0
    log = tmp_path / "serve.log"
    log.write_text(buf.getvalue())
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import check_metrics_schema as cms
    finally:
        sys.path.pop(0)
    assert cms.main([str(log), "--no-bench"]) == 0
    lines = [json.loads(ln[len(texport.METRICS_PREFIX):])
             for ln in buf.getvalue().splitlines()
             if ln.startswith(texport.METRICS_PREFIX)]
    assert [m["mode"] for m in lines] == ["multi-tenant", "graph-stream"]
    for m in lines:
        texport.validate_metrics_line(m)


# ------------------------------------------------- counter-word helpers
def _words():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 1 << 31, size=(5, jc.WIDTH)).astype(np.uint32)
    w[:, 0] = rng.integers(0, 1 << 10, size=5)
    return w


def test_counter_helpers_equal_the_reference():
    w = _words()
    t = torch.as_tensor(w.astype(np.int64))
    for slot in list(jc.COUNTER_SLOTS) + list(range(jc.WIDTH)):
        assert tc.counter(t, slot) == jc.counter(w, slot), slot
        assert tc.counter(t[0], slot) == jc.counter(w[0], slot), slot
    np.testing.assert_array_equal(tc.status_of(t).numpy(),
                                  np.asarray(jc.status_of(w)))
    assert tc.status_of(7) == jc.status_of(7) == 7
    assert int(tc.status_of(torch.tensor(5))) == 5
    for a in (w, w[0], 3, np.zeros(3), np.zeros((2, 3))):
        ta = torch.as_tensor(np.asarray(a)) if not isinstance(a, int) else a
        assert tc.is_word(ta) == jc.is_word(a), a
    got = tc.fold_status(t, 1 << 9)
    want = np.asarray(jc.fold_status(w, 1 << 9))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    per = torch.arange(5) << 3
    np.testing.assert_array_equal(tc.fold_status(t, per)[:, 0].numpy(),
                                  (w[:, 0] | (np.arange(5) << 3)))
    lw = tc.lane_words(torch.tensor([1, 0, 4]), evals=10, draws=2)
    assert lw.shape == (3, tc.WIDTH) and lw[:, 0].tolist() == [1, 0, 4]
    assert (lw[:, 1:] == tc.word(evals=10, draws=2)[1:]).all()


def test_raise_per_request_equals_the_reference(monkeypatch):
    """The per-request fan-out: the same ints, and errors on the same
    requests with the same messages, from (R,) statuses or (R, WIDTH)
    words, checks on and off."""
    st = np.array([0, jg.ZERO_MASS, jg.HT_HEAVY, jg.EPOCH_STALE | 1],
                  np.uint32)
    words = np.zeros((4, jc.WIDTH), np.uint32)
    words[:, 0] = st
    ctx = [f"serve:sample:t{i}" for i in range(4)]
    for checks in ("0", "1"):
        monkeypatch.setenv("REPRO_CHECKS", checks)
        for arg in (st, words):
            want = jg.raise_per_request(arg, ctx, allow=jg.HT_HEAVY)
            for targ in (arg, torch.as_tensor(arg.astype(np.int64))):
                got = tg.raise_per_request(targ, ctx, allow=tg.HT_HEAVY)
                assert got[0] == want[0]
                assert [None if e is None else str(e) for e in got[1]] == \
                    [None if e is None else str(e) for e in want[1]]
        got = tg.raise_per_request(st, "one context")
        want = jg.raise_per_request(st, "one context")
        assert [str(e) for e in got[1]] == [str(e) for e in want[1]]


@pytest.mark.parametrize("tot", [[1.0, 2.0], [1e-13, 3.0],
                                 [np.nan, 1.0], [np.inf, 1e-20]])
def test_totals_status_equals_the_reference(tot):
    import jax.numpy as jnp
    want = int(jg.totals_status(jnp.asarray(tot, jnp.float32), 4, 1e-12))
    got = int(tg.totals_status(torch.tensor(tot, dtype=torch.float32), 4,
                               1e-12))
    assert got == want


def test_checked_raises_on_a_non_finite_output():
    def div(a, b):
        return a / b, {"x": [a * 0 + 1]}

    run = tg.checked(div)
    out = run(torch.tensor(1.0), torch.tensor(2.0))
    assert float(out[0]) == 0.5 and run.__name__ == "div"
    with pytest.raises(FloatingPointError, match="div"):
        run(torch.tensor(1.0), torch.tensor(0.0))
    with pytest.raises(FloatingPointError):
        tg.checked(lambda: {"a": [torch.tensor([1.0, float("nan")])]})()
    assert tg.checked(lambda: torch.arange(3))().tolist() == [0, 1, 2]
