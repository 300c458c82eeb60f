"""The window's closed loop and the rates read from it."""
from __future__ import annotations

import time

import pytest

import kdebench_testing  # noqa: F401  (the import path)


class _Pipe:
    """A pipeline whose calls take ``dt`` seconds and do ``edges`` work."""

    def __init__(self, dt, edges=100):
        self.dt, self.edges, self.starts = dt, edges, []

    def call(self, state, seed):
        self.starts.append(time.perf_counter())
        time.sleep(self.dt)
        return {}, {"edges": self.edges, "kernel_evals": 7}, False


@pytest.mark.parametrize("dt,seconds", [(0.05, 0.3), (0.2, 0.1),
                                        (0.01, 0.05)])
def test_no_call_starts_after_the_window_and_the_last_one_ends_it(dt,
                                                                  seconds):
    from kdebench.harness import _window
    pipe = _Pipe(dt)
    t0 = time.perf_counter()
    recs, window_s = _window(pipe, None, 1, seconds, 1 << 30, False,
                             lambda: None, print)
    assert max(pipe.starts) - t0 < seconds + 0.25   # none starts late
    assert window_s >= seconds or len(recs) == 1
    assert window_s >= len(recs) * dt
    assert len(recs) == len(pipe.starts) >= 1


def test_rates_take_all_the_window_work_over_all_its_time():
    from kdebench import harness
    for name, value in (("edges_per_s", 3000 / 2.0), ("lra_s", 2.0 / 3),
                        ("setup_s", 4.5), ("kernel_evals_per_edge",
                                           21 / 3000.0)):
        ctx = dict(window_s=2.0, finished=3, setup_s=4.5,
                   work={"edges": 3000, "kernel_evals": 21})
        assert harness.reader(name).read(ctx) == pytest.approx(value)


def test_a_call_that_raises_counts_as_failed():
    from kdebench.harness import _window

    class Bad(_Pipe):
        def call(self, state, seed):
            raise RuntimeError("planted")

    logged = []
    recs, _ = _window(Bad(0.0), None, 1, 0.0, 1 << 30, False, lambda: None,
                      logged.append)
    assert len(recs) == 1 and recs[0]["failed"] and "planted" in logged[0]


def test_call_seeds_differ_and_repeat():
    from kdebench.harness import call_seed
    seeds = [call_seed(2 ** 31 + 7, i) for i in range(-1, 50)]
    assert len(set(seeds)) == len(seeds)
    assert seeds == [call_seed(2 ** 31 + 7, i) for i in range(-1, 50)]
    assert all(0 <= s < 2 ** 31 for s in seeds)


def test_trace_summary_reads_a_timeline():
    """The window, the union of device intervals and the idle gaps by host
    op, on a hand-made timeline (microseconds)."""
    from kdebench import tracing

    class Ev:
        def __init__(self, name, s, e, dev=False, thread=1):
            self.name, self.thread = name, thread
            self.time_range = type("R", (), {"start": s, "end": e})()
            self.device_type = "DeviceType.CUDA" if dev else "DeviceType.CPU"

    events = [Ev(tracing.CALL, 100, 1100), Ev("aten::mm", 160, 300),
              Ev("aten::copy_", 600, 900),
              Ev("spin", 0, 90, dev=True), Ev("gemm", 200, 500, dev=True),
              Ev("gemm", 400, 700, dev=True),
              Ev("Memcpy DtoH", 800, 1000, dev=True),
              Ev(tracing.CALL, 150, 1050, dev=True)]
    prof = type("P", (), {"events": lambda self: events})()
    s = tracing.summarize(prof)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx(700e-6)   # 200-700, 800-1000
    assert len(s["kernels"]) == 2 and s["kernel_s"] == pytest.approx(600e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps[tracing.CALL] == pytest.approx(200e-6)   # 100-200, 1000-1100
    assert gaps["aten::copy_"] == pytest.approx(100e-6)  # 700-800
    assert s["device_ops"][0] == ["gemm", pytest.approx(600e-6)]
