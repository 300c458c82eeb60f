"""Trace spans + metrics registry (DESIGN.md §15.2), for torch programs.

Host-side telemetry with the reference's performance contract:

* **Disabled by default, near-zero overhead.**  One module-level flag
  guards every recording call; while disabled, ``counter_inc`` /
  ``gauge_set`` / ``observe`` / ``event`` are a single branch and ``span``
  returns a shared no-op context manager -- no dict churn, no allocation
  on the hot path.
* **Fenced timing.**  ``Timer`` is the one sanctioned way to time device
  work: after the timed callable returns it synchronizes every CUDA
  device that holds a tensor of the return value
  (``torch.cuda.synchronize``, the counterpart of
  ``jax.block_until_ready``), so the recorded interval is realized device
  time, never an asynchronous-dispatch tail.  Both the dispatch
  (unfenced) and the fenced wall times are kept.
* **Deterministic percentiles.**  Histograms use fixed log-spaced bucket
  edges; p50/p99 are cumulative-count lookups over those buckets, so two
  runs with identical samples report identical quantiles.
* **Profiler integration.**  While enabled, spans open a
  ``torch.profiler.record_function`` range, so the same names show up in
  a ``torch.profiler`` trace beside the kernels they enclose.
"""
from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Dict, List, Tuple

import torch

_enabled = False
_lock = threading.Lock()

# One registry per process: {kind: {name: metric}}.  Flat dicts keyed by
# full metric name; labels are baked into the name by the caller
# (``serve.latency.t0.sample``) -- no per-call label-dict hashing.
_counters: Dict[str, int] = {}
_gauges: Dict[str, float] = {}
_histograms: Dict[str, "Histogram"] = {}
_events: List[Tuple[str, dict]] = []
_MAX_EVENTS = 4096


def enable() -> None:
    """Turn the registry on (module-level flag; thread-safe)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop all recorded metrics and events (tests, run boundaries)."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _histograms.clear()
        _events.clear()


def counter_inc(name: str, value: int = 1) -> None:
    """Monotone counter; no-op while disabled."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(value)


def gauge_set(name: str, value: float) -> None:
    """Last-write-wins gauge; no-op while disabled."""
    if not _enabled:
        return
    with _lock:
        _gauges[name] = float(value)


def event(name: str, **fields) -> None:
    """Append one structured event (watchdog decisions, chaos
    injections); bounded ring of ``_MAX_EVENTS``, no-op while disabled."""
    if not _enabled:
        return
    with _lock:
        _events.append((name, dict(fields)))
        if len(_events) > _MAX_EVENTS:
            del _events[: len(_events) - _MAX_EVENTS]


def events(prefix: str = "") -> List[Tuple[str, dict]]:
    """Snapshot of recorded events, optionally name-prefix filtered."""
    with _lock:
        return [e for e in _events if e[0].startswith(prefix)]


# Default edges: 1us .. ~100s, 4 buckets per decade (log-spaced).  Fixed
# edges => deterministic quantiles under identical sample streams.
_DEFAULT_EDGES = tuple(
    round(10.0 ** (e / 4.0), 6) for e in range(0, 4 * 8 + 1))


class Histogram:
    """Fixed-bucket histogram (values in microseconds by convention).

    ``record`` is an O(log buckets) bisect + int increment; quantiles are
    read as the upper edge of the first bucket whose cumulative count
    crosses ``q`` -- deterministic and merge-safe (counts add)."""

    __slots__ = ("edges", "counts", "total", "sum")

    def __init__(self, edges: Tuple[float, ...] = _DEFAULT_EDGES):
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.total = 0
        self.sum = 0.0

    def record(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.edges, float(value))] += 1
        self.total += 1
        self.sum += float(value)

    def quantile(self, q: float) -> float:
        """Upper bucket edge at cumulative fraction ``q`` (0 when
        empty); the last bucket reports its lower edge (unbounded)."""
        if self.total == 0:
            return 0.0
        need = q * self.total
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= need and c:
                return self.edges[min(i, len(self.edges) - 1)]
        return self.edges[-1]

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    def as_dict(self) -> dict:
        return dict(count=self.total, sum=self.sum, p50=self.p50,
                    p99=self.p99)


def histogram(name: str,
              edges: Tuple[float, ...] = _DEFAULT_EDGES) -> Histogram:
    """Get-or-create the named histogram.  Recording while disabled is
    the caller's single ``if enabled()`` branch; this accessor always
    returns a live histogram so exporters can read it."""
    with _lock:
        h = _histograms.get(name)
        if h is None:
            h = _histograms[name] = Histogram(edges)
        return h


def observe(name: str, value: float,
            edges: Tuple[float, ...] = _DEFAULT_EDGES) -> None:
    """Record one histogram sample; no-op while disabled."""
    if not _enabled:
        return
    histogram(name, edges).record(value)


class _NullSpan:
    """Shared no-op context manager -- the disabled-mode ``span``."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Enabled-mode span: a profiler range + elapsed histogram."""

    __slots__ = ("name", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._t0 = 0.0

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        us = (time.perf_counter() - self._t0) * 1e6
        self._rf.__exit__(*exc)
        observe(f"span.{self.name}.us", us)
        return False


def span(name: str):
    """``with span("serve.tick"): ...`` -- a profiler-annotated timed
    region; the shared no-op singleton while disabled."""
    return _Span(name) if _enabled else _NULL_SPAN


def _cuda_devices(out, acc: set) -> set:
    """Indices of the CUDA devices holding a tensor of ``out`` (tensors
    nested in tuples, lists and dicts; anything else holds none)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            acc.add(out.get_device())
    elif isinstance(out, (tuple, list)):
        for o in out:
            _cuda_devices(o, acc)
    elif isinstance(out, dict):
        for o in out.values():
            _cuda_devices(o, acc)
    return acc


def fence(out):
    """Wait for the work that produced ``out``: synchronize every CUDA
    device holding one of its tensors (a CPU value needs nothing).
    Returns ``out``."""
    for dev in sorted(_cuda_devices(out, set())):
        torch.cuda.synchronize(dev)
    return out


class Timer:
    """The sanctioned benchmark/serving timer: fenced device timing.

    ``time(fn)`` calls ``fn``, records the unfenced (dispatch) wall time,
    then fences the return value (``fence``: a synchronize of each CUDA
    device holding one of its tensors) and records the fenced wall time.
    ``timeit(fn, repeats, warmup)`` is the benchmark loop with the fence
    built in -- warmup runs are fenced too.

    Results land on the instance (``wall_us`` = fenced median,
    ``dispatch_us``) and -- when the registry is enabled -- in the
    ``timer.<name>.us`` histogram.
    """

    def __init__(self, name: str):
        self.name = name
        self.wall_us: float = 0.0
        self.dispatch_us: float = 0.0
        self.samples_us: List[float] = []

    def _fence(self, out):
        return fence(out)

    def time(self, fn: Callable):
        """One fenced measurement; returns ``fn``'s result."""
        with span(self.name):
            t0 = time.perf_counter()
            out = fn()
            t_disp = time.perf_counter()
            self._fence(out)
            t1 = time.perf_counter()
        self.dispatch_us = (t_disp - t0) * 1e6
        us = (t1 - t0) * 1e6
        self.wall_us = us
        self.samples_us.append(us)
        observe(f"timer.{self.name}.us", us)
        return out

    def timeit(self, fn: Callable, repeats: int = 3, warmup: int = 1,
               reduce: str = "median") -> float:
        """Median (or ``min``/``mean``) fenced wall microseconds over
        ``repeats`` calls after ``warmup`` fenced calls."""
        for _ in range(warmup):
            self._fence(fn())
        t = []
        for _ in range(repeats):
            self.time(fn)
            t.append(self.wall_us)
        t.sort()
        if reduce == "min":
            self.wall_us = t[0]
        elif reduce == "mean":
            self.wall_us = sum(t) / len(t)
        else:
            self.wall_us = t[len(t) // 2]
        return self.wall_us


def get_registry() -> dict:
    """Snapshot of the whole registry (exporters, tests)."""
    with _lock:
        return dict(
            enabled=_enabled,
            counters=dict(_counters),
            gauges=dict(_gauges),
            histograms={k: h.as_dict() for k, h in _histograms.items()},
            events=list(_events),
        )


def histograms() -> Dict[str, Histogram]:
    """Live histogram objects (exporters need bucket internals)."""
    with _lock:
        return dict(_histograms)
