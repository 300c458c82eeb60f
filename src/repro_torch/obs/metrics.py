"""Trace spans + metrics registry (DESIGN.md §15.2), for torch programs.

Host-side telemetry with the reference's performance contract:

* **Disabled by default, near-zero overhead.**  One module-level flag
  guards every recording call; while disabled, ``counter_inc`` /
  ``gauge_set`` / ``observe`` / ``event`` are a single branch and ``span``
  returns a shared no-op context manager -- no dict churn, no allocation
  on the hot path.  ``span``, ``counter_inc``, ``observe`` and
  ``note_sync`` also record, without ``enable()``, while a
  ``torch.profiler`` session is active (one more C++ flag read while
  neither holds), so a traced run sees the program's stages.
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
* **Profiler integration.**  While recording, spans open a profiler
  range (function scope, so no device-side twin), so the same names show
  up in a ``torch.profiler`` trace beside the kernels they enclose.
* **Span records.**  Each finished span is kept in a bounded ring: its
  name, the span open when it began, host start and end, a pair of CUDA
  events on the current stream (when CUDA is initialised) and the host
  syncs (``note_sync``) counted while it was the innermost open span.
  The events are resolved only by ``span_records()``, so recording never
  synchronises.
"""
from __future__ import annotations

import bisect
import itertools
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
_spans: List["_Record"] = []
_MAX_SPANS = 4096
_ids = itertools.count()
_local = threading.local()      # this thread's open spans, innermost last
_profiling = torch.autograd._profiler_enabled


def _live() -> bool:
    """Whether recording calls record: ``enable()`` or an active
    ``torch.profiler`` session."""
    return _enabled or _profiling()


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
        _spans.clear()


def counter_inc(name: str, value: int = 1) -> None:
    """Monotone counter; no-op while not recording."""
    if not _live():
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
    """Record one histogram sample; no-op while not recording."""
    if not _live():
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


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _device_event():
    """A timing event recorded on the current CUDA stream, or None where
    CUDA is not initialised (CPU programs)."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Record:
    """One span: see ``span_records`` for the fields it is read as."""

    __slots__ = ("id", "name", "parent", "t0", "t1", "ev0", "ev1",
                 "device_s", "syncs")

    def __init__(self, name: str, parent):
        self.id = next(_ids)
        self.name = name
        self.parent = parent
        self.syncs = 0
        self.device_s = None
        self.ev1 = None


class _Span:
    """Recording span: a profiler range, an elapsed histogram and a
    record in the span ring."""

    __slots__ = ("name", "_rf", "_rec")

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._rec = None

    def __enter__(self):
        # a function-scope range: a user-scope one (``record_function``)
        # gets a device-side twin in a CUDA trace, spanning the kernels it
        # launched, that a device timeline would count as a kernel
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        stack = _open_spans()
        rec = _Record(self.name, stack[-1].id if stack else None)
        stack.append(rec)
        self._rec = rec
        rec.ev0 = _device_event()
        rec.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        rec.t1 = time.perf_counter()
        if rec.ev0 is not None:
            rec.ev1 = _device_event()
        _open_spans().pop()
        self._rf.__exit__(*exc)
        observe(f"span.{self.name}.us", (rec.t1 - rec.t0) * 1e6)
        with _lock:
            _spans.append(rec)
            if len(_spans) > _MAX_SPANS:
                del _spans[: len(_spans) - _MAX_SPANS]
        return False


def span(name: str):
    """``with span("serve.tick"): ...`` -- a profiler-annotated timed
    region, recorded while ``enable()`` holds or a profiler runs; the
    shared no-op singleton otherwise."""
    return _Span(name) if _live() else _NULL_SPAN


def note_sync() -> None:
    """Count one host synchronisation (a read of a device result, a copy
    to the device, a solver that checks its status on the host) against
    the innermost open span and the registry counter ``host_syncs``;
    no-op while not recording.  The KDE pipelines call it where they
    cross between the host and their device, on the CPU too, so a CPU
    run counts the syncs the same call makes on a card."""
    if not _live():
        return
    stack = _open_spans()
    if stack:
        stack[-1].syncs += 1
    counter_inc("host_syncs")


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host (``t.cpu()``), counted by ``note_sync``: the way
    the KDE pipelines read a result of their device."""
    note_sync()
    return t.cpu()


def to_device(a, device, dtype=None) -> torch.Tensor:
    """Host data ``a`` as a tensor on ``device``
    (``torch.as_tensor(a, dtype=dtype).to(device)``), counted by
    ``note_sync``: a copy from pageable host memory waits on the host."""
    note_sync()
    return torch.as_tensor(a, dtype=dtype).to(device)


def span_records() -> List[dict]:
    """The finished spans in the ring, oldest first, as dicts: ``id``,
    ``name``, ``parent`` (the id of the span open when it began, or
    None), ``start`` (host clock), ``host_s``, ``device_s`` (between the
    span's two CUDA events; its host seconds where it recorded none),
    ``self_s`` (``device_s`` less its children's in the ring) and
    ``syncs``.  Waits for the events not resolved yet."""
    with _lock:
        recs = list(_spans)
    for r in recs:
        if r.device_s is None:
            if r.ev1 is None:
                r.device_s = r.t1 - r.t0
            else:
                r.ev1.synchronize()
                r.device_s = r.ev0.elapsed_time(r.ev1) / 1e3
                r.ev0 = r.ev1 = None
    child_s: Dict[int, float] = {}
    for r in recs:
        if r.parent is not None:
            child_s[r.parent] = child_s.get(r.parent, 0.0) + r.device_s
    return [dict(id=r.id, name=r.name, parent=r.parent, start=r.t0,
                 host_s=r.t1 - r.t0, device_s=r.device_s,
                 self_s=r.device_s - child_s.get(r.id, 0.0),
                 syncs=r.syncs) for r in recs]


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
