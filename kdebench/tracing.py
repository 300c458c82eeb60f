"""The traced window: torch.profiler over whole calls, read into the device
timeline the per-layer metrics take.

A trace on the card can lose its first records (0 to 9 kernel records,
seen on that machine), so each trace starts with spin kernels (the pad of
the port's ``kernels/profiling.py``, copied here) that lie before the first
call and outside the window.  Each call is a ``record_function`` range named
``CALL``; the traced window runs from the first call's start to the last
call's end on the trace's own clock, and every device operation is clipped
to it.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

CALL = "kdebench.call"
PAD_LAUNCHES, PAD_CYCLES = 32, 20000
TOP = 10


def is_copy(name: str) -> bool:
    """Memory copies and fills: device operations that are not kernels."""
    return name.startswith(("Memcpy", "Memset"))


@contextlib.contextmanager
def profiled(device_kind: str):
    """A torch.profiler session over the window; the pad runs first on a
    card.  Yields a holder whose ``prof`` is the finished profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device_kind == "cuda":
        acts.append(ProfilerActivity.CUDA)
    holder = type("Trace", (), {})()
    with profile(activities=acts) as prof:
        if device_kind == "cuda":
            for _ in range(PAD_LAUNCHES):
                torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
        yield holder
    holder.prof = prof


def call_range():
    """The range that marks one call in the trace."""
    from torch.profiler import record_function
    return record_function(CALL)


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _merge(spans):
    """Union of (start, end) spans, sorted and disjoint."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof) -> dict | None:
    """The traced window as the readers take it, or None where the trace
    holds no call range:

    - ``window_s``: first call start to last call end;
    - ``calls``: call ranges in the trace;
    - ``busy_s``: the union of every device operation's interval;
    - ``kernels``: device kernel events (copies and fills left out) and
      ``kernel_s`` their summed durations;
    - ``device_ops``: [name, seconds] of the device operations that took
      most time, summed by name;
    - ``idle_gaps``: [host op, seconds] of the idle time between device
      operations, summed by the innermost host op that spans each gap's
      middle (``CALL`` itself where the host ran Python between ops)."""
    events = list(prof.events())
    calls = [e for e in events if e.name == CALL and not _is_device(e)]
    if not calls:
        return None
    lo = min(e.time_range.start for e in calls)
    hi = max(e.time_range.end for e in calls)
    thread = calls[0].thread
    dev = []
    for e in events:
        if not _is_device(e) or e.name.startswith("kdebench."):
            continue
        s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if t > s:
            dev.append((s, t, e.name))
    by_name = defaultdict(float)
    for s, t, name in dev:
        by_name[name] += (t - s) / 1e6
    kernels = [(s, t, n) for s, t, n in dev if not is_copy(n)]
    merged = _merge([(s, t) for s, t, _ in dev])
    busy = sum(t - s for s, t in merged) / 1e6
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if not _is_device(e)
                   and e.thread == thread), key=lambda h: h[0])
    edges = [lo] + [x for span in merged for x in span] + [hi]
    gaps = defaultdict(float)
    stack, i = [], 0           # host ops open at the sweep's point
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "(outside any host op)"
        gaps[label] += (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(window_s=(hi - lo) / 1e6, calls=len(calls), busy_s=busy,
                kernels=kernels, kernel_s=sum(t - s for s, t, _ in kernels)
                / 1e6, device_ops=[[n, v] for n, v in top],
                idle_gaps=[[n, v] for n, v in idle])
