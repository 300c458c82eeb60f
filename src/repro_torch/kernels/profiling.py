"""The CUDA kernels a callable launches, from torch.profiler traces.

A trace on the card can drop its first kernel records (0 to 9 of them,
whatever their length, more often later in a process:
``tools/profiler_probe.py``) and, rarely, hold no device activity at all.
``device_kernels`` starts each trace with spin kernels, left out of its
counts, and takes a trace that is not whole again.  Used by
``chip_smoke.py`` and the CUDA tests; nothing on a compute path calls it.
"""
from __future__ import annotations

PAD_LAUNCHES, PAD_CYCLES = 32, 20000     # spin kernels ahead of a trace


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_kernels(fn, reps: int, traces: int = 3, log=None) -> dict:
    """{name: (launches, device us)} of every CUDA kernel (and memset or
    copy) in a trace of ``reps`` calls of ``fn``, after one warm-up call.

    A trace is whole when each kernel's count is a whole multiple of
    ``reps`` (every ``fn`` given here launches device work, so an empty
    trace is not whole).  The first whole trace of up to ``traces`` is
    returned; ``log`` (a callable, or None) gets a line for each other.
    If none is whole, each kernel keeps the most launches any trace saw
    (a lost record lowers a count, never raises it) and no device time
    (None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = {}
    for attempt in range(1, traces + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD_LAUNCHES):
                torch.cuda._sleep(PAD_CYCLES)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ks = {e.key: (e.count, _dev_us(e)) for e in prof.key_averages()
              if _dev_us(e) > 0 and "spin_kernel" not in e.key
              and str(getattr(e, "device_type", "")).endswith("CUDA")}
        if ks and all(c % reps == 0 for c, _ in ks.values()):
            return ks
        if log is not None:
            log(f"[profiler] trace {attempt} of {traces} of {reps} calls "
                f"lost records: " + (", ".join(
                    f"{k[:48]} x{c}" for k, (c, _) in ks.items())
                    or "no device activity")
                + ("; tracing again" if attempt < traces else ""))
        for k, (c, _) in ks.items():
            best[k] = (max(best.get(k, (0, None))[0], c), None)
    return best
