"""What the metric files share: each ``metrics/<name>.py`` is a ``read(ctx)``
that returns the metric's value, or None where its run has nothing to read
(the metric is then left out of the result line).

``ctx`` holds the run: ``setup_s``, ``window_s`` (host clock), ``finished``
calls, ``work`` (the pipeline's counts summed over the finished calls),
``config`` and, in a traced run, ``trace`` (``tracing.summarize``)."""
from __future__ import annotations

from kdebench import roofline


def _trace(ctx):
    tr = ctx.get("trace")
    return tr if tr and tr["calls"] and tr["kernels"] else None


def launches_per_call(ctx):
    """Device kernels in the traced calls, counted by event, a call."""
    tr = _trace(ctx)
    return None if tr is None else len(tr["kernels"]) / tr["calls"]


def kde_roofline(ctx):
    """The least time of the kernel evaluations the program reports (the
    larger of their FP32 operations at the peak and the points read once a
    call at the HBM peak) over the summed time of every device kernel in
    the traced calls, in percent."""
    tr = _trace(ctx)
    if tr is None or tr["kernel_s"] <= 0 or not ctx["work"]:
        return None
    data = ctx["config"]["data"]
    least = roofline.least_seconds(
        ctx["work"]["kernel_evals"], ctx["config"]["kernel"]["ops_per_eval"],
        ctx["finished"] * data["n"] * data["d"] * 4)
    return 100.0 * least / tr["kernel_s"]


def device_idle_pct(ctx):
    """The share of the traced window in which no device operation runs:
    one minus the union of their intervals over the window, in percent."""
    tr = _trace(ctx)
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
