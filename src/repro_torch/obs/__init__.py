"""Unified observability layer (DESIGN.md §15), for torch programs.

Three sub-layers, one import surface:

* ``obs.counters`` -- the device counter word: every fused program in
  ``kernels/kde_sampler`` and ``kernels/kde_hash`` returns a fixed-width
  ``(WIDTH,)`` word whose slot 0 is the status bitmask and whose other
  slots count realized device work (kernel evals, level-1 reads, draws,
  rejection retries, FAR samples, overflow occupancy, psums).
* ``obs.metrics`` -- host-side trace spans and a metrics registry:
  ``Timer``/``span`` with mandatory device fencing and
  ``torch.profiler.record_function`` integration, plus counters / gauges
  / fixed-bucket histograms (deterministic p50/p99).  Near-zero overhead
  while disabled (module flag, no per-call dict churn).
* ``obs.export`` -- versioned exporters: the JSON-lines metrics stream of
  ``launch/serve.py``, a Prometheus-text dump, and the telemetry schema
  block of benchmark artifacts.
"""
from repro_torch.obs import counters, export, metrics
from repro_torch.obs.counters import (COUNTER_SLOTS, WIDTH, counter, fold,
                                      status_of, totals, word)
from repro_torch.obs.metrics import (Timer, counter_inc, disable, enable,
                                     enabled, event, gauge_set,
                                     get_registry, histogram, reset, span)

__all__ = [
    "counters", "metrics", "export",
    "WIDTH", "COUNTER_SLOTS", "word", "fold", "status_of", "counter",
    "totals",
    "Timer", "span", "enable", "disable", "enabled", "reset",
    "counter_inc", "gauge_set", "histogram", "event", "get_registry",
]
