"""What the benchmark's CPU tests share: the import path and the small
sizes at which a cell runs on the CPU through the port's plain paths."""
from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SPARSIFY = "sparsify.gauss262k.exact"
LRA = "lra.mnist70k.exact"

# each cell at a size a test run holds, with enough calls in its window
# for the pooled law checks to see a fault
SMALL = {
    SPARSIFY: {"config": {"data": {"n": 2048}},
               "traffic": {"entry": {"batch": 1024}},
               "cell": {"trace_calls": 2}},
    LRA: {"config": {"data": {"n": 600}},
          "traffic": {"entry": {"num_rows": 100}},
          "cell": {"trace_calls": 3}},
}
# the sparsifier's configuration with a wider cloud: kernel values spread
# over orders of magnitude, so that the neighbor law tells blocks apart
PEAKED = {"config": {"data": {"n": 2048, "std": 1.75}},
          "traffic": {"entry": {"batch": 1024, "edges_per_point": 64}},
          "cell": {"trace_calls": 2}}
SECONDS = {SPARSIFY: 1.0, LRA: 2.5}
CALLS = {SPARSIFY: 3, LRA: 8}


def run_small(cell: str, seed: int = 11, trace: bool = False, **kw):
    """One run of ``cell`` at its small size on the CPU (the JAX check
    left to the subprocess test: other tests of a worker load JAX)."""
    from kdebench import harness
    orig = harness.forbidden_modules
    harness.forbidden_modules = lambda: []
    try:
        seconds = kw.pop("seconds", SECONDS.get(cell))
        overrides = kw.pop("overrides", SMALL.get(cell))
        return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                                overrides=overrides, **kw)
    finally:
        harness.forbidden_modules = orig


def run_calls(cell: str, seed: int, overrides: dict | None = None):
    """A small run of exactly ``CALLS[cell]`` calls, whatever the CPU's
    load: the traced window, which stops at ``trace_calls``."""
    over = dict(overrides or SMALL[cell])
    over["cell"] = dict(over.get("cell", {}), trace_calls=CALLS[cell])
    return run_small(cell, seed, trace=True, seconds=600.0, overrides=over)
