"""Run one cell of the benchmark once and print its result line.

    python3 kdebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``kdebench/``
and the port under ``src/``.  The last line of standard output is the
result (JSON); the last lines of standard error are the compared numbers,
each beside its limit.  Exits 2 without a result when no CUDA card (or too
few for the cell) is present, 3 when the run cannot give one.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or PyTorch may write, at fixed paths inside the
# checkout (the kernel library builds into build/kernels/ by itself)
CACHE = ROOT / "build" / "kdebench"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host side of a call is a few numpy and
# torch operations, and idle thread pools only add jitter
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "2")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    def err(msg):
        print(msg, file=sys.stderr, flush=True)

    try:
        import torch
        marks = [("import_torch", time.perf_counter())]
        from kdebench import harness
        spec = harness.benchmark_spec()
        chips = [w["chips"] for w in spec["workloads"]
                 if w["name"] == args.workload]
    except (ImportError, OSError, ValueError, KeyError) as e:
        err(f"kdebench: cannot start: {type(e).__name__}: {e}")
        return 3
    if not chips:
        err(f"kdebench: no cell {args.workload!r} in BENCHMARK.json")
        return 3
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips[0]:
        err(f"kdebench: the cell needs {chips[0]} CUDA card(s); "
            f"{torch.cuda.device_count()} available")
        return 2
    marks.append(("find_cards", time.perf_counter()))
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START,
                                  spec=spec, log=err, marks=marks)
    except harness.BenchError as e:
        err(f"kdebench: {e}")
        return 3
    except (ImportError, OSError) as e:
        err(f"kdebench: {type(e).__name__}: {e}")
        return 3
    print(json.dumps(result), flush=True)
    for key, c in result["checks"].items():
        err(f"check {key} {c['value']!r} limit {c['limit']!r}")
    err(f"correct {result['correct']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
