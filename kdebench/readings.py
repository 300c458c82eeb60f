"""The two readings that the limits of a cell's comparison are set from.

    python3 kdebench/readings.py --workload <cell> --seeds 1,2,3 \
        --calls 2 --control-seeds 1,2,3 [--faults a,b --fault-seeds 1,2,3]

For each seed of ``--seeds``: the cell's set-up, one warm call and
``--calls`` calls of the program, and the reference's numbers over them
(the lower readings).  For each of ``--control-seeds``: the control (the
reference in the program's place, with TF32 products) at the cell's own
size, held to the same numbers (the upper readings).  A JSON line each,
then one with each number's largest program reading and least control
reading.  With ``--faults``, each fault of ``faults.py`` planted under
``--calls`` calls on each of ``--fault-seeds``, held to the same numbers:
the upper readings of the numbers no lower-precision control moves (a
law); ``--faults all`` plants every fault of the cell's pipeline.  Needs a CUDA card, as the benchmark does; the benchmark's own
runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--calls", type=int, default=2)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args(argv)
    import torch
    from kdebench import data, faults, harness
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.benchmark_spec()
    _, cell, config, traffic = harness.load_cell(spec, args.workload)
    pipe = harness.pipeline(traffic["pipeline"])
    lower, upper = {}, {}
    planted = [f for f in args.faults.split(",") if f]
    if planted == ["all"]:
        planted = list(faults.FAULTS[traffic["pipeline"]])
    todo = sorted(set(_seeds(args.seeds)) | set(_seeds(args.control_seeds))
                  | set(_seeds(args.fault_seeds)))
    by_fault = {}
    for seed in todo:
        t0 = time.perf_counter()
        x = data.make_points(config, seed, "cuda")
        state = pipe.setup(config, traffic, x, data.bandwidth(config, x, seed),
                           "cuda")
        del x
        line = dict(seed=seed)
        outs = []
        if seed in _seeds(args.seeds):
            pipe.call(state, harness.call_seed(seed, -1))
            for i in range(args.calls):
                out, _, failed = pipe.call(state, harness.call_seed(seed, i))
                line["failed"] = line.get("failed", 0) + int(failed)
                outs.append(out)
        fault_outs = {}
        if seed in _seeds(args.fault_seeds):
            for f in planted:
                with faults.planted(traffic["pipeline"], f):
                    pipe.call(state, harness.call_seed(seed, -1))
                    fault_outs[f] = [
                        pipe.call(state, harness.call_seed(seed, i))[0]
                        for i in range(args.calls)]
        inputs = pipe.release(state)
        del state
        line["program_s"] = time.perf_counter() - t0
        if outs:
            t1 = time.perf_counter()
            line["program"] = pipe.numbers(inputs, outs, seed, cell["check"])
            line["reference_s"] = time.perf_counter() - t1
            for k, v in line["program"].items():
                lower[k] = max(lower.get(k, v), v)
        if seed in _seeds(args.control_seeds):
            t1 = time.perf_counter()
            line["control"] = pipe.control(inputs, seed, cell["check"])
            line["control_s"] = time.perf_counter() - t1
            for k, v in line["control"].items():
                upper[k] = min(upper.get(k, v), v)
        for f, fo in fault_outs.items():
            got = pipe.numbers(inputs, fo, seed, cell["check"])
            line.setdefault("faults", {})[f] = got
            for k, v in got.items():
                d = by_fault.setdefault(f, {})
                d[k] = min(d.get(k, v), v)
        print(json.dumps(line), flush=True)
        del inputs
        torch.cuda.empty_cache()
    print(json.dumps(dict(workload=args.workload, lower=lower,
                          upper=upper, faults=by_fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
