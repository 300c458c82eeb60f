"""The benchmark's driver: one cell, one seed, one window, one result line.

Everything is found by name. ``BENCHMARK.json`` at the checkout's root
lists the cells and metrics; a cell's file (``cells/<cell>.json``) names
its configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), the limits of its comparison and how many
calls a check and a trace take; the configuration names its points'
recipe (``recipes/<recipe>.py``) and any bandwidth rule
(``bandwidths/<rule>.py``); the traffic names its pipeline
(``pipelines/<pipeline>.py``); each metric is read by
``metrics/<metric>.py``.

The window is a closed loop of one caller: whole calls of the entry, back
to back, each with its own seed drawn from the run's; no call starts after
``seconds``, and the window ends when the last call's result is on the
host.  Set-up (``setup_s``) runs from the process's start to the window's:
the imports, the points and bandwidth on the device, the program's
set-up, and one warm call at the cell's own shapes, which loads (or first
builds) the kernel library; each phase's seconds go to standard error and
to the result's ``setup_phases``.
"""
from __future__ import annotations

import gc
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

from kdebench import data, registry

BENCH = registry.BENCH
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(Exception):
    """A run that must print no result."""


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def load_cell(spec: dict, name: str, overrides: dict | None = None,
              bench: Path = BENCH):
    """(workload entry, cell, configuration, traffic) of cell ``name``,
    from the files under ``bench``; ``overrides`` ({"cell": ..,
    "config": .., "traffic": ..}) merge into them (the CPU tests' small
    sizes)."""
    entry = [w for w in spec["workloads"] if w["name"] == name]
    if not entry:
        raise BenchError(f"no cell {name!r} in BENCHMARK.json")
    over = overrides or {}
    cell = _merge(read_json(bench / "cells" / f"{name}.json"),
                  over.get("cell"))
    config = _merge(read_json(bench / "configs" / f"{cell['config']}.json"),
                    over.get("config"))
    traffic = _merge(read_json(bench / "traffic"
                               / f"{cell['traffic']}.json"),
                     over.get("traffic"))
    return entry[0], cell, config, traffic


def metrics_of(spec: dict, name: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones:
    those that list it, or list no cells and move a metric it reports."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(metric: str, bench: Path = BENCH):
    """The module that reads ``metric`` (``metrics/<metric>.py``)."""
    return registry.load("metrics", metric, bench)


def pipeline(name: str, bench: Path = BENCH):
    """The module of pipeline ``name`` (``pipelines/<name>.py``)."""
    return registry.load("pipelines", name, bench)


def within(value: float, limit) -> bool:
    """Whether ``value`` keeps its limit: at most a number, or inside a
    [lower, upper] pair; a value that is not finite never does."""
    if not math.isfinite(value):
        return False
    if isinstance(limit, list):
        return limit[0] <= value <= limit[1]
    return value <= limit


def call_seed(seed: int, index: int) -> int:
    """The seed of call ``index`` of a run (-1: the warm call)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), index + 1])
    return int(ss.generate_state(1)[0]) & 0x7FFFFFFF


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or its package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _window(pipe, state, seed: int, seconds: float, max_calls: int,
            ranged: bool, sync, log):
    """Calls back to back until ``seconds`` have passed (or ``max_calls``
    ran); returns (records, window seconds)."""
    from kdebench import tracing
    records = []
    t0 = time.perf_counter()
    while len(records) < max_calls and (
            not records or time.perf_counter() - t0 < seconds):
        s = call_seed(seed, len(records))
        rec = dict(seed=s, output=None, work={}, failed=True)
        try:
            if ranged:
                with tracing.call_range():
                    out, work, failed = pipe.call(state, s)
            else:
                out, work, failed = pipe.call(state, s)
            rec.update(output=out, work=work, failed=failed)
        except Exception as e:          # a call that raises has failed
            log(f"call {len(records)} (seed {s}) raised "
                f"{type(e).__name__}: {e}")
        records.append(rec)
    sync()
    return records, time.perf_counter() - t0


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             t_start: float | None = None, spec: dict | None = None,
             log=None, bench: Path = BENCH,
             marks: list | None = None) -> dict:
    """One run of cell ``name``: the result line's object.  ``bench``
    holds the cell, configuration, traffic and metric files; ``marks``
    (name, clock) are the set-up phases that ran before this call."""
    import torch
    from kdebench import tracing
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = benchmark_spec() if spec is None else spec
    entry, cell, config, traffic = load_cell(spec, name, overrides, bench)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    marks = list(marks or []) + [("harness", time.perf_counter())]
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
        marks.append(("cuda_init", time.perf_counter()))
    x = data.make_points(config, seed, device, bench)
    bw = data.bandwidth(config, x, seed, bench)
    sync()
    marks.append(("points", time.perf_counter()))
    pipe = pipeline(traffic["pipeline"], bench)
    state = pipe.setup(config, traffic, x, bw, device)
    del x
    marks.append(("program_setup", time.perf_counter()))
    pipe.call(state, call_seed(seed, -1))              # the warm call
    sync()
    marks.append(("warm_call", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    phases, last = {}, t_start
    for key, t in marks:
        phases[key] = t - last
        last = t
    log("setup " + " ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    max_calls = int(cell["trace_calls"]) if trace else 1 << 30
    summary = None
    if trace:
        with tracing.profiled(device) as tr:
            records, window_s = _window(pipe, state, seed, seconds,
                                        max_calls, True, sync, log)
        summary = tracing.summarize(tr.prof)
    else:
        records, window_s = _window(pipe, state, seed, seconds, max_calls,
                                    False, sync, log)
    found = forbidden_modules()
    if found:
        raise BenchError("JAX or its package was loaded: "
                         + ", ".join(found))
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    inputs = pipe.release(state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    done = [r for r in records if not r["failed"]]
    failed = len(records) - len(done)
    limits = cell["limits"]
    checks = {}
    if done:
        rng = np.random.default_rng(int(seed) % (1 << 64))
        k = min(len(done), int(cell["check"]["calls"]))
        pick = sorted(rng.choice(len(done), size=k, replace=False))
        nums = pipe.numbers(inputs, [done[i]["output"] for i in pick],
                            seed, cell["check"])
        checks = {key: {"value": float(nums[key]), "limit": lim}
                  for key, lim in limits.items()}
    correct = bool(done) and failed == 0 and len(checks) == len(limits) \
        and all(within(c["value"], c["limit"]) for c in checks.values())
    work = {}
    for r in done:
        for key, v in r["work"].items():
            work[key] = work.get(key, 0) + v
    ctx = dict(cell=name, config=config, traffic=traffic, setup_s=setup_s,
               window_s=window_s, attempted=len(records), finished=len(done),
               work=work, trace=summary)
    metrics = {}
    for m in metrics_of(spec, name, trace):
        value = reader(m["name"], bench).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(entry["chips"]), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["setup_phases"] = phases
    result["checks"] = checks
    return result
