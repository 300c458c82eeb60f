"""Several ranks on one CUDA card: what do NCCL and gloo take?

    python tools/nccl_one_card_probe.py [--ranks 2] [--timeout 120]

First spawns ``--ranks`` processes that all select device 0, join one
NCCL process group (a ``FileStore`` under ``build/``, a group timeout) and
all-reduce one float.  Each rank prints what happened: the reduced value,
or the exception's type and first lines (NCCL refuses two ranks on one
device, which is why the mesh phases of ``chip_smoke.py`` run their ranks
on gloo).  Then the same ranks join a gloo group and try, on CUDA tensors,
each collective the LM's sharded programs use: a sum and a max
all-reduce, a list all-gather, ``all_gather_into_tensor`` and
``reduce_scatter_tensor``; each rank prints per collective whether it ran
and whether its result is right (the port's wrapper stages gloo's CUDA
tensors through the host whatever the answer).  Exits 0 once every rank
has reported, whichever the outcome.
"""
from __future__ import annotations

import argparse
import datetime
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rank_main(rank, world, store, timeout):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    try:
        dist.init_process_group(
            "nccl", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        msg = f"all_reduce returned {float(t):.1f}"
    except Exception as e:            # noqa: BLE001 -- the probe's answer
        lines = str(e).strip().splitlines()
        msg = f"{type(e).__name__}: " + " | ".join(lines[:4])
    print(f"[nccl probe] rank {rank} of {world} on cuda:0: {msg}",
          flush=True)
    # a refused communicator can hang its teardown: leave at once
    os._exit(0)


def gloo_cuda_main(rank, world, store, timeout):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    dev = torch.device("cuda", 0)
    rs = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor

    def sum_():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return float(t[0]) == world * (world + 1) / 2

    def max_():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t[0]) == world

    def gather_list():
        parts = [torch.empty(2, device=dev) for _ in range(world)]
        dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
        return [float(p[0]) for p in parts] == list(range(world))

    def gather_tensor():
        out = torch.empty(2 * world, device=dev)
        dist.all_gather_into_tensor(out, torch.full((2,), float(rank),
                                                    device=dev))
        return out[::2].tolist() == list(range(world))

    def scatter():
        out = torch.empty(2, device=dev)
        rs(out, torch.arange(2 * world, dtype=torch.float32, device=dev))
        return out.tolist() == [world * (2 * rank), world * (2 * rank + 1)]

    for name, fn in (("all_reduce SUM", sum_), ("all_reduce MAX", max_),
                     ("all_gather (list)", gather_list),
                     ("all_gather_into_tensor", gather_tensor),
                     ("reduce_scatter_tensor", scatter)):
        try:
            ok = fn()
            torch.cuda.synchronize()
            msg = "ran, result " + ("right" if ok else "WRONG")
        except Exception as e:        # noqa: BLE001 -- the probe's answer
            lines = str(e).strip().splitlines()
            msg = f"refused: {type(e).__name__}: " + " | ".join(lines[:2])
        print(f"[gloo-cuda probe] rank {rank} of {world}, torch "
              f"{torch.__version__}: {name} on cuda:0 tensors {msg}",
              flush=True)
    dist.barrier()
    dist.destroy_process_group()


def _spawn(fn, ranks, store, timeout, what):
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(ranks, store, timeout), nprocs=ranks,
                             join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=float(timeout) + 30.0):
            print(f"[{what}] ranks still running past the timeout: killed",
                  flush=True)
            break
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=120)
    args = ap.parse_args(argv)
    out = ROOT / "build" / "nccl_probe"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    _spawn(rank_main, args.ranks, str(out / "store"), args.timeout,
           "nccl probe")
    _spawn(gloo_cuda_main, args.ranks, str(out / "store_gloo"), args.timeout,
           "gloo-cuda probe")
    return 0


if __name__ == "__main__":
    sys.exit(main())
