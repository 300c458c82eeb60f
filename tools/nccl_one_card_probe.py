"""Two NCCL ranks on one CUDA card: does the backend take them?

    python tools/nccl_one_card_probe.py [--ranks 2] [--timeout 120]

Spawns ``--ranks`` processes that all select device 0, join one NCCL
process group (a ``FileStore`` under ``build/``, a group timeout) and
all-reduce one float.  Each rank prints what happened: the reduced value,
or the exception's type and first lines (NCCL refuses two ranks on one
device, which is why the mesh phase of ``chip_smoke.py`` runs its ranks on
gloo).  Exits 0 once every rank has reported, whichever the outcome.
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


def main(argv=None) -> int:
    import torch.multiprocessing as mp
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=120)
    args = ap.parse_args(argv)
    out = ROOT / "build" / "nccl_probe"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ctx = mp.start_processes(
        rank_main, args=(args.ranks, str(out / "store"), args.timeout),
        nprocs=args.ranks, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=float(args.timeout) + 30.0):
            print("[nccl probe] ranks still running past the timeout: "
                  "killed", flush=True)
            break
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
