"""End-to-end training driver with fault tolerance: the port of
``repro.launch.train``.

  * deterministic restart-safe data (batch = f(seed, step)),
  * atomic checkpoints every --ckpt-every steps with auto-resume,
  * failure injection (--fail-at-step kills the process before that step,
    exit 17; rerunning the same command resumes from the last commit),
  * the straggler watchdog fed with per-step times,
  * a (--data, --model) mesh: one process a rank, the state sharded
    (``distributed.state.shard_model``) and the step an SPMD program;
    elastic restore: resuming on another mesh re-shards the checkpoint
    (the npz is mesh-agnostic).  Logs come from rank 0.

Weights are drawn from ``--seed`` with the port's generator (the
reference's numbers differ: JAX and torch streams do not match); the
batches are the reference's, bit for bit.

Example (CPU, reduced config):
  python -m repro_torch.launch.train --device cpu --arch yi_6b --reduced \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ck --ckpt-every 20
On the card (the default device) drop ``--device cpu``.  A mesh run starts
one process a rank, e.g. ``torchrun --nproc-per-node 4 -m
repro_torch.launch.train --data 2 --model 2 ...`` (NCCL on the card, one
card a rank; gloo with ``--device cpu``); a process group already
initialised by the caller is used as it is.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import ShapeConfig, get_config, get_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import state as D
from repro_torch.ft.watchdog import Watchdog
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--data", type=int, default=1, help="data mesh axis")
    ap.add_argument("--model", type=int, default=1, help="model mesh axis")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="failure injection: exit(17) before this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap


def _init_group(dev: torch.device, world: int) -> None:
    """The process group of a mesh run: the caller's, or torchrun's
    (``env://``: NCCL on the card, gloo on the CPU)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise RuntimeError(
                f"a {world}-rank mesh run takes one process a rank: start "
                f"it with torchrun (or initialise the process group first)")
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if dist.get_world_size() != world:
        raise ValueError(f"--data x --model = {world} ranks, but the "
                         f"process group has {dist.get_world_size()}")


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, dtype=args.dtype)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    world = args.data * args.model
    mesh = None
    import torch.distributed as dist
    if world > 1 or dist.is_initialized():
        from repro_torch.launch.mesh import make_debug_mesh
        _init_group(dev, world)
        mesh = make_debug_mesh(args.data, args.model, device_type=dev.type)
    rank0 = mesh is None or dist.get_rank() == 0

    def log(msg):
        if rank0:
            print(msg, flush=True)

    model = T.init_params(cfg, seed=args.seed, device=dev)
    if args.dtype == "bfloat16":
        model = T.cast_params(model, torch.bfloat16)
    p_shard = o_shard = None
    if mesh is not None:
        p_shard = SH.param_shardings(model, mesh)
        o_shard = opt.AdamWState(step=None, m=p_shard, v=p_shard)
        D.shard_model(model, mesh)
    opt_state = opt.init_adamw(model)

    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        (model, opt_state), start_step = ckpt.restore(
            args.ckpt_dir, (model, opt_state),
            shardings=None if mesh is None else (p_shard, o_shard))
        log(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(
        cfg, opt.AdamWConfig(lr=args.lr), microbatch=args.microbatch)
    def act():
        return L.activation_sharding(mesh, SH.batch_axes(mesh)) \
            if mesh is not None else contextlib.nullcontext()
    wd = Watchdog(hosts=1)
    losses = []
    for step in range(start_step, args.steps):
        if step == args.fail_at_step:
            log(f"[train] INJECTED FAILURE at step {step}")
            os._exit(17)
        batch = make_batch(cfg, shape, step, args.seed)
        t0 = time.monotonic()
        with act():
            model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        wd.beat(0, time.monotonic() - t0)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            log(f"[train] step={step} loss={loss:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"t={time.monotonic()-t0:.2f}s "
                f"watchdog={wd.decide()}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, (model, opt_state))
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, (model, opt_state))
    log(f"[train] done. first loss={losses[0]:.4f} last={losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
