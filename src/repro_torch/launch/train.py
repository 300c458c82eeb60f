"""End-to-end training driver with fault tolerance: the port of
``repro.launch.train``.

  * deterministic restart-safe data (batch = f(seed, step)),
  * atomic checkpoints every --ckpt-every steps with auto-resume,
  * failure injection (--fail-at-step kills the process before that step,
    exit 17; rerunning the same command resumes from the last commit),
  * the straggler watchdog fed with per-step times.

The mesh options (--data / --model above 1) need ROADMAP.md queue 1 item
10.  Weights are drawn from ``--seed`` with the port's generator (the
reference's numbers differ: JAX and torch streams do not match); the
batches are the reference's, bit for bit.

Example (CPU, reduced config):
  python -m repro_torch.launch.train --device cpu --arch yi_6b --reduced \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ck --ckpt-every 20
On the card (the default device) drop ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import ShapeConfig, get_config, get_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.device import not_in_slice, resolve_device, roadmap_item
from repro_torch.ft.watchdog import Watchdog
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
    ap.add_argument("--data", type=int, default=1,
                    help=f"data mesh axis (1 only: {roadmap_item(12)})")
    ap.add_argument("--model", type=int, default=1,
                    help=f"model mesh axis (1 only: {roadmap_item(12)})")
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


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.data != 1 or args.model != 1:
        raise not_in_slice(f"--data {args.data} --model {args.model}", 12)
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, dtype=args.dtype)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")

    model = T.init_params(cfg, seed=args.seed, device=dev)
    if args.dtype == "bfloat16":
        model = T.cast_params(model, torch.bfloat16)
    opt_state = opt.init_adamw(model)

    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        (model, opt_state), start_step = ckpt.restore(
            args.ckpt_dir, (model, opt_state))
        print(f"[train] resumed from step {start_step}", flush=True)

    step_fn = make_train_step(
        cfg, opt.AdamWConfig(lr=args.lr), microbatch=args.microbatch)
    wd = Watchdog(hosts=1)
    losses = []
    for step in range(start_step, args.steps):
        if step == args.fail_at_step:
            print(f"[train] INJECTED FAILURE at step {step}", flush=True)
            os._exit(17)
        batch = make_batch(cfg, shape, step, args.seed)
        t0 = time.monotonic()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        wd.beat(0, time.monotonic() - t0)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step={step} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"t={time.monotonic()-t0:.2f}s "
                  f"watchdog={wd.decide()}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, (model, opt_state))
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, (model, opt_state))
    print(f"[train] done. first loss={losses[0]:.4f} last={losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
