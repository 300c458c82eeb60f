"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM for a
few hundred steps, with checkpointing and auto-resume
(``examples/train_lm.py`` on ``repro_torch``).

Default is a quick preset so the script finishes in minutes; pass
``--preset 100m --steps 300`` for the full run.  Runs on the CUDA card;
``--device cpu`` runs the plain versions.

  PYTHONPATH=src python examples/torch_train_lm.py                # ~25M, 60 steps
  PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 4 \\
      --batch 2 --seq 32
"""
import argparse
import sys
import time

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWConfig, init_adamw
from repro_torch.train.train_step import make_train_step

PRESETS = {
    # ~26M params: d=512, 8 layers
    "quick": ArchConfig(name="lm26m", family="dense", num_layers=8,
                        d_model=512, num_heads=8, num_kv_heads=4, d_ff=1536,
                        vocab_size=8192, dtype="float32"),
    # ~112M params: d=768, 12 layers (GPT-2-small-ish)
    "100m": ArchConfig(name="lm100m", family="dense", num_layers=12,
                       d_model=768, num_heads=12, num_kv_heads=6, d_ff=3072,
                       vocab_size=32768, dtype="float32"),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default="quick")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_lm")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    shape = ShapeConfig("lm", args.seq, args.batch, "train")
    model = T.init_params(cfg, seed=0, device=args.device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"== {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} tokens ==")

    state = init_adamw(model)
    start = 0
    if ckpt.latest_step(args.ckpt_dir) is not None:
        (model, state), start = ckpt.restore(args.ckpt_dir, (model, state))
        print(f"resumed from step {start}")
    step = make_train_step(cfg, AdamWConfig(lr=6e-4, warmup_steps=20),
                           remat=True)

    first = loss = None
    t_start = time.time()
    for i in range(start, args.steps):
        batch = make_batch(cfg, shape, i)
        t0 = time.time()
        model, state, m = step(model, state, batch)
        loss = float(m["loss"])
        first = loss if first is None else first
        if i % 10 == 0 or i == args.steps - 1:
            tput = args.batch * args.seq / max(time.time() - t0, 1e-9)
            print(f"step {i:4d}  loss {loss:.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  {tput:,.0f} tok/s",
                  flush=True)
        if (i + 1) % 50 == 0:
            ckpt.save(args.ckpt_dir, i + 1, (model, state))
    ckpt.save(args.ckpt_dir, args.steps, (model, state))
    print(f"done in {time.time() - t_start:.0f}s; "
          f"loss {first:.3f} -> {loss:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
