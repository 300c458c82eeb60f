#!/usr/bin/env python3
"""Measure how far RWKV6's chunked form leaves its scan at full width.

    PYTHONPATH=src python3 tools/rwkv_chunk_gap.py [--layers 1,2,32]
        [--batch 4] [--seq 512] [--device cuda|cpu] [--weights port|reference]

Builds rwkv6-3b at full width (d 2560, 40 heads of 64) cut to each depth
in ``--layers`` (the first N layers of one model), f32, and runs one
``make_batch`` batch (seed 0) through ``transformer.forward`` with the
chunked mixer (chunks of 128, the default) and with the scan; prints, a
line a depth, max |chunked - scan| of the last position's logits over the
real vocab beside max |logit|.

``--weights port`` (the default) draws the weights with the port's
``init_params(seed=0)`` on ``--device``; ``--weights reference`` takes
the JAX reference's ``init_params(PRNGKey(0))`` tree (CPU only; needs
``jax``) and also prints the reference's own chunked-vs-scan gap on it.
The reference's chunked form clamps exp(lp_t) at e^-30 but not
exp(-lp_{s+1}) (``repro/models/ssm.py``), so where a channel's log decay
passes -30 inside a chunk the two forms part; the port mirrors it.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", default="1,2,4,8,16,24,32")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--weights", choices=["port", "reference"],
                    default="port")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import convert
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import transformer as T
    depths = [int(x) for x in args.layers.split(",")]
    full = dataclasses.replace(get_config("rwkv6_3b"), dtype="float32",
                               num_layers=max(depths))
    batch = make_batch(full, ShapeConfig("gap", args.seq, args.batch,
                                         "prefill"), 0, 0)
    v = full.vocab_size
    ref = None
    if args.weights == "reference":
        import jax
        from repro.configs.base import get_config as jconfig
        from repro.models import transformer as JT
        jc = dataclasses.replace(jconfig("rwkv6_3b"), dtype="float32",
                                 num_layers=max(depths))
        params = JT.init_params(jax.random.PRNGKey(0), jc)
        model = convert.params_from_reference(
            jax.tree.map(np.asarray, params), full, device=args.device)
        ref = (jax, JT, jc, params)
    else:
        model = T.init_params(full, seed=0, device=args.device)
    print(f"rwkv6_3b f32, weights {args.weights}, batch {args.batch} x "
          f"{args.seq}, device {args.device}"
          + (f" ({torch.cuda.get_device_name(0)})"
             if args.device == "cuda" else ""), flush=True)
    with torch.inference_mode():
        for depth in depths:
            cfg = dataclasses.replace(full, num_layers=depth)
            sub = T.Transformer(cfg, model.embed, list(model.layers[:depth]),
                                model.final_norm)
            logits = {mx: T.forward(sub, cfg, batch, seq_mixer=mx)[0][:, -1]
                      for mx in ("chunked", "scan")}
            gap = float((logits["chunked"] - logits["scan"])[:, :v].abs()
                        .max())
            top = float(logits["scan"][:, :v].abs().max())
            line = (f"layers {depth}: max |chunked - scan| {gap:.3e}, "
                    f"max |logit| {top:.4f}")
            if ref is not None:
                jax, JT, jc, params = ref
                jcd = dataclasses.replace(jc, num_layers=depth)
                sub_p = jax.tree.map(lambda a: a, params)
                sub_p["layers"] = jax.tree.map(lambda a: a[:depth],
                                               params["layers"])
                out = {mx: np.asarray(jax.jit(
                    lambda p, t, mx=mx: JT.forward(
                        p, jcd, {"tokens": t}, remat=False,
                        seq_mixer=mx)[0][:, -1])(sub_p, batch["tokens"]))
                    for mx in ("chunked", "scan")}
                line += (f"; the reference's own gap "
                         f"{np.abs(out['chunked'] - out['scan'])[:, :v].max():.3e}")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
