"""Batched serving with KDE attention on the PyTorch port: exact vs
sub-quadratic decode (``examples/serve_decode.py`` on ``repro_torch``).

Generates with a small model twice -- once with exact cached attention, once
with the paper's KDE attention (top-P blocks + estimated residual mass; one
launch of the fused KDE decode kernel a layer on the card) -- and reports
the agreement and the compute fraction.  ``--device cpu`` runs the plain
versions.

  PYTHONPATH=src python examples/torch_serve_decode.py
  PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, get_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.models import transformer as T
from repro_torch.train.train_step import make_decode_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    dev = torch.device(ap.parse_args(argv).device)
    cfg = dataclasses.replace(get_reduced("yi_6b"), dtype="float32")
    model = T.init_params(cfg, seed=0, device=dev)
    batch, prompt_len, gen = 2, 192, 12
    kde_bk = 32
    max_len = ((prompt_len + gen + kde_bk - 1) // kde_bk) * kde_bk
    shape = ShapeConfig("serve", prompt_len, batch, "prefill")
    prompts = torch.as_tensor(make_batch(cfg, shape, 0)["tokens"]).to(dev)

    kde_cfg = {"top_p": 5, "bk": kde_bk, "stride": 2}
    outs, logit_traces = {}, {}
    for impl in ("xla", "kde"):
        cache = T.init_cache(cfg, batch, max_len, torch.float32, device=dev)
        step = make_decode_step(
            cfg, impl=impl, kde_cfg=kde_cfg if impl == "kde" else None)
        tok = prompts[:, :1]
        toks, lgs = [], []
        for pos in range(prompt_len + gen - 1):
            nxt, logits, cache = step(model, cache, tok, pos)
            tok = prompts[:, pos + 1:pos + 2] if pos + 1 < prompt_len \
                else nxt[:, None]
            if pos + 1 >= prompt_len:
                toks.append(nxt.cpu().numpy())
                lgs.append(logits[:, -1, :cfg.vocab_size].cpu().numpy())
        outs[impl] = np.stack(toks, 1)
        logit_traces[impl] = np.stack(lgs, 1)
        print(f"{impl:4s}: generated {outs[impl].shape[1]} tokens/seq "
              f"-> {outs[impl][0][:8].tolist()}...")

    a, b = logit_traces["xla"][:, 0], logit_traces["kde"][:, 0]
    cos = np.mean([np.corrcoef(x1, x2)[0, 1] for x1, x2 in zip(a, b)])
    nb = max_len // kde_cfg["bk"]
    frac = (1 / kde_cfg["stride"]) + kde_cfg["top_p"] / nb
    print(f"first-step logits correlation exact vs KDE: {cos:.4f}")
    print(f"KDE attention touches ~{min(frac, 1.0):.0%} of cache entries "
          f"per step at this toy scale; at 500k context with the production "
          f"config (bk=512, top_p=16, stride=16) it touches ~8%")


if __name__ == "__main__":
    main()
