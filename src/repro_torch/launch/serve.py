"""Batched LM serving driver: prefill a batch of prompts, then decode with
the KV cache -- optionally with the paper's KDE attention for long
contexts.  The port of the LM path of ``repro.launch.serve``.

Example (CPU, reduced config):
  python -m repro_torch.launch.serve --device cpu --reduced --batch 4 \\
      --prompt-len 64 --gen 16
  python -m repro_torch.launch.serve --device cpu --reduced --attention kde

On the card (the default device) without ``--reduced`` it serves the full
configuration with random weights drawn on the card.  As in the reference,
the cache is built by replaying the prompt through the decode step
(teacher-forced), so the "prefill" time is that replay; the model runs in
float32 whatever the config says, as the reference's driver does.
``--robust`` raises (ROADMAP.md queue 1 item 12), and so do
``--graph-stream`` and ``--serve-tenants`` (item 9).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, get_config, get_reduced
from repro_torch.data.pipeline import make_batch, token_split
from repro_torch.device import not_in_slice, resolve_device, roadmap_item
from repro_torch.models import transformer as T
from repro_torch.train.train_step import make_decode_step


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--attention", choices=["xla", "kde"], default="xla")
    ap.add_argument("--kde-top-p", type=int, default=4)
    ap.add_argument("--kde-bk", type=int, default=32)
    ap.add_argument("--kde-stride", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--robust", action="store_true",
                    help=f"not ported ({roadmap_item(12)})")
    ap.add_argument("--graph-stream", type=int, default=0,
                    help=f"not ported ({roadmap_item(9)})")
    ap.add_argument("--serve-tenants", type=int, default=0,
                    help=f"not ported ({roadmap_item(9)})")
    return ap


def serve_config(args):
    """The float32 config the driver serves and its cache length (rounded
    up to the KDE block size under ``--attention kde``)."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    max_len = args.max_len or (args.prompt_len + args.gen)
    if args.attention == "kde":   # cache length must tile into KDE blocks
        max_len = ((max_len + args.kde_bk - 1) // args.kde_bk) * args.kde_bk
    return cfg, max_len


def run_lm(args, model=None) -> dict:
    """Serve one batch.  ``model`` (a ``Transformer`` of the served config)
    replaces the random init drawn from ``--seed``.  Returns the
    generations (b, gen) int32, the logits of the last prompt step (the
    first generated token's; (b, V_pad) f32) and of the first decode step,
    the prefill and decode seconds (host clock, each ending in a
    synchronize on the card), the final KV cache, the config and the cache
    length."""
    if args.robust:
        raise not_in_slice("serve --robust", 12)
    if args.graph_stream or args.serve_tenants:
        raise not_in_slice("the graph-serving modes of serve", 9)
    dev = resolve_device(args.device)
    cfg, max_len = serve_config(args)
    shape = ShapeConfig("serve", args.prompt_len, args.batch, "prefill")
    if model is None:
        model = T.init_params(cfg, seed=args.seed, device=dev)
    batch = make_batch(cfg, shape, 0, args.seed)
    split = token_split(cfg, shape)
    tokens = torch.as_tensor(batch["tokens"], device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # prefill: replay the prompt into the cache (teacher-forced, as the
    # reference builds it)
    cache = T.init_cache(cfg, args.batch, max_len, torch.float32, device=dev)
    kde_cfg = {"top_p": args.kde_top_p, "bk": args.kde_bk,
               "stride": args.kde_stride} if args.attention == "kde" else None
    step = make_decode_step(cfg, impl=args.attention, kde_cfg=kde_cfg)
    t0 = time.perf_counter()
    for pos in range(split["tokens"]):
        nxt, logits, cache = step(model, cache, tokens[:, pos:pos + 1], pos)
    sync()
    prefill_t = time.perf_counter() - t0
    prompt_logits = logits[:, -1]

    # decode
    out = [nxt]
    first_logits = None
    t0 = time.perf_counter()
    cur = nxt[:, None]
    for i in range(args.gen - 1):
        pos = split["tokens"] + i
        nxt, logits, cache = step(model, cache, cur, pos)
        if first_logits is None:
            first_logits = logits[:, -1]
        cur = nxt[:, None]
        out.append(nxt)
    gen = torch.stack(out, 1)
    sync()
    decode_t = time.perf_counter() - t0
    return dict(tokens=gen.cpu().numpy(), prompt_logits=prompt_logits,
                first_decode_logits=first_logits, prefill_s=prefill_t,
                decode_s=decode_t, cache=cache, cfg=cfg, max_len=max_len,
                prompt_tokens=split["tokens"])


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    res = run_lm(args)
    gen = res["tokens"]
    print(f"[serve] arch={res['cfg'].name} attention={args.attention} "
          f"batch={args.batch} prompt={res['prompt_tokens']} gen={args.gen}")
    print(f"[serve] prefill {res['prefill_s']:.2f}s, decode "
          f"{res['decode_s']:.2f}s "
          f"({args.gen * args.batch / max(res['decode_s'], 1e-9):.1f} tok/s)")
    print(f"[serve] sample generations: {np.asarray(gen[:2]).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
