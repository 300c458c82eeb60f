"""Prefill and decode step factories: the serving half of
``repro.train.train_step``.

``cross_entropy``, ``loss_fn`` and ``make_train_step`` (AdamW, the flash
and rmsnorm backward passes) are the training slice's (ROADMAP.md queue 1
item 12).  The steps run under ``torch.inference_mode``: no autograd
graph, as the reference's jitted steps keep none.  They run the config's
dtype: a bf16 config with a ``cast_params`` model and a bf16 cache runs
bf16 activations, f32 logits.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import not_in_slice
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ArchConfig, *, impl: str = "xla",
                      seq_mixer: str = "chunked"):
    """Prefill: forward pass returning last-position logits (no loss).
    ``seq_mixer`` (the reference's SSM mixer) must stay at its default."""
    if seq_mixer != "chunked":
        raise not_in_slice(f"make_prefill_step(seq_mixer={seq_mixer!r})", 12)

    @torch.inference_mode()
    def prefill_step(model, batch):
        logits, _ = T.forward(model, cfg, batch, impl=impl)
        return logits[:, -1:]

    return prefill_step


def make_decode_step(cfg: ArchConfig, *, impl: str = "xla",
                     kde_cfg: Optional[Dict] = None):
    """serve_step: one token in, one token out, the cache updated in
    place.  Returns (next tokens (b,) int32, logits (b, 1, V_pad), cache)."""

    @torch.inference_mode()
    def decode_step(model, cache, tokens, pos):
        logits, cache = T.decode_step(model, cfg, tokens, cache, pos,
                                      impl=impl, kde_cfg=kde_cfg)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), \
            logits, cache

    return decode_step
