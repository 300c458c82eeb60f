"""Deterministic synthetic LM token batches (the port's numpy copy of
``repro.data.pipeline``; tokens are bit-identical to the reference's).

Tokens are drawn from a Zipf-ish distribution with a learnable bigram
structure.  Every batch is a pure function of (seed, step).

``input_specs`` returns meta tensors for every model input of an (arch,
shape) cell -- the dry run traces against these (no allocation).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


def token_split(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, int]:
    """How the cell's seq_len splits into frontend positions vs text tokens."""
    s = shape.seq_len
    if cfg.is_encdec:
        enc = min(cfg.frontend_tokens, s // 4)
        return {"frontend": enc, "tokens": s - enc}
    if cfg.frontend != "none":
        fe = min(cfg.frontend_tokens, s // 4)
        return {"frontend": fe, "tokens": s - fe}
    return {"frontend": 0, "tokens": s}


def make_batch(cfg: ArchConfig, shape: ShapeConfig, step: int, seed: int = 0,
               batch_override: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Host-side batch for one step (train/prefill kinds)."""
    split = token_split(cfg, shape)
    b = batch_override or shape.global_batch
    rng = np.random.default_rng(np.uint32(seed * 1_000_003 + step))
    st = split["tokens"]
    # zipf-ish marginals + deterministic bigram successor structure
    v = cfg.vocab_size
    base = rng.zipf(1.3, size=(b, st)).astype(np.int64) % v
    succ = (np.arange(v) * 31 + 7) % v
    flip = rng.random((b, st)) < 0.65
    tokens = base.copy()
    tokens[:, 1:] = np.where(flip[:, 1:], succ[base[:, :-1]], base[:, 1:])
    out: Dict[str, np.ndarray] = {"tokens": tokens.astype(np.int32)}
    if split["frontend"]:
        out["frontend"] = rng.normal(
            0, 1, size=(b, split["frontend"], cfg.d_model)).astype(np.float32)
    return out


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins (shape and dtype, no storage) for every input
    of the cell's step function: the reference's ``ShapeDtypeStruct``s."""
    split = token_split(cfg, shape)
    b = shape.global_batch

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": meta((b, split["tokens"]), torch.int32)}
        if split["frontend"]:
            specs["frontend"] = meta((b, split["frontend"], cfg.d_model),
                                     dtype)
        return specs
    # decode: one new token against a max_len cache
    return {"tokens": meta((b, 1), torch.int32)}
