"""Dense decoder-only model (forward only): the port of the dense branch of
``repro.models.transformer``.

The reference stacks every layer's parameters on a leading L axis and
scans over them; here a ``Transformer`` module holds ``embed`` (V_pad, D),
``layers`` (an ``nn.ModuleList`` of ``DenseLayer``), ``final_norm`` (D,)
and ``lm_head`` (D, V_pad) (``None`` when tied), and a Python loop walks
the layers.  Decode caches keep the reference's stacked layout, ``k`` / ``v``
of shape (L, b, hkv, max_len, hd), bf16 by default as the reference's.
``init_params`` draws f32 weights whatever the config's dtype, and
``cast_params`` casts them to the compute dtype, as the reference does.
The MoE, SSM, hybrid, enc-dec and frontend families raise (ROADMAP.md
queue 1 item 12).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import not_in_slice, resolve_device
from repro_torch.models import layers as L


def check_dense(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is a dense decoder-only config."""
    for flag, what in ((cfg.is_moe, "the MoE family"),
                       (cfg.ssm_kind != "none", "the SSM / hybrid families"),
                       (cfg.is_encdec, "the enc-dec family"),
                       (cfg.frontend != "none", "the frontend families")):
        if flag:
            raise not_in_slice(f"{what} ({cfg.name})", 12)


class DenseLayer(nn.Module):
    """ln1 / ln2 gains (D,), the attention and SwiGLU weights."""

    def __init__(self, ln1, ln2, attn: L.Attention, mlp: L.MLP):
        super().__init__()
        self.ln1, self.ln2 = L._param(ln1), L._param(ln2)
        self.attn, self.mlp = attn, mlp

    def forward(self, cfg: ArchConfig, x, positions, impl: str = "xla",
                cache: Optional[Tuple] = None, cache_pos=None,
                kde_cfg: Optional[Dict] = None):
        h, _ = L.attention_block(self.attn, cfg,
                                 L.rmsnorm(x, self.ln1, cfg.norm_eps),
                                 positions, impl=impl, cache=cache,
                                 cache_pos=cache_pos, kde_cfg=kde_cfg)
        x = x + h
        return x + L.swiglu(self.mlp, L.rmsnorm(x, self.ln2, cfg.norm_eps))


class Transformer(nn.Module):
    """The dense LM's parameters (forward only: none needs a gradient)."""

    def __init__(self, cfg: ArchConfig, embed, layers, final_norm,
                 lm_head=None):
        super().__init__()
        check_dense(cfg)
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: tie_embeddings is "
                             f"{cfg.tie_embeddings}, so lm_head must be "
                             f"{'None' if cfg.tie_embeddings else 'given'}")
        self.cfg = cfg
        self.embed = L._param(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = L._param(final_norm)
        self.register_parameter(
            "lm_head", None if lm_head is None else L._param(lm_head))


# ------------------------------------------------------------------ init
def _init_dense_layer(gen: torch.Generator, cfg: ArchConfig) -> DenseLayer:
    dev = gen.device
    return DenseLayer(torch.ones(cfg.d_model, device=dev),
                      torch.ones(cfg.d_model, device=dev),
                      L.init_attention(gen, cfg), L.init_mlp(gen, cfg))


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Transformer:
    """Random-init model drawn on ``device`` (the card by default) from a
    ``torch.Generator`` seeded with ``seed``: embed and lm_head N(0, 0.02^2),
    weights N(0, 1/fan_in), norms 1, biases 0 -- the reference's scales
    (its numbers differ: JAX and torch streams do not match)."""
    check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    layers = [_init_dense_layer(gen, cfg) for _ in range(cfg.num_layers)]
    embed = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                        device=dev).mul_(0.02)
    head = None
    if not cfg.tie_embeddings:
        head = torch.randn((cfg.d_model, cfg.padded_vocab), generator=gen,
                           device=dev).mul_(0.02)
    return Transformer(cfg, embed, layers, torch.ones(cfg.d_model, device=dev),
                       head)


def cast_params(model: Transformer, dtype: torch.dtype) -> Transformer:
    """The reference's ``cast_params``: a new model whose parameters of two
    or more dims in the reference's tree are in ``dtype``.  That tree
    stacks each layer's parameters on a leading L axis, so every layer
    parameter is cast (its norm gains and QKV biases too), and of the rest
    embed and lm_head; ``final_norm`` (one dim) stays the same f32 tensor.
    The casts are made one tensor at a time, so a cast from f32 holds the
    f32 model and the new weights, never a second f32 copy."""
    def cast(p, stacked=True):
        t = p.detach()
        return t.to(dtype) if t.dim() + stacked >= 2 else t

    def attn(a):
        bias = [cast(getattr(a, n)) for n in ("bq", "bk", "bv")
                if getattr(a, n) is not None]
        return L.Attention(*(cast(getattr(a, n))
                             for n in ("wq", "wk", "wv", "wo")), *bias)

    layers = [DenseLayer(cast(ly.ln1), cast(ly.ln2), attn(ly.attn),
                         L.MLP(*(cast(getattr(ly.mlp, n))
                                 for n in ("w1", "w3", "w2"))))
              for ly in model.layers]
    head = None if model.lm_head is None else cast(model.lm_head, False)
    return Transformer(model.cfg, cast(model.embed, False), layers,
                       cast(model.final_norm, False), head)


# ------------------------------------------------------------------ forward
def _tokens(model: Transformer, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens).to(model.embed.device).long()


def _embed_inputs(model: Transformer, cfg: ArchConfig,
                  batch) -> Tuple[torch.Tensor, int]:
    """Returns (x (b, s, d), n_prefix = 0): the dense family has no
    frontend embeddings."""
    if "frontend" in batch:
        raise not_in_slice("frontend embeddings", 12)
    tok = model.embed[_tokens(model, batch["tokens"])]
    return tok.to(L.dtype_of(cfg)), 0


def forward(model: Transformer, cfg: ArchConfig, batch, *,
            impl: str = "xla", remat: bool = True, seq_mixer: str = "chunked",
            remat_policy: Optional[str] = "none"
            ) -> Tuple[torch.Tensor, float]:
    """Prefill forward.  Returns (logits (b, s, V_pad), aux_loss = 0.0).

    ``remat``, ``seq_mixer`` and ``remat_policy`` are the reference's
    training and SSM options, placeholders here: accepted at the
    reference's defaults (they change nothing in a dense forward without
    gradients), refused otherwise."""
    for name, value, default in (("remat", remat, True),
                                 ("seq_mixer", seq_mixer, "chunked"),
                                 ("remat_policy", remat_policy, "none")):
        if value != default or type(value) is not type(default):
            raise not_in_slice(f"forward({name}={value!r})", 12)
    x, _ = _embed_inputs(model, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    with L.f32_accumulation():
        for layer in model.layers:
            x = layer(cfg, x, positions, impl=impl)
        x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
        return _logits(model, cfg, x), 0.0


def _logits(model: Transformer, cfg: ArchConfig, x):
    """(b, s, padded_vocab) logits with padded columns masked to -1e30."""
    head = model.lm_head if model.lm_head is not None else model.embed.T
    logits = x.float() @ head.float()
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(mask[None, None, :], logits, -1.0e30)
    return logits


# ------------------------------------------------------------------ decode
def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, enc_len: int = 0,
               device=None) -> Dict[str, Any]:
    """Zero KV cache ``k`` / ``v`` of shape (L, b, hkv, max_len, hd), bf16
    by default as the reference's.  ``enc_len`` (the enc-dec memory) must
    be 0."""
    if enc_len != 0:
        raise not_in_slice(f"init_cache(enc_len={enc_len!r})",
                           12)
    check_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(model: Transformer, cfg: ArchConfig, tokens, cache, pos, *,
                impl: str = "xla", kde_cfg: Optional[Dict] = None):
    """One decode step.  tokens (b, s) ints; pos: int (current write
    offset).  Returns (logits (b, s, V_pad), cache).  The new keys and
    values are written into ``cache`` in place (the reference returns an
    updated copy); the returned cache is the same dict."""
    tok = _tokens(model, tokens)
    x = model.embed[tok].to(L.dtype_of(cfg))
    pos = int(pos)
    positions = pos + torch.arange(tok.shape[1], device=x.device)
    with L.f32_accumulation():
        for layer, ck, cv in zip(model.layers, cache["k"], cache["v"]):
            x = layer(cfg, x, positions, impl=impl, cache=(ck, cv),
                      cache_pos=pos, kde_cfg=kde_cfg)
        x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
        return _logits(model, cfg, x), cache
