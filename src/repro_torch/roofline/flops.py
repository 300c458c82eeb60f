"""Analytic FLOPs / bytes model per (arch x shape) cell: the port of
``repro.roofline.flops``, pure arithmetic, the same formulas.

Why analytic: the reference's compiler cost analysis counts a scanned
layer body once, so the roofline's compute / memory terms come from these
formulas; the port's dry run records ``FlopCounterMode``'s count of the
traced step beside them (``launch/dryrun.py``), and its collective bytes
come from the collective wrapper (``roofline/analysis.py``).

All counts are *per global step* (whole cluster); the roofline divides by
chip count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.pipeline import token_split


@dataclasses.dataclass
class CellCost:
    flops: float                 # total FLOPs for the step
    model_flops: float           # 6 N D (dense) / 6 N_active D (MoE), train only
    weight_bytes: float          # parameter bytes touched
    hbm_bytes: float             # modeled HBM traffic
    notes: str = ""


def _attn_flops(cfg: ArchConfig, b: int, sq: int, skv: int,
                causal: bool) -> float:
    """scores + AV for one layer's attention."""
    f = 2.0 * b * cfg.num_heads * sq * skv * cfg.hd * 2
    return f * (0.5 if causal and sq == skv else 1.0)


def _layer_fwd_flops(cfg: ArchConfig, b: int, s: int, skv: int = 0,
                     decode: bool = False) -> float:
    n = b * s
    d, f_ff, hd = cfg.d_model, cfg.d_ff, cfg.hd
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    skv = skv or s
    if cfg.ssm_kind == "rwkv6":
        proj = 2.0 * n * d * (5 * hq * hd) + 2.0 * n * hq * hd * d
        chunk = min(128, s)
        wkv = 2.0 * b * hq * s * (chunk * hd + 2 * hd * hd) * 2
        mlp = 6.0 * n * d * f_ff
        return proj + wkv + mlp
    if cfg.ssm_kind == "mamba2":
        di = 2 * d
        nst = cfg.ssm_state
        proj = 2.0 * n * d * (2 * di + 2 * nst + di // 64) + 2.0 * n * di * d
        chunk = min(128, s)
        ssd = 2.0 * b * (di // 64) * s * (chunk * 64 + 2 * nst * 64) * 2
        out = proj + ssd
        if cfg.hybrid_attn_every:
            # shared attention block (attn + MLP), amortized per layer
            attn = 2.0 * n * d * (hq + 2 * hkv) * hd + 2.0 * n * hq * hd * d \
                + _attn_flops(cfg, b, s, skv, causal=not decode) \
                + 6.0 * n * d * f_ff
            out += attn / cfg.hybrid_attn_every
        else:
            out += 6.0 * n * d * f_ff
        return out
    qkvo = 2.0 * n * d * (hq + 2 * hkv) * hd + 2.0 * n * hq * hd * d
    attn = _attn_flops(cfg, b, s, skv, causal=True)
    if cfg.is_moe:
        mlp = 2.0 * n * d * cfg.num_experts \
            + 6.0 * n * cfg.experts_per_token * 1.25 * d * f_ff
    else:
        mlp = 6.0 * n * d * f_ff
    return qkvo + attn + mlp


def _head_flops(cfg: ArchConfig, b: int, s: int) -> float:
    return 2.0 * b * s * cfg.d_model * cfg.vocab_size


def _param_bytes(cfg: ArchConfig, dtype_bytes: int = 2) -> float:
    return float(cfg.param_count()) * dtype_bytes


def _active_no_embed(cfg: ArchConfig) -> float:
    """Active params excluding embedding/head tables (prefill computes the
    head once per sequence, not per token)."""
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return float(cfg.active_param_count() - emb)


def cell_cost(cfg: ArchConfig, shape: ShapeConfig,
              kde_decode: bool = False) -> CellCost:
    split = token_split(cfg, shape)
    b = shape.global_batch
    s_tok = split["tokens"]
    s_all = shape.seq_len
    pbytes = _param_bytes(cfg)

    if shape.kind == "train":
        fwd = cfg.num_layers * _layer_fwd_flops(cfg, b, s_all) \
            + _head_flops(cfg, b, s_tok)
        if cfg.is_encdec:
            fwd += cfg.encoder_layers * _layer_fwd_flops(cfg, b, split["frontend"])
        flops = 3.0 * fwd  # fwd + 2x bwd (standard 6ND accounting)
        model_flops = 6.0 * cfg.active_param_count() * b * s_tok
        if cfg.is_encdec:
            # encoder params only see the (shorter) encoder sequence
            d, f = cfg.d_model, cfg.d_ff
            attn_p = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.hd \
                + cfg.num_heads * cfg.hd * d
            enc_params = cfg.encoder_layers * (attn_p + 3 * d * f)
            model_flops += 6.0 * enc_params * b * (split["frontend"] - s_tok)
        # HBM: params read ~3x (fwd/bwd/opt) + grads + 2x adam state rw
        hbm = pbytes * 3 + pbytes + 4 * cfg.param_count() * 4 \
            + 2.0 * b * s_all * cfg.d_model * 2 * cfg.num_layers  # act traffic
        return CellCost(flops, model_flops, pbytes, hbm, "fwd+bwd+opt")

    if shape.kind == "prefill":
        flops = cfg.num_layers * _layer_fwd_flops(cfg, b, s_all) \
            + _head_flops(cfg, b, 1)
        if cfg.is_encdec:
            flops += cfg.encoder_layers * _layer_fwd_flops(cfg, b, split["frontend"])
        model_flops = 2.0 * _active_no_embed(cfg) * b * s_tok \
            + _head_flops(cfg, b, 1)
        hbm = pbytes + 2.0 * b * s_all * cfg.d_model * 2 * cfg.num_layers
        return CellCost(flops, model_flops, pbytes, hbm, "prefill fwd")

    # decode: one token, cache length = seq_len
    s_cache = s_all
    if cfg.ssm_kind == "rwkv6":
        per_tok = 2.0 * cfg.active_param_count() \
            + cfg.num_layers * 2.0 * cfg.num_heads * cfg.hd * cfg.hd * 2
        cache_bytes = cfg.num_layers * b * cfg.num_heads * cfg.hd * cfg.hd * 4
    elif cfg.ssm_kind == "mamba2":
        napp = (cfg.num_layers + cfg.hybrid_attn_every - 1) \
            // max(cfg.hybrid_attn_every, 1) if cfg.hybrid_attn_every else 0
        per_tok = 2.0 * cfg.active_param_count() \
            + cfg.num_layers * 2.0 * (2 * cfg.d_model // 64) * cfg.ssm_state * 64 * 2
        attn_cache = s_cache
        if kde_decode:
            attn_cache = s_cache // 16 + 16 * 512  # stride-16 sweep + top-16 blocks
        per_tok += napp * 2.0 * b * cfg.num_heads * attn_cache * cfg.hd * 2 / max(b, 1)
        cache_bytes = cfg.num_layers * b * (2 * cfg.d_model // 64) * cfg.ssm_state * 64 * 4 \
            + napp * b * cfg.num_kv_heads * s_cache * cfg.hd * 2 * 2
    else:
        attn_cache = s_cache
        notes = "exact decode"
        if kde_decode:
            attn_cache = s_cache // 16 + 16 * 512
            notes = "kde decode (stride 16, top-16 x 512)"
        per_tok = 2.0 * cfg.active_param_count()
        per_tok += cfg.num_layers * 2.0 * cfg.num_heads * attn_cache * cfg.hd * 2 / max(b, 1)
        cache_bytes = cfg.num_layers * b * cfg.num_kv_heads * s_cache * cfg.hd * 2 * 2
        if kde_decode:
            cache_bytes = cache_bytes / 16 + cfg.num_layers * b * \
                cfg.num_kv_heads * 16 * 512 * cfg.hd * 2 * 2
    flops = per_tok * b
    model_flops = 2.0 * cfg.active_param_count() * b
    hbm = pbytes + cache_bytes
    return CellCost(flops, model_flops, pbytes, hbm,
                    "kde decode" if kde_decode else "exact decode")
