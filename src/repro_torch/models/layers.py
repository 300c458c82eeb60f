"""Transformer building blocks: the port of ``repro.models.layers``.

Weights keep the reference's layout, ``(in, out)``, and are applied as
``x @ w`` (no ``nn.Linear``, so nothing is transposed).  Attention has the
reference's implementations, selected at call time:
  * "xla"   -- plain-torch softmax attention (``xla_attention``; prefills of
               ``CHUNKED_ATTN_THRESHOLD`` tokens or more take the chunked
               online-softmax form, as the reference does),
  * "flash" -- the flash-attention kernel (prefill),
  * "kde"   -- the paper's sub-quadratic decode attention.  The reference
               model calls the jnp mirror ``kde_attention_ref`` so GSPMD can
               shard the cache; the port has no mesh and calls its own
               ``kde_attention.ops.kde_attention``, the same function
               (ROADMAP.md section 3), so every KDE decode step runs the
               fused decode kernel, one launch per layer.
The MoE block is the reference's single-device dispatch
(``_moe_block_gspmd``: grouped capacity slots, over-capacity tokens
dropped), ``cross_attention_block`` the enc-dec decoder's.  The mesh
helpers (``constrain``, ``activation_sharding``, the shard_map MoE and
decode) have no counterpart (ROADMAP.md queue 1 item 12).

Dtypes follow the reference: activations in the config's dtype
(``dtype_of``: bf16 for "bfloat16", else f32), weights cast to it at use
(``transformer.cast_params`` casts them once), rmsnorm and RoPE computed
in f32 and returned in x's dtype, attention scores and PV in f32 with the
output in q's dtype, the cache written in its own dtype.  The reference's matmuls
accumulate in f32.  cuBLAS may reduce a split-K bf16 GEMM in bf16 while
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` is
True (PyTorch's default).  On an H100 it does so at shapes with few output
tiles and a long K (M = 64, N = 256, K = 65,536), and gives the same bits
either way at yi-6b's decode GEMVs (M = 1 or 4, K up to 11,008): the CUDA
tests ``test_bf16_gemv_accumulates_in_f32`` and
``test_bf16_reduction_shows_without_f32_accumulation`` hold both.  So
``transformer.forward`` and ``transformer.decode_step`` run under
``f32_accumulation``, which turns the flag off for the call and restores
it after: free at the decode widths, and the reference's f32 sum at any
other batch or width.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig

_NEG_INF = -1.0e30


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    """The compute dtype: bf16 for a "bfloat16" config, else f32."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@contextmanager
def f32_accumulation():
    """Keep cuBLAS's bf16 GEMMs accumulating in f32 inside the block:
    ``allow_bf16_reduced_precision_reduction`` off, its old value restored
    on exit."""
    mm = torch.backends.cuda.matmul
    old = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_bf16_reduced_precision_reduction = old


# ------------------------------------------------------------------ init
def _param(t: torch.Tensor) -> nn.Parameter:
    """A trainable weight: it takes a gradient (the serving steps run under
    ``torch.inference_mode`` and build no graph)."""
    return nn.Parameter(t)


def _dense_init(gen: torch.Generator, shape, scale=None) -> torch.Tensor:
    """N(0, 1) * scale, scale 1/sqrt(fan_in) by default, drawn on the
    generator's device."""
    scale = scale if scale is not None else 1.0 / (shape[0] ** 0.5)
    return torch.randn(shape, generator=gen, device=gen.device).mul_(scale)


class Attention(nn.Module):
    """wq (d, hq hd), wk / wv (d, hkv hd), wo (hq hd, d); bq / bk / bv when
    the config has a QKV bias."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_param, (wq, wk, wv, wo))
        for name, t in (("bq", bq), ("bk", bk), ("bv", bv)):
            self.register_parameter(name, None if t is None else _param(t))


class MLP(nn.Module):
    """SwiGLU weights: w1 / w3 (d, d_ff), w2 (d_ff, d)."""

    def __init__(self, w1, w3, w2):
        super().__init__()
        self.w1, self.w3, self.w2 = map(_param, (w1, w3, w2))


class MoE(nn.Module):
    """Top-k mixture of SwiGLU experts: router (d, e), w1 / w3 (e, d,
    d_ff), w2 (e, d_ff, d)."""

    def __init__(self, router, w1, w3, w2):
        super().__init__()
        self.router, self.w1, self.w3, self.w2 = map(_param,
                                                     (router, w1, w3, w2))


def init_attention(gen: torch.Generator, cfg: ArchConfig) -> Attention:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    w = [_dense_init(gen, (d, hq * hd)), _dense_init(gen, (d, hkv * hd)),
         _dense_init(gen, (d, hkv * hd)), _dense_init(gen, (hq * hd, d))]
    if cfg.qkv_bias:
        dev = gen.device
        w += [torch.zeros(hq * hd, device=dev),
              torch.zeros(hkv * hd, device=dev),
              torch.zeros(hkv * hd, device=dev)]
    return Attention(*w)


def init_mlp(gen: torch.Generator, cfg: ArchConfig):
    """SwiGLU weights, or a MoE config's router and stacked experts (each
    expert's matrices at 1/sqrt(fan_in), as the reference's per-expert
    init)."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.is_moe:
        e = cfg.num_experts
        return MoE(_dense_init(gen, (d, e)),
                   _dense_init(gen, (e, d, f), scale=d ** -0.5),
                   _dense_init(gen, (e, d, f), scale=d ** -0.5),
                   _dense_init(gen, (e, f, d), scale=f ** -0.5))
    return MLP(_dense_init(gen, (d, f)), _dense_init(gen, (d, f)),
               _dense_init(gen, (f, d)))


# ------------------------------------------------------------------ norms
def _rmsnorm_fwd_impl(x, gain, eps):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gain).to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """The reference's rmsnorm custom VJP: it saves (x, gain) and does the
    gradient math in f32, and the returned x-cotangent is cast back to x's
    dtype (in bf16 the backward residual stream stays bf16, as the
    reference's does)."""

    @staticmethod
    def forward(ctx, x, gain, eps):
        ctx.save_for_backward(x, gain)
        ctx.eps = eps
        return _rmsnorm_fwd_impl(x, gain, eps)

    @staticmethod
    def backward(ctx, g):
        x, gain = ctx.saved_tensors
        x32, g32 = x.float(), g.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        rstd = torch.rsqrt(var + ctx.eps)
        xhat = x32 * rstd
        dgain = torch.sum(g32 * xhat, dim=tuple(range(x.dim() - 1)))
        gg = g32 * gain
        dx = rstd * (gg - xhat * torch.mean(gg * xhat, dim=-1, keepdim=True))
        return dx.to(x.dtype), dgain.to(gain.dtype), None


def rmsnorm(x, gain, eps):
    """The reference's rmsnorm: f32 statistics, the result in x's dtype;
    its backward is ``_RMSNorm``'s."""
    return _RMSNorm.apply(x, gain, eps)


# ------------------------------------------------------------------ rope
def rope_angles(positions, dim, base=10000.0):
    """positions (...,) -> cos/sin (..., dim/2)."""
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=positions.device) / dim))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, style: str = "full"):
    """x (b, h, s, hd); positions (s,) or (b, s).

    style="full": rotate all head dims.  style="glm2d": ChatGLM's 2D RoPE --
    only the first half of the head dims is rotary, the rest pass through.
    """
    hd = x.shape[-1]
    rot = hd if style == "full" else hd // 2
    xr, xp = x[..., :rot], x[..., rot:]
    cos, sin = rope_angles(positions, rot)
    while cos.dim() < xr.dim() - 1:
        cos, sin = cos[None], sin[None]  # broadcast over b, h
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


# ------------------------------------------------------------------ attention
def _split_heads(x, nh, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, nh, hd).transpose(1, 2)


def _merge_heads(x):
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def _qkv(p: Attention, cfg: ArchConfig, x, positions):
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = x @ p.wq.to(x.dtype)
    k = x @ p.wk.to(x.dtype)
    v = x @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = _split_heads(q, hq, hd)
    k = _split_heads(k, hkv, hd)
    v = _split_heads(v, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_style)
    k = apply_rope(k, positions, cfg.rope_style)
    return q, k, v


def xla_attention(q, k, v, causal: bool, q_offset=0, kv_valid=None):
    """(b, hq, sq, hd) x (b, hkv, skv, hd) -> (b, hq, sq, hd), f32 softmax,
    kv heads expanded to hq as the reference does (cast to f32 first, so a
    bf16 cache holds no expanded bf16 copy beside the f32 one)."""
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    kk = torch.repeat_interleave(k.float(), g, dim=1)
    vv = torch.repeat_interleave(v.float(), g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / (hd ** 0.5)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if kv_valid is not None:
        mask = mask & (kpos[None, :] < kv_valid)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        mask = mask & (kpos[None, :] <= qpos)
    s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vv)
    return o.to(q.dtype)


def xla_attention_chunked(q, k, v, causal: bool, q_offset=0, kv_valid=None,
                          chunk: int = 256):
    """Online-softmax attention over KV chunks ('flash in XLA' in the
    reference): peak score memory O(sq * chunk).  A Python loop over the
    chunks takes the place of the reference's ``lax.scan``."""
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    kk = torch.repeat_interleave(k, g, dim=1)
    vv = torch.repeat_interleave(v, g, dim=1)
    nc = (skv + chunk - 1) // chunk
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    qpos = torch.arange(sq, device=dev)[:, None] + q_offset
    q32 = q.float()
    limit = skv if kv_valid is None else kv_valid
    m = torch.full((b, hq, sq), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, sq, hd), dtype=torch.float32, device=dev)
    for ci in range(nc):
        lo, hi = ci * chunk, min((ci + 1) * chunk, skv)
        kci = kk[:, :, lo:hi].float()
        vci = vv[:, :, lo:hi].float()
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kci) * scale
        kpos = lo + torch.arange(hi - lo, device=dev)[None, :]
        mask = kpos < limit
        if causal:
            mask = mask & (kpos <= qpos)
        s = torch.where(mask[None, None], s, _NEG_INF)
        if hi - lo < chunk:
            # the reference zero-pads the last chunk: its padded keys score
            # -1e30 and count in the sum while a row has no valid key
            pad = chunk - (hi - lo)
            s = torch.cat([s, s.new_full(s.shape[:-1] + (pad,), _NEG_INF)],
                          dim=-1)
            vci = torch.cat([vci, vci.new_zeros(vci.shape[:2] + (pad, hd))],
                            dim=2)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vci)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


# sequences at or above this length use the chunked path (dense 32k^2
# scores would not fit device memory)
CHUNKED_ATTN_THRESHOLD = 8192


def kde_decode_attention(q, k, v, kv_valid, top_p: int, bk: int,
                         stride: int):
    """KDE decode attention through ``kde_attention.ops.kde_attention`` (one
    launch of the fused decode kernel per layer on CUDA tensors).

    q (b, hq, 1, hd) single decode step; k, v (b, hkv, S, hd)."""
    from repro_torch.kernels.kde_attention.ops import kde_attention
    assert k.shape[2] % bk == 0, (
        f"KDE attention needs cache length {k.shape[2]} to be a multiple of "
        f"the block size {bk} -- allocate the cache rounded up to bk")
    out = kde_attention(q[:, :, 0, :], k, v, top_p=top_p, bk=bk,
                        stride=stride, kv_valid=kv_valid)
    return out[:, :, None, :]


def attention_block(p: Attention, cfg: ArchConfig, x, positions,
                    impl: str = "xla", cache: Optional[Tuple] = None,
                    cache_pos=None, kde_cfg: Optional[Dict] = None):
    """Returns (out (b, s, d), cache).  With a cache (the layer's (ck, cv)
    of shape (b, hkv, S, hd)) the new keys and values are written into it
    in place at ``cache_pos`` -- the reference returns an updated copy."""
    q, k, v = _qkv(p, cfg, x, positions)
    if cache is None:
        if impl == "flash":
            from repro_torch.kernels.flash_attention.ops import flash_attention
            o = flash_attention(q, k, v, True)
        elif q.shape[2] >= CHUNKED_ATTN_THRESHOLD:
            # long prefill: dense S^2 scores would not fit
            o = xla_attention_chunked(q, k, v, causal=True)
        else:
            o = xla_attention(q, k, v, causal=True)
    else:
        ck, cv = cache                       # (b, hkv, S, hd)
        s = q.shape[2]
        ck[:, :, cache_pos:cache_pos + s] = k.to(ck.dtype)
        cv[:, :, cache_pos:cache_pos + s] = v.to(cv.dtype)
        kv_valid = cache_pos + s
        if impl == "kde" and s == 1:
            kc = kde_cfg or {}
            o = kde_decode_attention(q, ck, cv, kv_valid,
                                     top_p=kc.get("top_p", 16),
                                     bk=kc.get("bk", 512),
                                     stride=kc.get("stride", 16))
        else:
            o = xla_attention(q, ck, cv, causal=True, q_offset=cache_pos,
                              kv_valid=kv_valid)
    out = _merge_heads(o) @ p.wo.to(x.dtype)
    return out, cache


def cross_attention_block(p: Attention, cfg: ArchConfig, x, memory):
    """Encoder-decoder cross attention (no RoPE, no bias, no mask): queries
    from x, keys and values from ``memory`` (b, s_enc, d).  A memory of
    another dtype than x is promoted as the reference's matmul promotes
    it."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    mt = torch.promote_types(memory.dtype, x.dtype)
    q = _split_heads(x @ p.wq.to(x.dtype), hq, hd)
    k = _split_heads(memory.to(mt) @ p.wk.to(x.dtype).to(mt), hkv, hd)
    v = _split_heads(memory.to(mt) @ p.wv.to(x.dtype).to(mt), hkv, hd)
    o = xla_attention(q, k, v, causal=False)
    return _merge_heads(o) @ p.wo.to(x.dtype)


# ------------------------------------------------------------------ mlp
def silu(x):
    """The reference's ``jax.nn.silu``, ``x * (1 / (1 + exp(-x)))``.  XLA
    rounds each of those ops to bf16 on a bf16 input, so a bf16 x runs them
    one by one; torch's fused silu rounds once and differs from it by an
    ulp in about a third of the entries.  In f32 the fused op stands in
    (the two differ by f32 ulps)."""
    if x.dtype == torch.float32:
        return torch.nn.functional.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu(p: MLP, x):
    h = silu(x @ p.w1.to(x.dtype)) * (x @ p.w3.to(x.dtype))
    return h @ p.w2.to(x.dtype)


def _top_k(logits, k: int):
    """(values, indices) of the k largest entries of the last dim, the
    larger first and ties to the lower index, as ``jax.lax.top_k`` orders
    them (``torch.topk`` promises no order among equal values)."""
    idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return torch.gather(logits, -1, idx), idx


def _one_hot(idx, e: int, dtype):
    """``jax.nn.one_hot(idx, e, dtype)`` by comparison with arange(e):
    ``torch.nn.functional.one_hot`` checks its indices' range on the host,
    a device synchronisation in every MoE layer of a decode step."""
    return (idx[..., None] == torch.arange(e, device=idx.device)).to(dtype)


def _experts(p: MoE, x, eq: str):
    """Every expert's gated hidden ``silu(x w1) * (x w3)`` on ``x``;
    ``eq`` names x's axes and the output's around the weights' (e, d, f)."""
    xin, out = eq.split("->")
    h = silu(torch.einsum(f"{xin},edf->{out}", x, p.w1.to(x.dtype)))
    h = h * torch.einsum(f"{xin},edf->{out}", x, p.w3.to(x.dtype))
    return h


def moe_block_dense(p: MoE, cfg: ArchConfig, x):
    """The reference's oracle: every expert runs on every token, the outputs
    combined by the gate matrix.  O(e) cost.  Returns (out, aux)."""
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = x.float() @ p.router.float()                  # (b, s, e)
    gates, idx = _top_k(logits, k)                          # (b, s, k)
    gates = torch.softmax(gates, dim=-1)
    onehot = _one_hot(idx, e, torch.float32)               # (b, s, k, e)
    combine = (gates[..., None] * onehot).sum(2).to(x.dtype)
    h = _experts(p, x, "bsd->ebsf")
    outs = torch.einsum("ebsf,efd->ebsd", h, p.w2.to(x.dtype))
    out = torch.einsum("ebsd,bse->bsd", outs, combine)
    return out, _load_balance_loss(logits, idx, e)


def moe_block(p: MoE, cfg: ArchConfig, x, capacity_factor: float = 1.25):
    """Top-k MoE by grouped capacity dispatch: the reference's
    ``_moe_block_gspmd`` (the port has no mesh, so no shard_map branch).

    Tokens are grouped along the batch dim; each group's s k requests take
    slots in their expert's buffer in token-major order, ``cap = max(int(
    capacity_factor s k / e), 1)`` slots an expert, and a request past
    ``cap`` is dropped (its token passes through the residual only).  The
    gates are the softmax over the top-k logits alone; the aux loss is the
    Switch loss of the top-1 choices.  Returns (out (b, s, d), aux)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = max(int(capacity_factor * s * k / e), 1)
    logits = x.float() @ p.router.float()                   # (b, s, e)
    gates, idx = _top_k(logits, k)                           # (b, s, k)
    gates = torch.softmax(gates, dim=-1)
    eid = idx.reshape(b, s * k)                              # expert a request
    gate = gates.reshape(b, s * k).to(x.dtype)
    onehot = _one_hot(eid, e, torch.int32)                   # (b, s k, e)
    slot = (torch.cumsum(onehot, dim=1) * onehot).amax(-1) - 1
    keep = (slot >= 0) & (slot < cap)
    slot_c = torch.clamp(slot, 0, cap - 1)
    x_rep = torch.repeat_interleave(x, k, dim=1)             # (b, s k, d)
    grp = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    buf = torch.zeros((b, e, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((grp, eid, slot_c), x_rep * keep[..., None].to(
        x.dtype), accumulate=True)                           # (b, e, cap, d)
    h = _experts(p, buf, "becd->becf")
    yb = torch.einsum("becf,efd->becd", h, p.w2.to(x.dtype))
    y = yb[grp, eid, slot_c] * (keep.to(x.dtype) * gate)[..., None]
    y = y.reshape(b, s, k, d).sum(2)
    return y, _load_balance_loss(logits, idx, e)


def _load_balance_loss(logits, idx, e):
    """Switch-style aux loss: e * sum_i f_i * p_i."""
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = torch.mean(_one_hot(idx[..., 0], e, torch.float32),
                             dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1)).float()
    return e * torch.sum(frac_tokens * frac_probs)
