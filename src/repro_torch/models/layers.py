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
               shard the cache; the port calls its own
               ``kde_attention.ops.kde_attention``, the same function
               (ROADMAP.md section 3), so every KDE decode step of a
               whole cache runs the fused decode kernel, one launch per
               layer.
The MoE block dispatches as the reference's does: ``_moe_block_shardmap``
under a mesh whose "model" axis divides the experts, else the grouped
capacity dispatch (``_moe_block_gspmd``: capacity slots, over-capacity
tokens dropped).  ``cross_attention_block`` is the enc-dec decoder's.

Under ``activation_sharding(mesh, batch_axes)`` the blocks run as SPMD
programs on one rank's share (the mesh section below): each parameter
holds the rank's shard under ``distributed.sharding.param_spec`` (tagged
by ``distributed.state.shard_model``), attention and the SwiGLU run
tensor-parallel over "model" where the heads and d_ff divide (column-
parallel wq / wk / wv / w1 / w3, row-parallel wo / w2 and one all-reduce),
anything else gathers its weights and computes replicated over "model";
every collective goes through ``distributed.collectives``.  Under
``activation_sharding(..., seq_mode=True)`` (context-parallel prefill and
training) a forward whose positions divide "model" splits the sequence
instead: each block gathers its weights whole, attention keeps the
rank's queries and gathers the keys and values (``_attend_seq_split``:
the flash kernel at the rank's query offset), and the blocks whose result
depends on the whole sequence (the MoE capacity dispatch, the SSM
mixers) gather it and keep the rank's chunk.

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

import math
import types
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import SPEC_ATTR, entry_axes, mesh_shape

_NEG_INF = -1.0e30

# ------------------------------------------------------------- activation
# sharding context: the launchers wrap a step in ``activation_sharding`` so
# the model code knows the mesh and its batch axes without threading them
# through every call.  The reference pins GSPMD layouts with it; the port's
# blocks read it to run their rank's share (the mesh section below).
_ACT = {"mesh": None, "batch_axes": (), "seq_mode": False,
        "batch_sharded": False, "decode": None, "seq_layout": None}


@contextmanager
def activation_sharding(mesh, batch_axes=("data",), seq_mode: bool = False):
    """Run the model's blocks as SPMD programs on ``mesh`` (a
    ``DeviceMesh``), the batch over ``batch_axes``.

    seq_mode=True: context parallelism for prefill and training, the
    reference's -- activations split the *sequence* over "model" instead
    of heads or d_ff, weights are gathered a layer at a time (FSDP-style)
    and the queries stay sequence-split while keys and values are
    gathered.  For prefill cells whose head counts do not divide the
    tensor-parallel axis (qwen2.5's 40 heads on TP16).  Each forward
    records the layout it took in ``_ACT["seq_layout"]``
    (``seq_layout``): "split" when its token count (a frontend prefix
    included) divides the "model" extent (> 1), else "replicated" (every
    block computes the whole sequence on gathered weights, as the
    reference's ``constrain`` skips an axis that does not divide).  A
    decode step with a cache runs as it does without seq_mode."""
    old = dict(_ACT)
    _ACT.update(mesh=mesh, batch_axes=tuple(batch_axes),
                seq_mode=bool(seq_mode), seq_layout=None)
    try:
        yield
    finally:
        _ACT.update(old)


def seq_layout(n_tokens: int) -> Optional[str]:
    """The layout a forward of ``n_tokens`` positions takes under the
    active context: None without seq_mode, "split" when "model" (> 1
    ranks) divides the positions, else "replicated"."""
    if not (_mesh_on() and _ACT["seq_mode"]):
        return None
    m = model_size()
    return "split" if m > 1 and n_tokens % m == 0 else "replicated"


def seq_split() -> bool:
    """Whether the running forward splits its sequence over "model"."""
    return _ACT["seq_layout"] == "split"


def seq_whole(x, dim: int = 1):
    """In a sequence-split forward, the whole sequence from every rank's
    chunk of ``x`` (an all-gather over "model" whose backward sums the
    ranks' gradients and keeps the chunk); else ``x``."""
    return C.gather_partial(x, group(("model",)), dim) if seq_split() else x


def seq_own(x, dim: int = 1):
    """In a sequence-split forward, this rank's chunk of the whole
    sequence ``x``; else ``x``."""
    return C.own_chunk(x, group(("model",)), dim) if seq_split() else x


def _axes_size(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= shape.get(a, 1)
    return n


def constrain(x, *tail):
    """The reference's ``with_sharding_constraint`` of an activation.  The
    port's programs hold every activation in its rank's layout already
    (the batch rows of its batch shard, the heads or d_ff columns of its
    "model" shard inside a tensor-parallel block), so this is the
    identity."""
    return x


# ------------------------------------------------------------- mesh
def _mesh_on() -> bool:
    return _ACT["mesh"] is not None


def group(axes) -> Optional[C.MeshGroup]:
    """The active mesh's group over the ``axes`` it has (None without a
    mesh or when it has none of them)."""
    mesh = _ACT["mesh"]
    if mesh is None:
        return None
    names = mesh_shape(mesh)
    present = tuple(a for a in axes if a in names)
    return C.mesh_group(mesh, present) if present else None


def model_size() -> int:
    g = group(("model",))
    return 1 if g is None else g.size


def _spec(p):
    return getattr(p, SPEC_ATTR, None) if _mesh_on() else None


def full(p, model_partial: bool = False):
    """Parameter ``p`` gathered whole from its shards.  Over the batch-like
    axes the gather's backward is a reduce-scatter (every rank's batch
    adds its share); over "model" it is the rank's own slice (the compute
    that reads it is replicated over "model"), or with ``model_partial``
    a reduce-scatter (each "model" rank reads another part of it; a
    weight replicated over "model" then sums its gradient over "model").
    In a sequence-split forward every "model" rank reads its own chunk:
    the gather over "model" is a reduce-scatter's adjoint, and a weight
    replicated over "model" has its gradient summed by
    ``distributed.state.reduce_grads(model_partial=True)``."""
    spec = _spec(p)
    if spec is None or p is None:
        return p
    t, on_model = p, False
    for d, e in enumerate(spec):
        for a in entry_axes(e):
            g = group((a,))
            if a == "model":
                on_model = True
                t = (C.gather_partial if model_partial or seq_split()
                     else C.gather_replicated)(t, g, d)
            else:
                t = C.gather_partial(t, g, d)
    if model_partial and not on_model:
        t = C.copy_to_partials(t, group(("model",)))
    return t


def local(p, dim: int):
    """Parameter ``p`` gathered over its batch-like axes only: its "model"
    shard along ``dim`` (a tensor-parallel block's own columns or rows; p
    itself without a mesh or a "model" axis of size 1)."""
    spec = _spec(p)
    if spec is None or p is None:
        return p
    t = p
    for d, e in enumerate(spec):
        for a in entry_axes(e):
            if a != "model":
                t = C.gather_partial(t, group((a,)), d)
    return t


def model_sharded(p, dim: int) -> bool:
    """Whether ``p`` is split over a "model" axis of size > 1 along
    ``dim`` (or the mesh's "model" axis is one rank wide)."""
    spec = _spec(p)
    if spec is None:
        return False
    return model_size() == 1 or "model" in entry_axes(spec[dim])


def module_full(m):
    """``m``'s direct parameters gathered whole (``full``), as a namespace
    the blocks read like the module."""
    if not _mesh_on():
        return m
    return types.SimpleNamespace(**{n: full(p)
                                    for n, p in m._parameters.items()})


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


def _qkv(p: Attention, cfg: ArchConfig, x, positions, hq=None, hkv=None):
    """q, k, v (b, h, s, hd) with RoPE; ``hq`` / ``hkv`` the heads ``p``'s
    columns hold (the config's, or a tensor-parallel rank's own)."""
    hq = cfg.num_heads if hq is None else hq
    hkv = cfg.num_kv_heads if hkv is None else hkv
    hd = cfg.hd
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


def _attn_plan(p: Attention, cfg: ArchConfig):
    """How a rank runs ``p`` under the active mesh: None for replicated
    compute (or no mesh), else the tensor-parallel plan (hq_l, kv_lo,
    kv_hi, kv_local): the rank's hq / msize query heads, the kv heads
    [kv_lo, kv_hi) they read, and whether wk / wv's own shard holds
    exactly those (else they are gathered and sliced)."""
    mg = group(("model",))
    if mg is None or _ACT["seq_mode"]:
        return None
    m, r = mg.size, mg.index
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if hq % m or not (model_sharded(p.wq, 1) and model_sharded(p.wo, 0)):
        return None
    hq_l, g = hq // m, hq // hkv
    if hq_l % g and g % hq_l:
        return None
    kv_lo, kv_hi = (r * hq_l) // g, ((r + 1) * hq_l - 1) // g + 1
    return hq_l, kv_lo, kv_hi, hkv % m == 0 and model_sharded(p.wk, 1)


def _tp_weights(p: Attention, cfg: ArchConfig, plan):
    """The rank's column-parallel wq / wk / wv (and biases) and
    row-parallel wo under ``plan``."""
    _, kv_lo, kv_hi, kv_local = plan
    hd = cfg.hd
    ns = types.SimpleNamespace(wq=local(p.wq, 1), wo=local(p.wo, 0),
                               bq=local(p.bq, 0))
    for w, b in (("wk", "bk"), ("wv", "bv")):
        wt, bt = getattr(p, w), getattr(p, b)
        if kv_local:
            setattr(ns, w, local(wt, 1))
            setattr(ns, b, local(bt, 0))
        else:
            cols = slice(kv_lo * hd, kv_hi * hd)
            setattr(ns, w, full(wt, model_partial=True)[:, cols])
            setattr(ns, b, None if bt is None
                    else full(bt, model_partial=True)[cols])
    return ns


def _write_cache(ck, cv, k, v, cache_pos: int, off: int) -> None:
    """Write the new keys and values at global positions [cache_pos,
    cache_pos + s) into a cache slice holding [off, off + S_l)."""
    s, s_l = k.shape[2], ck.shape[2]
    lo, hi = max(cache_pos, off), min(cache_pos + s, off + s_l)
    if lo < hi:
        ck[:, :, lo - off:hi - off] = k[:, :, lo - cache_pos:
                                        hi - cache_pos].to(ck.dtype)
        cv[:, :, lo - off:hi - off] = v[:, :, lo - cache_pos:
                                        hi - cache_pos].to(cv.dtype)


def attention_block(p: Attention, cfg: ArchConfig, x, positions,
                    impl: str = "xla", cache: Optional[Tuple] = None,
                    cache_pos=None, kde_cfg: Optional[Dict] = None):
    """Returns (out (b, s, d), cache).  With a cache (the layer's (ck, cv)
    of shape (b, hkv, S, hd)) the new keys and values are written into it
    in place at ``cache_pos`` -- the reference returns an updated copy.

    Under a mesh the block runs tensor-parallel (``_attn_plan``; with a
    cache: when the cache's kv heads are split over "model") or
    replicated over "model" on gathered weights; a cache whose sequence
    is split (``_ACT["decode"]``) attends over its slice and combines
    across the slices.  In a sequence-split forward ``x`` is the rank's
    chunk (``positions`` its global ones): the queries stay the chunk's,
    the keys and values are gathered over "model"
    (``_attend_seq_split``)."""
    if cache is None and seq_split():
        return _attend_seq_split(module_full(p), cfg, x, positions, impl)
    lay = _ACT["decode"] if cache is not None else None
    plan = None
    if _mesh_on():
        plan = _attn_plan(p, cfg)
        if lay is not None and not lay["heads_sharded"]:
            plan = None
        if plan is None:
            p = module_full(p)
    if plan is not None:
        mg = group(("model",))
        w = _tp_weights(p, cfg, plan)
        q, k, v = _qkv(w, cfg, C.copy_to_partials(x, mg), positions,
                       plan[0], plan[2] - plan[1])
    else:
        w = p
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
        seq = lay["seq_grp"] if lay is not None else None
        off = seq.index * ck.shape[2] if seq is not None else 0
        _write_cache(ck, cv, k, v, cache_pos, off)
        kv_valid = cache_pos + s
        if impl == "kde" and s == 1:
            kc = kde_cfg or {}
            kw = dict(top_p=kc.get("top_p", 16), bk=kc.get("bk", 512),
                      stride=kc.get("stride", 16))
            o = None
            if seq is not None:
                o = _kde_decode_seq_sharded(q, ck, cv, kv_valid, grp=seq,
                                            **kw)
                if o is None:     # indivisible: the whole cache, counted
                    ck, cv = (C.all_gather(t, seq, 2) for t in (ck, cv))
            if o is None:
                o = kde_decode_attention(q, ck, cv, kv_valid, **kw)
        elif seq is not None:
            o = _xla_decode_seq_sharded(q, ck, cv, cache_pos, kv_valid,
                                        off, seq)
        else:
            o = xla_attention(q, ck, cv, causal=True, q_offset=cache_pos,
                              kv_valid=kv_valid)
    out = _merge_heads(o) @ w.wo.to(x.dtype)
    if plan is not None:
        out = C.sum_to_replicas(out, group(("model",)))
    return out, cache


def _attend_seq_split(p: Attention, cfg: ArchConfig, x, positions,
                      impl: str):
    """Causal attention of the rank's chunk of a sequence split over
    "model": the chunk's q, k, v on the gathered weights ``p``, k and v
    all-gathered over "model" (the gather's backward sums the ranks'
    gradients and keeps the chunk), then attention at the chunk's first
    global position -- the flash kernel (``flash_at``) or the xla forms
    at ``q_offset``, chunked from ``CHUNKED_ATTN_THRESHOLD`` global
    positions on, as the whole sequence would pick.  Returns (out, None)."""
    mg = group(("model",))
    q, k, v = _qkv(p, cfg, x, positions)
    k, v = C.gather_partial(k, mg, 2), C.gather_partial(v, mg, 2)
    off = mg.index * q.shape[2]
    if impl == "flash":
        from repro_torch.kernels.flash_attention.ops import flash_at
        o = flash_at(q, k, v, off)
    elif k.shape[2] >= CHUNKED_ATTN_THRESHOLD:
        o = xla_attention_chunked(q, k, v, causal=True, q_offset=off)
    else:
        o = xla_attention(q, k, v, causal=True, q_offset=off)
    return _merge_heads(o) @ p.wo.to(x.dtype), None


def _xla_decode_seq_sharded(q, ck, cv, cache_pos: int, kv_valid: int,
                            off: int, grp):
    """``xla_attention`` over a cache whose sequence is split across
    ``grp``: this rank's slice holds global positions [off, off + S_l).
    Each rank scores its keys, and the slices combine by the flash-decode
    logsumexp rule: one max all-reduce of the rows' maxima m, then sum
    all-reduces of l = sum exp(s - m) and of the unnormalised outputs."""
    b, hq, sq, hd = q.shape
    g = hq // ck.shape[1]
    kk = torch.repeat_interleave(ck.float(), g, dim=1)
    vv = torch.repeat_interleave(cv.float(), g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / (hd ** 0.5)
    kpos = off + torch.arange(ck.shape[2], device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None] + cache_pos
    mask = (kpos[None, :] < kv_valid) & (kpos[None, :] <= qpos)
    s = torch.where(mask[None, None], s, _NEG_INF)
    m = C.pmax(torch.amax(s, dim=-1), grp)
    p = torch.exp(s - m[..., None])
    l = C.all_reduce(p.sum(-1), grp)
    o = C.all_reduce(torch.einsum("bhqk,bhkd->bhqd", p, vv), grp)
    return (o / l[..., None]).to(q.dtype)


def _kde_decode_seq_sharded(q, k, v, kv_valid: int, top_p: int, bk: int,
                            stride: int, grp):
    """The reference's four shard_map steps on this rank's cache slice:
    ``k`` / ``v`` (b, hkv_l, S_l, hd) hold global positions [index S_l,
    (index + 1) S_l) of a sequence split over ``grp``; q (b, hq_l, 1, hd)
    the same heads' queries.  Returns None when S_l is not a whole number
    of blocks (the reference's ``s_total % (bk nshards) != 0``)."""
    b, hq_l, _, hd = q.shape
    hkv_l, s_loc = k.shape[1], k.shape[2]
    if s_loc % bk:
        return None
    g_l = hq_l // hkv_l
    nb_loc = s_loc // bk
    seq_off = grp.index * s_loc
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    q32 = q[:, :, 0, :].float()                               # (b, hq_l, hd)
    # (1) local strided block-lse estimates
    ks = torch.repeat_interleave(k[:, :, ::stride, :].float(), g_l, dim=1)
    sc = torch.einsum("bhd,bhsd->bhs", q32, ks) * scale
    pos = seq_off + torch.arange(0, s_loc, stride, device=dev)
    sc = torch.where(pos[None, None, :] < kv_valid, sc, _NEG_INF)
    sc = sc.reshape(b, hq_l, nb_loc, -1)
    mloc = torch.amax(sc, dim=-1)
    lse_loc = mloc + torch.log(torch.clamp(
        torch.sum(torch.exp(sc - mloc[..., None]), -1), min=1e-30)) \
        + math.log(float(stride))
    # (2) the global lse table (tiny) + top-P selection per kv head
    lse = C.all_gather(lse_loc, grp, 2)                      # (b, hq_l, nb)
    e = lse.reshape(b, hkv_l, g_l, -1)
    m_g = torch.amax(e, dim=2)
    lse_kv = m_g + torch.log(torch.clamp(
        torch.sum(torch.exp(e - m_g[:, :, None]), 2), min=1e-30))
    sel = _top_k(lse_kv, top_p)[1]                           # (b, hkv_l, P)
    # (3) exact attention over the selected blocks this rank owns
    my_first = seq_off // bk
    sel_local = sel - my_first
    owned = (sel_local >= 0) & (sel_local < nb_loc)
    sel_c = torch.clamp(sel_local, 0, nb_loc - 1)
    kb = k.reshape(b, hkv_l, nb_loc, bk, hd)
    vb = v.reshape(b, hkv_l, nb_loc, bk, hd)
    idx = sel_c[:, :, :, None, None].expand(-1, -1, -1, bk, hd)
    ksel = torch.repeat_interleave(torch.gather(kb, 2, idx).float(), g_l, 1)
    vsel = torch.repeat_interleave(torch.gather(vb, 2, idx).float(), g_l, 1)
    sc2 = torch.einsum("bhd,bhpkd->bhpk", q32, ksel) * scale
    kpos = (seq_off + sel_c[:, :, :, None] * bk
            + torch.arange(bk, device=dev)[None, None, None, :])
    valid = (kpos < kv_valid) & owned[..., None]
    valid = torch.repeat_interleave(valid, g_l, dim=1)
    sc2 = torch.where(valid, sc2, _NEG_INF)
    # (4) combine with a fixed global reference (pmax) + psums
    m_ref = C.pmax(torch.amax(sc2, dim=(2, 3)), grp)          # (b, hq_l)
    p = torch.exp(sc2 - m_ref[..., None, None])
    l_loc = p.sum((2, 3))
    acc_loc = torch.einsum("bhpk,bhpkd->bhd", p, vsel)
    # residual: local unselected blocks' estimated mass
    sel_q = torch.repeat_interleave(sel, g_l, dim=1) - my_first
    chosen = torch.any(torch.arange(nb_loc, device=dev)[None, None, :, None]
                       == sel_q[:, :, None, :], dim=-1)
    resid_loc = torch.where(chosen, 0.0,
                            torch.exp(lse_loc - m_ref[..., None])).sum(-1)
    l = C.all_reduce(l_loc, grp)
    acc = C.all_reduce(acc_loc, grp)
    resid = C.all_reduce(resid_loc, grp)
    out = acc / torch.clamp(l + resid, min=1e-30)[..., None]
    return out[:, :, None, :].to(q.dtype)


def kde_decode_attention_shardmap(q, k, v, kv_valid, top_p: int, bk: int,
                                  stride: int, mesh, baxes, *,
                                  num_kv_heads: int):
    """Distributed KDE decode attention: the reference's shard_map program
    as an SPMD one.  The GSPMD mirror's weakness: the top-P block gather
    over a sequence-sharded cache moves the whole cache every layer.  Here
    each rank
      1. computes strided block-lse estimates for its LOCAL cache slice,
      2. all-gathers only the (b, hq, nb) lse table,
      3. attends exactly over the selected blocks it OWNS,
      4. combines numerator / denominator (+ the estimated residual mass)
         with one max all-reduce and three sum all-reduces.

    q (b, hq_l, 1, hd), k, v (b, hkv_l, S_l, hd) are this rank's slices of
    the reference's global operands: the kv heads over "model" when the
    ``num_kv_heads`` divide it, the sequence over ``seq_axes = baxes (+
    'model' when kv heads don't shard)``.  Returns None when the global
    length does not split into whole blocks a shard (the caller then
    gathers the cache and runs the fused decode)."""
    msize = mesh_shape(mesh).get("model", 1)
    heads_sharded = msize > 1 and num_kv_heads % msize == 0 \
        and num_kv_heads >= msize
    seq_axes = tuple(baxes) if heads_sharded else tuple(baxes) + ("model",)
    return _kde_decode_seq_sharded(q, k, v, kv_valid, top_p, bk, stride,
                                   C.mesh_group(mesh, seq_axes))


def cross_attention_block(p: Attention, cfg: ArchConfig, x, memory):
    """Encoder-decoder cross attention (no RoPE, no bias, no mask): queries
    from x, keys and values from ``memory`` (b, s_enc, d).  A memory of
    another dtype than x is promoted as the reference's matmul promotes
    it."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = module_full(p)
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
    """silu(x w1) * (x w3) @ w2.  Under a mesh: tensor-parallel over
    "model" when d_ff divides it (w1 / w3 column-parallel, w2
    row-parallel, one all-reduce), else replicated on gathered weights;
    under seq_mode always on gathered weights (the rank's rows of a
    sequence-split forward)."""
    mg = group(("model",))
    if mg is not None and not _ACT["seq_mode"] and model_sharded(p.w1, 1) \
            and model_sharded(p.w3, 1) and model_sharded(p.w2, 0):
        xin = C.copy_to_partials(x, mg)
        h = silu(xin @ local(p.w1, 1).to(x.dtype)) \
            * (xin @ local(p.w3, 1).to(x.dtype))
        return C.sum_to_replicas(h @ local(p.w2, 0).to(x.dtype), mg)
    p = module_full(p)
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
    """Top-k MoE dispatcher, the reference's: expert parallelism
    (``_moe_block_shardmap``: one output all-reduce over "model" a layer)
    under a mesh whose "model" axis divides the experts while the batch
    is split over the batch axes, else the grouped capacity dispatch
    (``_moe_block_gspmd``; replicated over "model" on gathered weights
    under a mesh).  The capacity and the drop order are functions of the
    whole sequence, so a sequence-split forward gathers it over "model",
    dispatches and keeps its chunk; the aux loss, computed whole on every
    rank, then counts once (``grad_share``).  Returns (out (b, s, d),
    aux)."""
    mesh = _ACT["mesh"]
    if (mesh is not None and "model" in mesh_shape(mesh)
            and cfg.num_experts % mesh_shape(mesh)["model"] == 0
            and not _ACT["seq_mode"] and _ACT["batch_sharded"]):
        return _moe_block_shardmap(p, cfg, x, mesh, _ACT["batch_axes"],
                                   capacity_factor)
    y, aux = _moe_block_gspmd(module_full(p), cfg, seq_whole(x),
                              capacity_factor)
    if seq_split():
        y, aux = seq_own(y), C.grad_share(aux, group(("model",)))
    return y, aux


def _moe_block_shardmap(p: MoE, cfg: ArchConfig, x, mesh, baxes,
                        capacity_factor: float = 1.25):
    """Expert-parallel MoE: each "model" rank owns e / msize experts,
    routes its batch shard's tokens (replicated over "model") to its own
    experts only, and the outputs combine with ONE all-reduce of (b_loc,
    s, d).  The router columns are all-gathered over "model"; capacity
    slots are counted per local batch row, as the grouped dispatch counts
    them.  The aux loss takes its token and probability fractions' means
    over the batch axes before the product (it is nonlinear in the
    per-shard means); each "model" rank sums its own experts' terms and
    one all-reduce adds them, so the gradient reaches the router once."""
    e, topk = cfg.num_experts, cfg.experts_per_token
    mg = group(("model",))
    msize = mg.size
    e_loc = e // msize
    bl, s, d = x.shape
    cap = max(int(capacity_factor * s * topk / e), 1)
    xin = C.copy_to_partials(x, mg)
    router = C.gather_partial(local(p.router, 1).float(), mg, 1) \
        if model_sharded(p.router, 1) and msize > 1 \
        else full(p.router, model_partial=True).float()
    w1, w3, w2 = (local(w, 0) for w in (p.w1, p.w3, p.w2))
    logits = xin.float() @ router                          # (bl, s, e)
    gates, idx = _top_k(logits, topk)
    gates = torch.softmax(gates, dim=-1)
    eid = idx.reshape(bl, s * topk)
    gate = gates.reshape(bl, s * topk).to(x.dtype)
    onehot = _one_hot(eid, e, torch.int32)
    slot = (torch.cumsum(onehot, dim=1) * onehot).amax(-1) - 1
    keep = (slot >= 0) & (slot < cap)
    off = mg.index * e_loc
    el = eid - off
    mine = keep & (el >= 0) & (el < e_loc)
    el_c = torch.clamp(el, 0, e_loc - 1)
    slot_c = torch.clamp(slot, 0, cap - 1)
    x_rep = torch.repeat_interleave(xin, topk, dim=1)
    grp = torch.arange(bl, device=x.device)[:, None].expand(bl, s * topk)
    buf = torch.zeros((bl, e_loc, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((grp, el_c, slot_c), x_rep * mine[..., None].to(
        x.dtype), accumulate=True)                          # (bl,e_loc,cap,d)
    h = silu(torch.einsum("becd,edf->becf", buf, w1.to(x.dtype)))
    h = h * torch.einsum("becd,edf->becf", buf, w3.to(x.dtype))
    yb = torch.einsum("becf,efd->becd", h, w2.to(x.dtype))
    y = yb[grp, el_c, slot_c] * (mine.to(x.dtype) * gate)[..., None]
    y = C.sum_to_replicas(y.reshape(bl, s, topk, d).sum(2), mg)  # THE combine
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = torch.mean(_one_hot(idx[..., 0], e, torch.float32),
                             dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1)).float()
    bg = group(baxes)
    if bg is not None:
        both = C.psum(torch.stack([frac_tokens, frac_probs]), bg) / bg.size
        frac_tokens, frac_probs = both[0].detach(), both[1]
    mine_e = slice(off, off + e_loc)
    aux = C.sum_to_replicas(e * torch.sum(frac_tokens[mine_e]
                                          * frac_probs[mine_e]), mg)
    return y, aux


def _moe_block_gspmd(p: MoE, cfg: ArchConfig, x,
                     capacity_factor: float = 1.25):
    """Top-k MoE by grouped capacity dispatch: the reference's
    ``_moe_block_gspmd``.

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
    # a decode step drops the aux: no reduction for it
    bg = group(_ACT["batch_axes"]) \
        if _ACT["batch_sharded"] and _ACT["decode"] is None else None
    return y, _load_balance_loss(logits, idx, e, bg)


def _load_balance_loss(logits, idx, e, bg=None):
    """Switch-style aux loss: e * sum_i f_i * p_i.  With ``bg`` (the batch
    axes' group of a batch split over them) the fractions are the global
    batch's, their means taken over ``bg`` before the product, as
    ``_moe_block_shardmap`` takes them."""
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = torch.mean(_one_hot(idx[..., 0], e, torch.float32),
                             dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1)).float()
    if bg is not None:
        both = C.psum(torch.stack([frac_tokens, frac_probs]), bg) / bg.size
        frac_tokens, frac_probs = both[0].detach(), both[1]
    return e * torch.sum(frac_tokens * frac_probs)
