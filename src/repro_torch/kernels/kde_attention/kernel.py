"""Binding of the block-lse CUDA kernel (``csrc/kde_attention.cu``), with
its plain PyTorch version.

``block_lse_cuda`` launches the kernel on CUDA tensors and counts each
launch in ``LAUNCHES``; ``block_lse_plain`` computes the same function with
plain torch ops.  Both are the reference's ``block_lse_pallas``: for each
(batch, q-head, key block of ``bk``), ``log(stride * sum_i exp(q . k_i *
scale))`` over the block's keys ``i = 0, stride, 2 stride, ...``, with
positions ``>= kv_valid`` at -1e30.  f32 only: the LM slice runs f32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.kde_rowsum.kernel import stream_of

_NEG_INF = -1.0e30
#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES = {"block_lse": 0}
MAX_HEAD_DIM = 128
#: the kernel parks a CTA's scores in static-size shared memory: at most
#: 8 warps x ceil(bk / stride) floats in 48 KB
MAX_STRIDED_KEYS = 48 * 1024 // (8 * 4)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(q, k, bk, stride):
    for name, t, nd in (("q", q, 3), ("k", k, 4)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.dtype != torch.float32 or t.dim() != nd:
            raise ValueError(f"{name} must be a {nd}-d float32 tensor, got "
                             f"{t.dim()}-d {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in the head dim")
    b, hq, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % k.shape[1] != 0:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} outside [1, {MAX_HEAD_DIM}]")
    if bk < 1 or stride < 1 or k.shape[2] % bk:
        raise ValueError(f"cache length {k.shape[2]} must be a multiple of "
                         f"bk={bk} (stride {stride} >= 1)")
    if -(-bk // stride) > MAX_STRIDED_KEYS:
        raise ValueError(f"bk / stride = {-(-bk // stride)} strided keys per "
                         f"block exceed {MAX_STRIDED_KEYS}")


def block_lse_cuda(q, k, *, scale: float, stride: int, kv_valid: int,
                   bk: int):
    """(b, hq, S / bk) f32 block estimates by the block-lse kernel: q (b,
    hq, dh) and k (b, hkv, S, dh) f32 CUDA tensors (strided over batch,
    head and position; S a multiple of bk)."""
    _check(q, k, bk, stride)
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    nb = s // bk
    out = torch.empty((b, hq, nb), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    err = _build.library().kde_block_lse_launch(
        q.data_ptr(), k.data_ptr(), out.data_ptr(), b, hq, hkv, nb, dh,
        int(bk), int(stride), int(kv_valid), float(scale),
        math.log(float(stride)), *q.stride()[:2], *k.stride()[:3],
        stream_of(q))
    _build.check(err, "kde_block_lse")
    LAUNCHES["block_lse"] += 1
    return out


def block_lse_plain(q, k, *, scale: float, stride: int, kv_valid: int,
                    bk: int):
    """Plain torch version of ``block_lse_cuda``: the strided keys only,
    each GQA group's q-heads against its kv-head."""
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    nb = s // bk
    ks = k.reshape(b, hkv, nb, bk, dh)[:, :, :, ::stride].float()
    qg = q.reshape(b, hkv, hq // hkv, dh).float()
    sc = torch.einsum("bhgd,bhnid->bhgni", qg, ks) * scale
    pos = (torch.arange(nb, device=q.device)[:, None] * bk
           + torch.arange(0, bk, stride, device=q.device)[None, :])
    sc = torch.where(pos < kv_valid, sc, _NEG_INF)
    m = torch.amax(sc, dim=-1)
    lse = m + torch.log(torch.clamp(
        torch.sum(torch.exp(sc - m[..., None]), dim=-1), min=1e-30))
    return (lse + math.log(float(stride))).reshape(b, hq, nb)
