"""Binding of the fused KDE decode CUDA kernel (``csrc/kde_attention.cu``),
with its plain PyTorch version.

``kde_decode_cuda`` launches the fused decode kernel -- the reference's
whole ``kde_attention`` for one decode step and one layer -- and
``kde_decode_plain`` is its plain version, the four-step pipeline in torch
ops (``ref.kde_attention_ref``) with ``block_lse_plain``
(``ref.block_lse_ref``) as step 1: the reference's ``block_lse_pallas``,
for each (batch, q-head, key block of ``bk``), ``log(stride * sum_i exp(q .
k_i * scale))`` over the block's keys ``i = 0, stride, 2 stride, ...``, with
positions ``>= kv_valid`` at -1e30.  q is float32 or bfloat16, the cache (k
and v together) float32 or bfloat16; both compute in f32 on the upcast
values and return out in q's dtype, the estimates in f32, as the reference
casts inside its kernel and ops.  The wrapper counts its launches in
``LAUNCHES``.

A call is one launch of one of two kernels, which the plan picks by shape
(``decode_grid``): a thread-block cluster of up to 8 CTAs per (batch,
kv-head) (the serve shape), or the grid spread over every SM with global
scratch and two group barriers (batch 1 and long caches: the long_500k
cell), which the plan also takes for a cache too long for a cluster.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.kde_attention import ref as _ref
from repro_torch.kernels.kde_rowsum.kernel import stream_of

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES = {"kde_decode": 0}
MAX_HEAD_DIM = 128
#: the kernel's dtype ids (``KdeDecodeShape.q_dtype`` / ``kv_dtype``)
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(q, k, v, bk, stride):
    for name, t, nd in (("q", q, 3), ("k", k, 4), ("v", v, 4)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.dtype not in DTYPE_IDS or t.dim() != nd:
            raise ValueError(f"{name} must be a {nd}-d float32 or bfloat16 "
                             f"tensor, got {t.dim()}-d {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in the head dim")
    if v.dtype != k.dtype:
        raise ValueError(f"k and v must share a dtype, got {k.dtype} and "
                         f"{v.dtype}")
    b, hq, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % k.shape[1] != 0:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} must match k {tuple(k.shape)}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} outside [1, {MAX_HEAD_DIM}]")
    if bk < 1 or stride < 1 or k.shape[2] % bk:
        raise ValueError(f"cache length {k.shape[2]} must be a multiple of "
                         f"bk={bk} (stride {stride} >= 1)")


#: the plain versions are the reference oracles' torch mirrors, one
#: definition each (``ref.block_lse_ref``, ``ref.kde_attention_ref``)
block_lse_plain = _ref.block_lse_ref
kde_decode_plain = _ref.kde_attention_ref


#: the kernels a launch may take (``build.KdeDecodeShape.mode``)
KERNELS = {"cluster": 0, "spread": 1}
#: (static launch arguments, plan) per (shapes, strides, device indices,
#: dtypes, bk, stride, top_p, kernel), validated once
_PLANS: dict = {}
#: the spread kernel's group counters per (device index, raw stream): int32
#: zeros, left at 0 by every launch (launches on one stream never overlap)
_SYNC: dict = {}


def _decode_plan(q, k, v, bk, stride, top_p, kernel):
    """Check a kde_decode call once and return (static arguments, plan)."""
    _check(q, k, v, bk, stride)
    if top_p < 1:
        raise ValueError(f"top_p must be >= 1, got {top_p}")
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"kernel must be None or one of {sorted(KERNELS)}, "
                         f"got {kernel!r}")
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if b > 65535 or hkv > 65535:
        raise ValueError(f"batch {b} / kv heads {hkv} exceed the grid's 65535")
    shape = _build.KdeDecodeShape(
        b, hq, hkv, s, dh, int(bk), int(stride), int(top_p),
        DTYPE_IDS[q.dtype], DTYPE_IDS[k.dtype], KERNELS.get(kernel, -1),
        float(dh ** -0.5), math.log(float(stride)), *q.stride()[:2],
        *k.stride()[:3], *v.stride()[:3])
    plan = _build.KdeDecodePlan()
    rc = _build.library().kde_decode_plan(shape, plan)
    if rc < 0:
        _build.check(-rc, "kde_decode_plan")
    if rc:
        raise ValueError(
            f"kde_decode: {s // bk} key blocks of {bk} (group {hq // hkv}, "
            f"{-(-bk // stride)} strided keys a block, top_p {top_p}) do not "
            f"fit the shared memory of the {kernel or 'cluster or spread'} "
            f"kernel (the spread kernel keeps g + 2 words an own block: past "
            f"about 4.7 million keys at bk 32, group 8, batch 1, 4 kv-heads); "
            f"use a larger bk")
    return shape, plan


def plan_of(q, k, v, *, top_p: int, bk: int, stride: int, kernel=None):
    """(static arguments, plan) of a ``kde_decode_cuda`` call on these
    tensors, checked once per (shapes, strides, devices, dtypes, bk,
    stride, top_p, kernel) and cached."""
    key = (q.shape, q.stride(), k.shape, k.stride(), v.shape, v.stride(),
           q.get_device(), k.get_device(), v.get_device(), q.dtype, k.dtype,
           v.dtype, bk, stride, top_p, kernel)
    got = _PLANS.get(key)
    if got is None:
        got = _PLANS[key] = _decode_plan(q, k, v, bk, stride, top_p, kernel)
    return got


def decode_grid(q, k, v, *, top_p: int, bk: int, stride: int,
                kernel=None) -> dict:
    """The kernel a call takes (``"cluster"`` or ``"spread"``), its CTAs per
    (batch, kv-head), the CTAs of the launch and the key blocks a CTA
    estimates."""
    _, plan = plan_of(q, k, v, top_p=top_p, bk=bk, stride=stride,
                      kernel=kernel)
    groups = q.shape[0] * k.shape[1]
    return dict(kernel="spread" if plan.mode else "cluster",
                ctas_per_group=plan.ctas, ctas=plan.ctas * groups,
                blocks_per_cta=plan.blocks)


def _sync(device: torch.device, stream: int, words: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _SYNC.get(key)
    if buf is None or buf.numel() < words:
        buf = _SYNC[key] = torch.zeros(max(words, 256), dtype=torch.int32,
                                       device=device)
    return buf


def kde_decode_cuda(q, k, v, *, top_p: int, bk: int, stride: int,
                    kv_valid: int, with_est: bool = False, kernel=None):
    """out (b, hq, dh) in q's dtype by the fused KDE decode kernel, one
    launch: q (b, hq, dh) float32 or bfloat16, k / v (b, hkv, S, dh) CUDA
    tensors of one dtype, float32 or bfloat16 (strided over batch, head and
    position; S a multiple of bk).  With ``with_est`` the kernel also writes
    its step-1 estimates (b, hq, S / bk) in f32.  The plan picks the
    kernel by shape (``decode_grid``); ``kernel`` forces one.

    The decode path calls this once per layer and step, so the host side
    is kept short: a cached plan, one allocation and one ctypes call."""
    shape, plan = plan_of(q, k, v, top_p=top_p, bk=bk, stride=stride,
                          kernel=kernel)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    b, hq = q.shape[0], q.shape[1]
    n_est = b * hq * (k.shape[2] // bk)
    est = work = sync = None
    stream = stream_of(q)
    if plan.mode:
        buf = torch.empty(n_est + plan.work, dtype=torch.float32,
                          device=q.device)
        est, work = buf[:n_est], buf[n_est:].data_ptr()
        sync = _sync(q.device, stream, plan.sync).data_ptr()
    elif with_est:
        est = torch.empty(n_est, dtype=torch.float32, device=q.device)
    err = _build.library().kde_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if est is None else est.data_ptr(), work, sync, int(kv_valid),
        stream, shape)
    if err:
        _build.check(err, "kde_decode")
    LAUNCHES["kde_decode"] += 1
    return (out, est.view(b, hq, -1)) if with_est else out
