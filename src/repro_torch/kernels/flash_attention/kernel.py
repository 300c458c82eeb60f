"""Binding of the flash-attention forward CUDA kernel
(``csrc/flash_attention.cu``), with its plain PyTorch version.

``flash_attention_cuda`` launches the kernel on CUDA tensors and counts
each launch in ``LAUNCHES``; ``flash_attention_plain`` computes the same
function with plain torch ops.  ``instantiation`` names the kernel template
instance a call takes (operand type, head-dim bucket, cp.async or scalar
staging), ``BODIES`` the body each operand type runs: FP32 FMAs for f32,
the tensor cores for bf16 (``flash_bf16_model`` is a plain torch model of
that body's arithmetic, for the CPU tests; no CUDA path calls it).  Both
are the Pallas kernel
``flash_attention_pallas`` of the reference: query row r sits at position
``r + offset``, key j is valid iff ``j < kv_valid`` (and ``j <= r +
offset`` when causal), masked scores take the sentinel -1e30, and a row
with no valid key averages v over every key, as the Pallas body's
``exp(-1e30 - (-1e30)) = 1`` does.  The math is f32 for f32 and bf16
operands; ``out`` comes back in q's dtype, ``lse`` in f32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.kde_rowsum.kernel import stream_of

_NEG_INF = -1.0e30
#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES = {"flash_attention": 0}
#: operand dtypes the kernel takes (its ``dtype`` argument)
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
#: head-dim buckets the kernel is specialised on at compile time
HEAD_DIM_BUCKETS = (32, 64, 128)
#: the body each operand dtype runs, and its CUDA kernel's name
BODIES = {torch.float32: ("FMA f32", "flash_fwd_kernel"),
          torch.bfloat16: ("tensor-core bf16 (mma.sync, p = hi + lo)",
                           "flash_mma_kernel")}
#: keys a tile of the kernel; the bf16 body's online softmax rescales once
#: a tile, as ``flash_bf16_model`` does
BKV = 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.dtype != q.dtype or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-d {q.dtype} tensor, got "
                             f"{t.dim()}-d {t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in the head dim")
    if q.dtype not in DTYPE_IDS:
        raise ValueError(f"flash attention takes {sorted(map(str, DTYPE_IDS))}"
                         f" operands, got {q.dtype}")
    b, hq, _, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hq % k.shape[1] != 0:
        raise ValueError(f"q heads {hq} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} outside [1, {MAX_HEAD_DIM}]")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's 65535")


def _vec_ok(t) -> bool:
    """Every row of ``t`` starts 16-byte aligned and holds whole 16-byte
    chunks (base, batch / head / position strides and the head dim)."""
    ve = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[3] % ve == 0
            and all(st % ve == 0 for st in t.stride()[:3]))


def instantiation(q, k, v) -> str:
    """The kernel instance a call takes: operand type, head-dim bucket and
    staging -- ``cp.async`` (16-byte asynchronous copies, double-buffered)
    when every operand row is 16-byte aligned, else ``scalar`` (element
    loads into the same layout)."""
    dh = q.shape[3]
    bucket = next(b for b in HEAD_DIM_BUCKETS if dh <= b)
    staging = "cp.async" if all(map(_vec_ok, (q, k, v))) else "scalar"
    return f"{str(q.dtype)[6:]} dh<={bucket} {staging}"


def flash_attention_cuda(q, k, v, *, causal: bool, scale: float,
                         kv_valid: int, offset: int):
    """(out (b, hq, sq, dh) in q's dtype, lse (b, hq, sq) f32) by the flash
    kernel: q (b, hq, sq, dh), k / v (b, hkv, skv, dh) CUDA tensors of one
    dtype (f32 or bf16), strided over batch, head and position."""
    _check(q, k, v)
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty((b, hq, sq, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    err = _build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, hq, hkv, sq, skv, dh, int(causal), int(offset),
        int(kv_valid), float(scale), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], DTYPE_IDS[q.dtype],
        int(all(map(_vec_ok, (q, k, v)))), stream_of(q))
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_plain(q, k, v, *, causal: bool, scale: float,
                          kv_valid: int, offset: int):
    """Plain torch version of ``flash_attention_cuda``: dense f32 scores,
    one kv-head group at a time (so the (b, g, sq, skv) scores of one group
    are the largest temporary)."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    kpos = torch.arange(skv, device=dev)[None, :]
    mask = kpos < kv_valid
    if causal:
        qpos = torch.arange(sq, device=dev)[:, None] + offset
        mask = mask & (kpos <= qpos)
    outs, lses = [], []
    for h in range(hkv):
        qh = q[:, h * g:(h + 1) * g].float()
        s = torch.matmul(qh, k[:, h:h + 1].float().transpose(-1, -2)) * scale
        s = torch.where(mask, s, _NEG_INF)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = torch.sum(p, dim=-1, keepdim=True)
        safe = torch.clamp(l, min=1e-30)
        outs.append(torch.matmul(p, v[:, h:h + 1].float()) / safe)
        lses.append(torch.where(l > 0, m + torch.log(safe), _NEG_INF)[..., 0])
    return torch.cat(outs, dim=1).to(q.dtype), torch.cat(lses, dim=1)


def split_bf16(p):
    """(hi, lo) of f32 ``p`` as the bf16 body splits it for its PV
    products: hi = bf16(p), lo = bf16(p - hi) (the difference is exact in
    f32), both returned as f32; hi + lo is p to about 2^-17 relative."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def flash_bf16_model(q, k, v, *, causal: bool, scale: float, kv_valid: int,
                     offset: int):
    """Plain torch model of the bf16 tensor-core body's arithmetic (the CPU
    tests hold it to the reference; no CUDA path calls it): key tiles of
    ``BKV``, scores as exact bf16 products summed in f32, masks, an online
    softmax in f32 rescaled once a tile, p split into bf16 hi + lo and PV
    as the two products summed in f32 on the f32 accumulators, l the sum
    of the f32 p; out rounded once to bf16.  Arguments as
    ``flash_attention_cuda``'s."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    qf = q.float()
    qpos = torch.arange(sq)[:, None] + offset
    m = torch.full((b, hq, sq), _NEG_INF)
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, dh))
    for kt in range(0, skv, BKV):
        ks, vs = kf[:, :, kt:kt + BKV], vf[:, :, kt:kt + BKV]
        s = torch.matmul(qf, ks.transpose(-1, -2)) * scale
        kpos = torch.arange(kt, kt + ks.shape[2])[None, :]
        mask = kpos < kv_valid
        if causal:
            mask = mask & (kpos <= qpos)
        s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        hi, lo = split_bf16(p)
        acc = acc * alpha[..., None] + torch.matmul(hi, vs) \
            + torch.matmul(lo, vs)
        m = m_new
    safe = torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(safe), _NEG_INF)
    return (acc / safe[..., None]).to(q.dtype), lse
