"""Bindings of the exact row-sum and block-sum CUDA kernels
(``csrc/kde_rowsum.cu``), with their plain PyTorch versions.

``rowsum_cuda`` / ``blocksum_cuda`` launch the kernels on CUDA tensors
and count each launch in ``LAUNCHES``; ``rowsum_plain`` /
``blocksum_plain`` compute the same functions with plain torch ops (the
CPU path, and the yardstick the kernels are checked against on the card).
Kernel kinds and bandwidths are runtime arguments; the tile sizes are
constants of ``csrc/kde_tile.cuh``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.kde_rowsum.ref import kernel_values

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES = {"rowsum": 0, "blocksum": 0}

#: ``enum Kind`` of csrc/kde_tile.cuh
KIND_IDS = {"gaussian": 0, "exponential": 1, "rational_quadratic": 2,
            "laplacian": 3}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kind_args(kind: str, inv_bw: float, beta: float):
    """(kind id, inv_bw, inv_bw^2, beta) as the C launchers take them;
    inv_bw^2 is rounded once from the double product, as the reference's
    ``inv_bw * inv_bw`` static."""
    if kind not in KIND_IDS:
        raise ValueError(f"no CUDA kernel for kernel kind {kind!r}; "
                         f"built-in kinds are {sorted(KIND_IDS)}")
    return KIND_IDS[kind], float(inv_bw), float(inv_bw * inv_bw), float(beta)


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
                  device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype
    and rank on ``device``."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                         f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_qx(q: torch.Tensor, x: torch.Tensor) -> None:
    check_operand(q, "q", torch.float32, 2, q.device)
    check_operand(x, "x", torch.float32, 2, q.device)
    if q.shape[1] != x.shape[1]:
        raise ValueError(f"q and x widths differ: {q.shape[1]} vs "
                         f"{x.shape[1]}")
    if x.shape[0] == 0:
        raise ValueError("empty dataset")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of ``t``'s device (the
    same value as ``torch.cuda.current_stream(t.device).cuda_stream``
    without building a Stream object: a launch pays for this on the host)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def rowsum_cuda(q, x, kind: str, inv_bw: float, beta: float = 1.0):
    """out[i] = sum_j k(q_i, x_j) by the rowsum kernel: q (m, d), x (n, d)
    contiguous f32 CUDA tensors -> (m,) f32."""
    check_qx(q, x)
    m, d = q.shape
    n = x.shape[0]
    out = torch.empty(m, dtype=torch.float32, device=q.device)
    if m == 0:
        return out
    lib = _build.library()
    partial = torch.empty((m, lib.kde_rowsum_splits(m, n)),
                          dtype=torch.float32, device=q.device)
    err = lib.kde_rowsum_launch(q.data_ptr(), x.data_ptr(),
                                partial.data_ptr(), out.data_ptr(), m, n, d,
                                *kind_args(kind, inv_bw, beta), stream_of(q))
    _build.check(err, "kde_rowsum")
    LAUNCHES["rowsum"] += 1
    return out


def rowsum_plain(q, x, kind: str, inv_bw: float, beta: float = 1.0):
    """Plain torch version of ``rowsum_cuda``."""
    return torch.sum(kernel_values(q, x, kind, inv_bw, beta), dim=1)


def blocksum_cuda(q, x, kind: str, inv_bw: float, beta: float = 1.0,
                  bn: int = 256):
    """out[i, b] = sum_{j in block b} k(q_i, x_j) by the blocksum kernel:
    blocks of ``bn`` consecutive rows of x, the last one ragged ->
    (m, ceil(n / bn)) f32."""
    check_qx(q, x)
    m, d = q.shape
    n = x.shape[0]
    nb = -(-n // bn)
    out = torch.empty((m, nb), dtype=torch.float32, device=q.device)
    if m == 0:
        return out
    err = _build.library().kde_blocksum_launch(
        q.data_ptr(), x.data_ptr(), out.data_ptr(), m, n, d, int(bn), nb,
        *kind_args(kind, inv_bw, beta), stream_of(q))
    _build.check(err, "kde_blocksum")
    LAUNCHES["blocksum"] += 1
    return out


def blocksum_plain(q, x, kind: str, inv_bw: float, beta: float = 1.0,
                   bn: int = 256):
    """Plain torch version of ``blocksum_cuda``: the (m, n) values,
    zero-padded to a block multiple, summed per block."""
    kv = kernel_values(q, x, kind, inv_bw, beta)
    pad = -kv.shape[1] % bn
    if pad:
        kv = torch.nn.functional.pad(kv, (0, pad))
    return kv.reshape(kv.shape[0], -1, bn).sum(-1)
