"""Bindings of the masked block-sum and sample-block CUDA kernels
(``csrc/kde_sampler.cu``), with their plain PyTorch versions.

``masked_blocksum_cuda`` / ``sample_block_cuda`` launch the kernels on
CUDA tensors and count each call in ``LAUNCHES`` (a sample-block call is
one count: its two launches -- the masked sums, then the per-row
Gumbel-max draw -- are together the port of one TPU kernel).
``masked_blocksum_plain`` / ``sample_block_plain`` compute the same
functions with plain torch ops.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.kde_rowsum.kernel import (check_operand, check_qx,
                                                   kind_args, stream_of)
from repro_torch.kernels.kde_sampler.ref import (argmax_draw,
                                                 masked_exact_sums_ref)

#: kernel calls per wrapper since the last ``reset_launches()``
LAUNCHES = {"masked_blocksum": 0, "sample_block": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _own_operand(own: torch.Tensor, m: int, device) -> torch.Tensor:
    own = own.to(device=device, dtype=torch.int32).contiguous()
    check_operand(own, "own", torch.int32, 1, device)
    if own.shape[0] != m:
        raise ValueError(f"own has {own.shape[0]} rows, q has {m}")
    return own


def masked_blocksum_cuda(q, x, own, kind: str, inv_bw: float,
                         beta: float = 1.0, bn: int = 256):
    """bs[i, b] = max(sum_{j in block b} k(q_i, x_j) - [own_i == b],
    1e-12) by the masked-blocksum kernel -> (m, ceil(n / bn)) f32.
    ``own`` (m,) holds each query's own block (-1: none)."""
    check_qx(q, x)
    m, d = q.shape
    n = x.shape[0]
    nb = -(-n // bn)
    own = _own_operand(own, m, q.device)
    out = torch.empty((m, nb), dtype=torch.float32, device=q.device)
    if m == 0:
        return out
    err = _build.library().kde_masked_blocksum_launch(
        q.data_ptr(), x.data_ptr(), own.data_ptr(), out.data_ptr(), m, n, d,
        int(bn), nb, *kind_args(kind, inv_bw, beta), stream_of(q))
    _build.check(err, "kde_masked_blocksum")
    LAUNCHES["masked_blocksum"] += 1
    return out


def masked_blocksum_plain(q, x, own, kind: str, inv_bw: float,
                          beta: float = 1.0, bn: int = 256):
    """Plain torch version of ``masked_blocksum_cuda``."""
    return masked_exact_sums_ref(q, x, torch.sum(x * x, dim=-1),
                                 own.to(q.device), kind, inv_bw, beta, bn,
                                 x.shape[0])


def sample_block_cuda(q, x, own, gumbel, kind: str, inv_bw: float,
                      beta: float = 1.0, bn: int = 256):
    """Masked block sums plus the Gumbel-max block draw: returns (blk (m,)
    int64, p_blk (m,), tot (m,), bs (m, B)) with blk = argmax_b log(bs_b)
    + g_b, the first maximum on ties."""
    check_qx(q, x)
    m, d = q.shape
    n = x.shape[0]
    nb = -(-n // bn)
    own = _own_operand(own, m, q.device)
    check_operand(gumbel, "gumbel", torch.float32, 2, q.device)
    if tuple(gumbel.shape) != (m, nb):
        raise ValueError(f"gumbel must be ({m}, {nb}), got "
                         f"{tuple(gumbel.shape)}")
    dev = q.device
    bs = torch.empty((m, nb), dtype=torch.float32, device=dev)
    blk = torch.empty(m, dtype=torch.int32, device=dev)
    pb = torch.empty(m, dtype=torch.float32, device=dev)
    tot = torch.empty(m, dtype=torch.float32, device=dev)
    if m == 0:
        return blk.long(), pb, tot, bs
    err = _build.library().kde_sample_block_launch(
        q.data_ptr(), x.data_ptr(), own.data_ptr(), gumbel.data_ptr(),
        bs.data_ptr(), blk.data_ptr(), pb.data_ptr(), tot.data_ptr(), m, n,
        d, int(bn), nb, *kind_args(kind, inv_bw, beta), stream_of(q))
    _build.check(err, "kde_sample_block")
    LAUNCHES["sample_block"] += 1
    return blk.long(), pb, tot, bs


def sample_block_plain(q, x, own, gumbel, kind: str, inv_bw: float,
                       beta: float = 1.0, bn: int = 256):
    """Plain torch version of ``sample_block_cuda``."""
    bs = masked_blocksum_plain(q, x, own, kind, inv_bw, beta, bn)
    blk, pb, tot = argmax_draw(bs, gumbel)
    return blk, pb, tot, bs
