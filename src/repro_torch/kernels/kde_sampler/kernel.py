"""Bindings of the masked block-sum and sample-block CUDA kernels
(``csrc/kde_sampler.cu``), with their plain PyTorch versions.

``masked_blocksum_cuda`` / ``sample_block_cuda`` launch the kernels on
CUDA tensors and count each launch in ``LAUNCHES``.  A sample-block call is
one launch: the masked sums and the Gumbel-max draw of a query tile run in
one kernel (the tile's last CTA to finish its sums draws).
``masked_blocksum_plain`` / ``sample_block_plain`` compute the same
functions with plain torch ops.

``sample_block_plan`` is the host-side plan of both kernels: which instance
a shape runs (the wide 128-row tile where the rows allow 16-byte copies,
the generic 64-row tile elsewhere) and how many query tiles it has; it
refuses what the kernel does not take.  Each wrapper validates a call's
operands once per (shapes, dtypes, devices, layout, kernel arguments) and
keeps the launch's static arguments as a ``build.KdeTileShape``.
``precision="bf16"`` launches the bf16 instances (``kde_rowsum.kernel``'s
kind ids and exp table), counted under ``<name>_bf16``: the tensor-core
tile where the wide tile's conditions hold, the generic tile elsewhere.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.kde_rowsum.kernel import (check_operand, check_qx,
                                                   exp_table_ptr, kind_args,
                                                   launch_key, stream_of)
from repro_torch.kernels.kde_sampler.ref import (argmax_draw,
                                                 masked_exact_sums_ref)

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES = {"masked_blocksum": 0, "sample_block": 0,
            "masked_blocksum_bf16": 0, "sample_block_bf16": 0}

WIDE_BM, GENERIC_BM = 128, 64      # query rows per tile of each instance
MAX_WIDE_D = 32
MAX_TILES = 65535                  # query tiles are the grid's y axis
_INT_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


#: ``KdeTileShape::instance`` of the bf16 tensor-core tile is MMA + 16 or
#: MMA + 32 (``kde::MMA``, the padded d)
MMA = 64


class TilePlan(NamedTuple):
    instance: int   # 0: generic tile; 16 / 32: wide tile, d padded to it;
    #                 MMA + 16 / MMA + 32: the bf16 tensor-core tile
    bm: int         # query rows per tile
    tiles: int      # query tiles (one arrival counter each)
    nb: int         # level-1 blocks
    group: int      # consecutive level-1 blocks a CTA sums


def sample_block_plan(m: int, n: int, d: int, bn: int,
                      aligned: bool = True, sms: int = 132,
                      precision: str = "f32") -> TilePlan:
    """The instance an (m, n, d, bn) call of either sampler kernel runs:
    the wide tile when d % 4 == 0, d <= 32 and q and x start on 16 bytes
    (``aligned``), its tensor-core twin (``MMA`` + the padded d) under the
    same conditions at ``precision="bf16"``, else the generic tile; and
    the level-1 blocks a CTA sums in a row (``group_for`` on a card of
    ``sms`` SMs).  Raises ValueError for what the kernel does not take: an
    empty dataset, d or bn below 1, sizes past int32, more than 65535
    query tiles."""
    if n < 1:
        raise ValueError("empty dataset")
    if d < 1 or bn < 1:
        raise ValueError(f"width {d} and block size {bn} must be >= 1")
    if max(m, n, d) > _INT_MAX:
        raise ValueError(f"(m, n, d) = ({m}, {n}, {d}) exceed the kernel's "
                         f"int32 sizes")
    wide = aligned and d % 4 == 0 and d <= MAX_WIDE_D
    instance = (16 if d <= 16 else 32) if wide else 0
    if wide and precision == "bf16":
        instance += MMA
    bm = WIDE_BM if wide else GENERIC_BM
    tiles = -(-m // bm)
    if tiles > MAX_TILES:
        raise ValueError(f"{m} query rows make {tiles} tiles of {bm}; the "
                         f"kernel takes at most {MAX_TILES}")
    nb = -(-n // bn)
    return TilePlan(instance, bm, tiles, nb, group_for(tiles, nb, sms))


#: CTAs of 256 threads an SM holds at once (ptxas: the wide and deep tiles
#: use at most 128 registers, the generic tile with the draw 118)
CTAS_PER_SM = 2


def group_for(tiles: int, nb: int, sms: int) -> int:
    """Level-1 blocks a CTA sums: just enough that the grid fits in one
    wave of resident CTAs, so no CTA waits for a second wave and each
    stages its query tile once for all its blocks (``tools/kernel_ab.py``
    on an H100 80GB HBM3 at 700 W, edge-batch shape: group 8 0.1202 ms,
    group 1 0.1249 ms)."""
    slots = CTAS_PER_SM * sms
    return max(1, min(nb, -(-nb * tiles // slots)))


#: (TilePlan, KdeTileShape) per validated call signature
_PLANS: dict = {}
#: arrival counters per (device index, raw stream): int32 zeros, one per
#: query tile, left at 0 by every launch.  Launches on one stream never
#: overlap; launches on two streams may, so each stream has its own buffer.
_COUNTERS: dict = {}


def _plan(q, x, own, gumbel, kind, inv_bw, beta, bn, aligned, precision):
    """Check a call once; its plan and the launch's static arguments."""
    check_qx(q, x)
    m, d = q.shape
    n = x.shape[0]
    if own.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"own must be int32 or int64, got {own.dtype}")
    check_operand(own, "own", own.dtype, 1, q.device)
    if own.shape[0] != m:
        raise ValueError(f"own has {own.shape[0]} rows, q has {m}")
    plan = sample_block_plan(m, n, d, int(bn), aligned, _sms(q.device),
                             precision)
    if gumbel is not None:
        check_operand(gumbel, "gumbel", torch.float32, 2, q.device)
        if tuple(gumbel.shape) != (m, plan.nb):
            raise ValueError(f"gumbel must be ({m}, {plan.nb}), got "
                             f"{tuple(gumbel.shape)}")
    shape = _build.KdeTileShape(m, n, d, int(bn), plan.nb,
                                int(own.dtype == torch.int64), plan.instance,
                                plan.group,
                                *kind_args(kind, inv_bw, beta, precision))
    return plan, shape


def _cached_plan(q, x, own, gumbel, kind, inv_bw, beta, bn, precision):
    aligned = q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
    # (shape, strides) pins contiguity; the checks run once per key
    key = (q.shape, q.stride(), x.shape, x.stride(), own.shape, own.stride(),
           q.dtype, x.dtype, own.dtype, q.get_device(), x.get_device(),
           own.get_device(), kind, inv_bw, beta, bn, aligned, precision)
    if gumbel is not None:
        key += (gumbel.shape, gumbel.stride(), gumbel.dtype,
                gumbel.get_device())
    entry = _PLANS.get(key)
    if entry is None:
        entry = _PLANS[key] = _plan(q, x, own, gumbel, kind, inv_bw, beta,
                                    bn, aligned, precision)
    return entry


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _counters(device: torch.device, stream: int, tiles: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < tiles:
        buf = _COUNTERS[key] = torch.zeros(max(tiles, 64), dtype=torch.int32,
                                           device=device)
    return buf


def masked_blocksum_cuda(q, x, own, kind: str, inv_bw: float,
                         beta: float = 1.0, bn: int = 256,
                         precision: str = "f32"):
    """bs[i, b] = max(sum_{j in block b} k(q_i, x_j) - [own_i == b],
    1e-12) by the masked-blocksum kernel -> (m, ceil(n / bn)) f32.
    ``own`` (m,) int32 or int64 holds each query's own block (-1: none)."""
    plan, shape = _cached_plan(q, x, own, None, kind, inv_bw, beta, bn,
                               precision)
    m = q.shape[0]
    out = torch.empty((m, plan.nb), dtype=torch.float32, device=q.device)
    if m == 0:
        return out
    err = _build.library().kde_masked_blocksum_launch(
        q.data_ptr(), x.data_ptr(), own.data_ptr(), out.data_ptr(),
        exp_table_ptr(kind, precision, q.device), stream_of(q), shape)
    if err:
        _build.check(err, "kde_masked_blocksum")
    LAUNCHES[launch_key("masked_blocksum", precision)] += 1
    return out


def masked_blocksum_plain(q, x, own, kind: str, inv_bw: float,
                          beta: float = 1.0, bn: int = 256,
                          precision: str = "f32"):
    """Plain torch version of ``masked_blocksum_cuda``."""
    return masked_exact_sums_ref(q, x, torch.sum(x * x, dim=-1),
                                 own.to(q.device), kind, inv_bw, beta, bn,
                                 x.shape[0], precision=precision)


def sample_block_cuda(q, x, own, gumbel, kind: str, inv_bw: float,
                      beta: float = 1.0, bn: int = 256,
                      precision: str = "f32"):
    """Masked block sums plus the Gumbel-max block draw in one launch:
    returns (blk (m,) int64, p_blk (m,), tot (m,), bs (m, B)) with blk =
    argmax_b log(bs_b) + g_b, the first maximum on ties.  ``own`` is int32
    or int64 (read as it is, no cast)."""
    plan, shape = _cached_plan(q, x, own, gumbel, kind, inv_bw, beta, bn,
                               precision)
    m = q.shape[0]
    dev = q.device
    bs = torch.empty((m, plan.nb), dtype=torch.float32, device=dev)
    blk = torch.empty(m, dtype=torch.int64, device=dev)
    pb = torch.empty(m, dtype=torch.float32, device=dev)
    tot = torch.empty(m, dtype=torch.float32, device=dev)
    if m == 0:
        return blk, pb, tot, bs
    stream = stream_of(q)
    err = _build.library().kde_sample_block_launch(
        q.data_ptr(), x.data_ptr(), own.data_ptr(), gumbel.data_ptr(),
        bs.data_ptr(), blk.data_ptr(), pb.data_ptr(), tot.data_ptr(),
        _counters(dev, stream, plan.tiles).data_ptr(),
        exp_table_ptr(kind, precision, dev), stream, shape)
    if err:
        _build.check(err, "kde_sample_block")
    LAUNCHES[launch_key("sample_block", precision)] += 1
    return blk, pb, tot, bs


def sample_block_plain(q, x, own, gumbel, kind: str, inv_bw: float,
                       beta: float = 1.0, bn: int = 256,
                       precision: str = "f32"):
    """Plain torch version of ``sample_block_cuda``."""
    bs = masked_blocksum_plain(q, x, own, kind, inv_bw, beta, bn, precision)
    blk, pb, tot = argmax_draw(bs, gumbel)
    return blk, pb, tot, bs
