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

The tenant axis (``tile_base=``, DESIGN.md §13): ``x`` is then the stacked
arena (T, n, d) of T datasets of n rows and ``tile_base`` (tiles,) int32
holds each query tile's arena row offset (a multiple of n); the query rows
come ordered by tenant, each tenant's run padded to whole tiles of the
plan's ``bm`` (``tenant_layout``).  One launch serves every tenant; ``own``
stays tenant-relative.  The f32 instances only (a bf16 call with
``tile_base`` raises ValueError).  The kernels read the offsets unchecked
(checking them would cost a host read a call): build them with
``tenant_layout``.  The plain versions take the same operands.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import tuning
from repro_torch.kernels.kde_rowsum.kernel import (check_operand, check_qx,
                                                   exp_table_ptr, kind_args,
                                                   launch_key, stream_of)
from repro_torch.kernels.kde_sampler.ref import (argmax_draw,
                                                 masked_exact_sums_ref)

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES = {"masked_blocksum": 0, "sample_block": 0,
            "masked_blocksum_bf16": 0, "sample_block_bf16": 0}

# query rows per tile of each instance, the wide tiles' widest d and the
# CTAs an SM the plans size their grids for: ``tuning``'s
WIDE_BM, GENERIC_BM = tuning.WIDE_BM, tuning.GENERIC_BM
MAX_WIDE_D = tuning.MAX_WIDE_D
CTAS_PER_SM = tuning.CTAS_PER_SM
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


def group_for(tiles: int, nb: int, sms: int) -> int:
    """Level-1 blocks a CTA sums: just enough that the grid fits in one
    wave of resident CTAs, so no CTA waits for a second wave and each
    stages its query tile once for all its blocks (``tools/kernel_ab.py``
    on an H100 80GB HBM3 at 700 W, edge-batch shape: group 8 0.1202 ms,
    group 1 0.1249 ms).  The resident CTAs are ``tuning.CTAS_PER_SM`` an
    SM, the least any sampler or 128-row blocksum instance holds."""
    slots = CTAS_PER_SM * sms
    return max(1, min(nb, -(-nb * tiles // slots)))


def tenant_layout(tenants, n: int, bm: int):
    """The tenant axis's row order, host-side: ``tenants`` (rows,) the
    tenant index of each query row.  Rows are ordered by tenant (stably)
    and each tenant's run is padded to whole tiles of ``bm`` by repeating
    its first row.  Returns ``(pos (M,) int64: the query row each padded
    row copies, tile_base (M / bm,) int32: each tile's arena row offset
    tenant * n, inv (rows,) int64: the padded row of each query row)``."""
    t = np.asarray(tenants, np.int64).reshape(-1)
    order = np.argsort(t, kind="stable")
    pos, base = [], []
    inv = np.empty(len(t), np.int64)
    for ti in np.unique(t):
        run = order[t[order] == ti]
        pad = -len(run) % bm
        inv[run] = len(pos) + np.arange(len(run))
        pos.extend(run.tolist() + [int(run[0])] * pad)
        base.extend([int(ti) * int(n)] * ((len(run) + pad) // bm))
    if max(base, default=0) + n > _INT_MAX:
        raise ValueError(f"an arena of {max(base) // n + 1} tenants x {n} "
                         f"rows exceeds the kernel's int32 offsets")
    return (np.asarray(pos, np.int64), np.asarray(base, np.int32), inv)


def check_arena(x, tile_base, m: int, bm: int,
                precision: str = "f32") -> None:
    """Refuse a tenant-axis call the kernels do not take: x not a (T, n, d)
    arena, ``tile_base`` without one entry per query tile of ``bm`` rows,
    or a bf16 call (the bf16 instances take no tenant axis)."""
    if precision != "f32":
        raise ValueError(f"the tenant axis (tile_base=) runs the f32 "
                         f"instances only, not precision={precision!r}")
    if x.dim() != 3:
        raise ValueError(f"with tile_base, x must be the (T, n, d) arena, "
                         f"got {x.dim()}-d")
    tiles = -(-m // bm)
    if tile_base.dim() != 1 or tile_base.shape[0] != tiles:
        raise ValueError(f"tile_base must hold {tiles} entries (one per "
                         f"query tile of {bm} rows), got "
                         f"{tuple(tile_base.shape)}")


def tile_rows(d: int, aligned: bool = True, precision: str = "f32") -> int:
    """Query rows a tile of either sampler kernel holds for width ``d``
    (``sample_block_plan``'s ``bm``): what ``tenant_layout`` pads to."""
    return sample_block_plan(1, 1, d, 1, aligned, precision=precision).bm


def per_tenant(fn, q, x, tile_base, bm: int, *row_args):
    """The plain version of a tenant-axis call: ``fn(q_rows, x_t,
    *row_args_rows)`` for each tenant's rows against its dataset x (T, n,
    d)[t], gathered back in row order.  ``row_args`` are per-row tensors
    (or None)."""
    m, n = q.shape[0], x.shape[1]
    row_base = tile_base.to(torch.int64).repeat_interleave(bm)[:m].cpu()
    out = None
    for base in torch.unique(row_base).tolist():
        idx = torch.nonzero(row_base == base)[:, 0].to(q.device)
        args = [None if a is None else a[idx] for a in row_args]
        got = fn(q[idx], x[base // n], *args)
        if out is None:
            out = [torch.empty((m,) + tuple(g.shape[1:]), dtype=g.dtype,
                               device=g.device) for g in got] \
                if isinstance(got, tuple) else \
                torch.empty((m,) + tuple(got.shape[1:]), dtype=got.dtype,
                            device=got.device)
        if isinstance(got, tuple):
            for o, g in zip(out, got):
                o[idx] = g
        else:
            out[idx] = got
    return tuple(out) if isinstance(out, list) else out


#: (TilePlan, KdeTileShape) per validated call signature
_PLANS: dict = {}
#: arrival counters per (device index, raw stream): int32 zeros, one per
#: query tile, left at 0 by every launch.  Launches on one stream never
#: overlap; launches on two streams may, so each stream has its own buffer.
_COUNTERS: dict = {}


def _plan(q, x, own, gumbel, kind, inv_bw, beta, bn, aligned, precision,
          tile_base=None):
    """Check a call once; its plan and the launch's static arguments."""
    n = x.shape[-2] if tile_base is not None else x.shape[0]
    if tile_base is not None:
        check_operand(tile_base, "tile_base", torch.int32, 1, q.device)
        check_operand(x, "x", torch.float32, 3, q.device)
        x = x.reshape(-1, x.shape[-1])
    check_qx(q, x)
    m, d = q.shape
    if own.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"own must be int32 or int64, got {own.dtype}")
    check_operand(own, "own", own.dtype, 1, q.device)
    if own.shape[0] != m:
        raise ValueError(f"own has {own.shape[0]} rows, q has {m}")
    plan = sample_block_plan(m, n, d, int(bn), aligned, _sms(q.device),
                             precision)
    if tile_base is not None:
        check_arena(x.view(-1, n, d), tile_base, m, plan.bm, precision)
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


def _cached_plan(q, x, own, gumbel, kind, inv_bw, beta, bn, precision,
                 tile_base=None):
    # a tenant's rows start on 16 bytes when the arena does: the wide
    # tiles need d % 4 == 0, so every offset t n d floats is 16-byte too
    aligned = q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
    # (shape, strides) pins contiguity; the checks run once per key
    key = (q.shape, q.stride(), x.shape, x.stride(), own.shape, own.stride(),
           q.dtype, x.dtype, own.dtype, q.get_device(), x.get_device(),
           own.get_device(), kind, inv_bw, beta, bn, aligned, precision)
    if gumbel is not None:
        key += (gumbel.shape, gumbel.stride(), gumbel.dtype,
                gumbel.get_device())
    if tile_base is not None:
        key += (tile_base.shape, tile_base.stride(), tile_base.dtype,
                tile_base.get_device())
    entry = _PLANS.get(key)
    if entry is None:
        entry = _PLANS[key] = _plan(q, x, own, gumbel, kind, inv_bw, beta,
                                    bn, aligned, precision, tile_base)
    return entry


def _ptr(t):
    return None if t is None else t.data_ptr()


def _sms(device: torch.device) -> int:
    return tuning.limits(device).sms


def _counters(device: torch.device, stream: int, tiles: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < tiles:
        buf = _COUNTERS[key] = torch.zeros(max(tiles, 64), dtype=torch.int32,
                                           device=device)
    return buf


def masked_blocksum_cuda(q, x, own, kind: str, inv_bw: float,
                         beta: float = 1.0, bn: int = 256,
                         precision: str = "f32", tile_base=None):
    """bs[i, b] = max(sum_{j in block b} k(q_i, x_j) - [own_i == b],
    1e-12) by the masked-blocksum kernel -> (m, ceil(n / bn)) f32.
    ``own`` (m,) int32 or int64 holds each query's own block (-1: none).
    With ``tile_base`` (the module note's tenant axis) x is the (T, n, d)
    arena and query tile i sums its tenant's rows; still one launch."""
    plan, shape = _cached_plan(q, x, own, None, kind, inv_bw, beta, bn,
                               precision, tile_base)
    m = q.shape[0]
    out = torch.empty((m, plan.nb), dtype=torch.float32, device=q.device)
    if m == 0:
        return out
    err = _build.library().kde_masked_blocksum_launch(
        q.data_ptr(), x.data_ptr(), own.data_ptr(), out.data_ptr(),
        _ptr(tile_base), exp_table_ptr(kind, precision, q.device),
        stream_of(q), shape)
    if err:
        _build.check(err, "kde_masked_blocksum")
    LAUNCHES[launch_key("masked_blocksum", precision)] += 1
    return out


def masked_blocksum_plain(q, x, own, kind: str, inv_bw: float,
                          beta: float = 1.0, bn: int = 256,
                          precision: str = "f32", tile_base=None):
    """Plain torch version of ``masked_blocksum_cuda``."""
    if tile_base is not None:
        bm = tile_rows(q.shape[1], precision=precision)
        check_arena(x, tile_base, q.shape[0], bm, precision)
        return per_tenant(
            lambda qq, xt, oo: masked_blocksum_plain(
                qq, xt, oo, kind, inv_bw, beta, bn, precision),
            q, x, tile_base, bm, own)
    return masked_exact_sums_ref(q, x, torch.sum(x * x, dim=-1),
                                 own.to(q.device), kind, inv_bw, beta, bn,
                                 x.shape[0], precision=precision)


def sample_block_cuda(q, x, own, gumbel, kind: str, inv_bw: float,
                      beta: float = 1.0, bn: int = 256,
                      precision: str = "f32", tile_base=None):
    """Masked block sums plus the Gumbel-max block draw in one launch:
    returns (blk (m,) int64, p_blk (m,), tot (m,), bs (m, B)) with blk =
    argmax_b log(bs_b) + g_b, the first maximum on ties.  ``own`` is int32
    or int64 (read as it is, no cast).  ``tile_base``: the module note's
    tenant axis; the arrival counters then cover every tenant's tiles."""
    plan, shape = _cached_plan(q, x, own, gumbel, kind, inv_bw, beta, bn,
                               precision, tile_base)
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
        _counters(dev, stream, plan.tiles).data_ptr(), _ptr(tile_base),
        exp_table_ptr(kind, precision, dev), stream, shape)
    if err:
        _build.check(err, "kde_sample_block")
    LAUNCHES[launch_key("sample_block", precision)] += 1
    return blk, pb, tot, bs


def sample_block_plain(q, x, own, gumbel, kind: str, inv_bw: float,
                       beta: float = 1.0, bn: int = 256,
                       precision: str = "f32", tile_base=None):
    """Plain torch version of ``sample_block_cuda``."""
    bs = masked_blocksum_plain(q, x, own, kind, inv_bw, beta, bn, precision,
                               tile_base)
    blk, pb, tot = argmax_draw(bs, gumbel)
    return blk, pb, tot, bs
