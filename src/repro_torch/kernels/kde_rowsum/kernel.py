"""Bindings of the exact row-sum and block-sum CUDA kernels
(``csrc/kde_rowsum.cu``), with their plain PyTorch versions.

``rowsum_cuda`` / ``blocksum_cuda`` launch the kernels on CUDA tensors
and count each launch in ``LAUNCHES``; ``rowsum_plain`` /
``blocksum_plain`` compute the same functions with plain torch ops (the
CPU path, and the yardstick the kernels are checked against on the card).
Kernel kinds and bandwidths are runtime arguments; the tile sizes are
constants of ``csrc/kde_tile.cuh`` and ``csrc/kde_wide.cuh``, mirrored in
``kernels/tuning.py``, which the plans read.

``blocksum_plan`` / ``rowsum_plan`` are the host-side plans of both kernels,
built on ``kde_sampler.kernel.sample_block_plan``: the wide 128-row tile
(d % 4 == 0, d <= 32, q and x on 16 bytes) at f32, its tensor-core twin
under the same conditions at bf16, the deep 128-row tile (the same for d >
32), or the generic 64-row tile; the rowsum's split of n into blocks.
Each wrapper validates a call's operands once per (shapes, dtypes,
devices, layout, kernel arguments) and keeps the launch's static arguments
as a ``build.KdeTileShape``.

Every wrapper takes ``precision`` ("f32" or "bf16", DESIGN.md §14).  bf16
launches the tensor-core tile where the wide tile's conditions hold, else
the same deep and generic tiles, at the bf16 kind ids (``kind_args``),
with the bf16 exp table (``exp_table_ptr``: one copy a device) for the
gaussian and exponential kinds, and counts under ``<name>_bf16`` in
``LAUNCHES``.  ``mma_sums_model`` is a plain model of the tensor-core
tile's summation order for the CPU tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import tuning
from repro_torch.kernels.kde_rowsum.ref import blocksum_ref, rowsum_ref
from repro_torch.kernels.kde_sampler.ref import check_precision, exp_table_on

#: ``KdeTileShape::instance`` of the deep tile (``kde::DEEP``)
DEEP = 1

#: kernel launches per wrapper and precision since the last
#: ``reset_launches()``
LAUNCHES = {"rowsum": 0, "blocksum": 0, "rowsum_bf16": 0,
            "blocksum_bf16": 0}

#: ``enum Kind`` of csrc/kde_tile.cuh
KIND_IDS = {"gaussian": 0, "exponential": 1, "rational_quadratic": 2,
            "laplacian": 3}
#: ... and its bf16 kinds (the L2 kinds with bf16 operands)
KIND_IDS_BF16 = {"gaussian": 4, "exponential": 5, "rational_quadratic": 6}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_key(name: str, precision: str) -> str:
    """The ``LAUNCHES`` key of a launch of ``name`` at ``precision``."""
    return name if precision == "f32" else f"{name}_{precision}"


def kind_args(kind: str, inv_bw: float, beta: float, precision: str = "f32"):
    """(kind id, inv_bw, inv_bw^2, beta) as the C launchers take them;
    inv_bw^2 is rounded once from the double product, as the reference's
    ``inv_bw * inv_bw`` static.  bf16 takes the bf16 kind id (L2 kinds
    only: ``check_precision``)."""
    if kind not in KIND_IDS:
        raise ValueError(f"no CUDA kernel for kernel kind {kind!r}; "
                         f"built-in kinds are {sorted(KIND_IDS)}")
    check_precision(precision, kind)
    ids = KIND_IDS if precision == "f32" else KIND_IDS_BF16
    return ids[kind], float(inv_bw), float(inv_bw * inv_bw), float(beta)


def needs_exp_table(kind: str, precision: str) -> bool:
    """True when the kernel finishes through the bf16 exp table: bf16 and
    the gaussian or exponential kind (the rational quadratic finishes in
    f32)."""
    return precision != "f32" and kind in ("gaussian", "exponential")


def exp_table_ptr(kind: str, precision: str, device: torch.device):
    """The launchers' ``table`` argument: the device's copy of the bf16 exp
    table when the kernel reads it, else None (a null pointer)."""
    return exp_table_on(device).data_ptr() if needs_exp_table(
        kind, precision) else None


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


def blocksum_plan(m: int, n: int, d: int, bn: int, aligned: bool = True,
                  sms: int = 132, precision: str = "f32"):
    """The tile an (m, n, d, bn) blocksum runs, as a ``TilePlan``:
    ``sample_block_plan``'s wide tile (d % 4 == 0, d <= 32, q and x on 16
    bytes: ``aligned``) at f32 and its tensor-core twin (``MMA`` + the
    padded d) at ``precision="bf16"``, the deep tile for d > 32 under the
    same conditions (``instance`` DEEP; ``group`` blocks a CTA from
    ``group_for``), else the generic tile, one block a CTA.  Raises
    ValueError for what the kernels do not take (``sample_block_plan``)."""
    from repro_torch.kernels.kde_sampler import kernel as sk
    plan = sk.sample_block_plan(m, n, d, bn, aligned, sms, precision)
    if plan.instance:
        return plan
    if aligned and d % 4 == 0:
        tiles = -(-m // tuning.WIDE_BM)
        return sk.TilePlan(DEEP, tuning.WIDE_BM, tiles, plan.nb,
                           sk.group_for(tiles, plan.nb, sms))
    return plan._replace(group=1)


def rowsum_plan(m: int, n: int, d: int, aligned: bool = True,
                sms: int = 132, precision: str = "f32"):
    """(plan, cols): the rowsum's first pass is a blocksum over ``plan.nb``
    splits of ``cols`` columns (a multiple of the tile's chunk), one split
    a CTA, so the grid fills the card: ``tuning.CTAS_PER_SM`` CTAs an SM
    on the 128-row tiles (the mma tile among them; 2 on the H100),
    ``tuning.GENERIC_CTAS_PER_SM`` on the generic one (its 64-row tiles;
    4)."""
    from repro_torch.kernels.kde_sampler import kernel as sk
    base = blocksum_plan(m, n, d, max(n, 1), aligned, sms, precision)
    chunk, per_sm = ((tuning.GENERIC_BN, tuning.GENERIC_CTAS_PER_SM)
                     if base.instance == 0
                     else (tuning.TILE_BN, tuning.CTAS_PER_SM))
    chunks = -(-n // chunk)
    want = min(max(-(-per_sm * sms // max(base.tiles, 1)), 1), chunks)
    cols = -(-chunks // want) * chunk
    return base._replace(nb=-(-n // cols), group=1), cols


#: (TilePlan, KdeTileShape) per validated call signature
_PLANS: dict = {}


def _cached_plan(q, x, kind, inv_bw, beta, bn, precision="f32",
                 tile_base=None):
    """Check a call once; its plan and the launch's static arguments.
    ``bn`` None plans the rowsum."""
    aligned = q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
    key = (q.shape, q.stride(), x.shape, x.stride(), q.dtype, x.dtype,
           q.get_device(), x.get_device(), kind, inv_bw, beta, bn, aligned,
           precision)
    if tile_base is not None:
        key += (tile_base.shape, tile_base.stride(), tile_base.dtype,
                tile_base.get_device())
    entry = _PLANS.get(key)
    if entry is None:
        from repro_torch.kernels.kde_sampler import kernel as sk
        n = x.shape[-2] if tile_base is not None else x.shape[0]
        if tile_base is not None:
            check_operand(tile_base, "tile_base", torch.int32, 1, q.device)
            check_operand(x, "x", torch.float32, 3, q.device)
        check_qx(q, x.reshape(-1, x.shape[-1]))
        m, d = q.shape
        sms = tuning.limits(q.device).sms
        if bn is None:
            plan, cols = rowsum_plan(m, n, d, aligned, sms, precision)
        else:
            plan = blocksum_plan(m, n, d, int(bn), aligned, sms, precision)
            cols = int(bn)
        if tile_base is not None:
            sk.check_arena(x, tile_base, m, plan.bm, precision)
        shape = _build.KdeTileShape(m, n, d, cols, plan.nb, 0, plan.instance,
                                    plan.group,
                                    *kind_args(kind, inv_bw, beta, precision))
        entry = _PLANS[key] = (plan, shape)
    return entry


def rowsum_cuda(q, x, kind: str, inv_bw: float, beta: float = 1.0,
                precision: str = "f32"):
    """out[i] = sum_j k(q_i, x_j) by the rowsum kernel: q (m, d), x (n, d)
    contiguous f32 CUDA tensors -> (m,) f32.  Two launches: the split's
    block sums, then their sum in split order."""
    plan, shape = _cached_plan(q, x, kind, inv_bw, beta, None, precision)
    m = q.shape[0]
    out = torch.empty(m, dtype=torch.float32, device=q.device)
    if m == 0:
        return out
    partial = torch.empty((m, plan.nb), dtype=torch.float32, device=q.device)
    err = _build.library().kde_rowsum_launch(
        q.data_ptr(), x.data_ptr(), partial.data_ptr(), out.data_ptr(),
        exp_table_ptr(kind, precision, q.device), stream_of(q), shape)
    if err:
        _build.check(err, "kde_rowsum")
    LAUNCHES[launch_key("rowsum", precision)] += 1
    return out


#: the plain torch version of ``rowsum_cuda``
rowsum_plain = rowsum_ref


def blocksum_cuda(q, x, kind: str, inv_bw: float, beta: float = 1.0,
                  bn: int = 256, precision: str = "f32", tile_base=None):
    """out[i, b] = sum_{j in block b} k(q_i, x_j) by the blocksum kernel:
    blocks of ``bn`` consecutive rows of x, the last one ragged ->
    (m, ceil(n / bn)) f32.  One launch.  With ``tile_base`` (the tenant
    axis of ``kde_sampler.kernel``'s module note) x is the (T, n, d) arena
    and query tile i sums its tenant's rows."""
    plan, shape = _cached_plan(q, x, kind, inv_bw, beta, int(bn), precision,
                               tile_base)
    m = q.shape[0]
    out = torch.empty((m, plan.nb), dtype=torch.float32, device=q.device)
    if m == 0:
        return out
    err = _build.library().kde_blocksum_launch(
        q.data_ptr(), x.data_ptr(), out.data_ptr(),
        None if tile_base is None else tile_base.data_ptr(),
        exp_table_ptr(kind, precision, q.device), stream_of(q), shape)
    if err:
        _build.check(err, "kde_blocksum")
    LAUNCHES[launch_key("blocksum", precision)] += 1
    return out


def mma_sums_model(q, x, kind: str, inv_bw: float, beta: float = 1.0,
                   bn: int | None = None, sms: int = 132):
    """Plain torch model of the bf16 tensor-core tile's arithmetic and
    summation order (``csrc/kde_wide.cuh`` ``mma_block_sums`` with the raw
    store, then ``rowsum_reduce_kernel``); the CPU tests hold it to the
    reference, no CUDA path calls it.

    The norms in ``round_half``'s order (each half of the padded width
    summed in f32, then the two halves); the cross term a k-step of 16
    exact products at a time, each step added to the accumulator and
    rounded once to f32 (the tensor cores truncate inside a step instead,
    which ``kde_sampler.ref._pair_slack`` bounds); ``finish2``'s epilogue.
    A row's block sum: each of its quad's four lanes sums its columns in
    the chunk order (128-column chunks from the block's start; in a chunk,
    16-column pairs, then their two 8-column halves, then the lane's two
    columns), then the quad's xor sums; in a short tile (at most 64 valid
    rows) the even and the odd 16-column pairs are summed apart and the
    odd sum is added after the even one.  ``bn`` None gives the rowsum:
    the plan's splits (``rowsum_plan`` on ``sms`` SMs) as blocks, then a
    row's split sums by 32 lanes strided and a fixed xor tree.  Returns
    (m,) or (m, ceil(n / bn)) float32."""
    from repro_torch.kernels.kde_sampler import kernel as sk
    from repro_torch.kernels.kde_sampler.ref import exp_bf16, round_bf16
    check_precision("bf16", kind)
    pad = torch.nn.functional.pad
    m, d = q.shape
    n = x.shape[0]
    dk = 16 if d <= 16 else 32
    qf, xf = pad(round_bf16(q), (0, dk - d)), pad(round_bf16(x), (0, dk - d))

    def norms(a):
        halves = []
        for lo in (0, dk // 2):
            s = torch.zeros(a.shape[0], dtype=torch.float32)
            for k in range(lo, lo + dk // 2):
                s = s + a[:, k] * a[:, k]        # exact products: fmaf's rounding
            halves.append(s)
        return halves[0] + halves[1]

    c = torch.zeros((m, n), dtype=torch.float32)
    for k0 in range(0, dk, 16):
        step = qf[:, k0:k0 + 16].double() @ xf[:, k0:k0 + 16].double().T
        c = (c.double() + step).float()
    d2 = torch.clamp(norms(qf)[:, None] + norms(xf)[None, :] - 2.0 * c,
                     min=0.0)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    if kind == "gaussian":
        kv = exp_bf16(-d2 * f32(inv_bw * inv_bw))
    elif kind == "exponential":
        kv = exp_bf16(-torch.sqrt(d2) * f32(inv_bw))
    else:
        kv = torch.pow(1.0 + d2 * f32(inv_bw * inv_bw), -f32(beta))

    cols = bn if bn is not None else rowsum_plan(m, n, d, True, sms,
                                                 "bf16")[1]
    nb, chunks = -(-n // cols), -(-cols // tuning.TILE_BN)
    kv = pad(pad(kv, (0, nb * cols - n)).view(m, nb, cols),
             (0, chunks * tuning.TILE_BN - cols))
    # column jp 16 + h 8 + tig 2 + e of chunk c: (c, jp as (t, parity), h,
    # tig, e); lane tig's order is (c, jp, h, e), or (c, t, h, e) a parity
    kv = kv.view(m, nb, chunks, 4, 2, 2, 4, 2)

    def lane_sums(v):               # (..., L) -> (...): in order, in f32
        acc = torch.zeros(v.shape[:-1], dtype=torch.float32)
        for i in range(v.shape[-1]):
            acc = acc + v[..., i]
        return acc

    def quad(r):                    # (..., 4 lanes): xor 1, then xor 2
        return (r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])

    full = quad(lane_sums(kv.permute(0, 1, 6, 2, 3, 4, 5, 7)
                          .reshape(m, nb, 4, -1)))
    halves = lane_sums(kv.permute(0, 1, 4, 6, 2, 3, 5, 7)
                       .reshape(m, nb, 2, 4, -1))
    split = quad(halves[:, :, 0]) + quad(halves[:, :, 1])
    tile = torch.arange(m) // tuning.WIDE_BM
    short = (m - tile * tuning.WIDE_BM <= tuning.WIDE_BM // 2)[:, None]
    sums = torch.where(short, split, full)
    if bn is not None:
        return sums
    lanes = lane_sums(pad(sums, (0, -nb % 32)).view(m, -1, 32)
                      .transpose(1, 2))
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ off]
    return lanes[:, 0]


def blocksum_tile_rows(d: int, aligned: bool = True,
                       precision: str = "f32") -> int:
    """Query rows a blocksum tile holds for width ``d`` (``blocksum_plan``'s
    ``bm``): what a tenant-axis call pads each tenant's rows to."""
    return blocksum_plan(1, 1, d, 1, aligned, precision=precision).bm


def blocksum_plain(q, x, kind: str, inv_bw: float, beta: float = 1.0,
                   bn: int = 256, precision: str = "f32", tile_base=None):
    """Plain torch version of ``blocksum_cuda``: ``ref.blocksum_ref``
    (each tenant's rows alone with ``tile_base``)."""
    if tile_base is not None:
        from repro_torch.kernels.kde_sampler import kernel as sk
        bm = blocksum_tile_rows(q.shape[1], precision=precision)
        sk.check_arena(x, tile_base, q.shape[0], bm, precision)
        return sk.per_tenant(
            lambda qq, xt: blocksum_plain(qq, xt, kind, inv_bw, beta, bn,
                                          precision),
            q, x, tile_base, bm)
    return blocksum_ref(q, x, kind, inv_bw, beta, bn, precision)
