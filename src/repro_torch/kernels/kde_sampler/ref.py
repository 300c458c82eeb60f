"""Plain-torch kernel-value math and draw stages of the depth-2 sampler.

The torch mirror of ``repro.kernels.kde_sampler.ref``: the evaluation
half (``kv_matrix`` / ``kv_rows`` / ``kv_pairs``) and the draw half
(inverse CDF, block views, the exact level-2 row and its in-block draw,
and the oracles of the level-1 kernels).  Every function takes explicit
noise (uniforms, Gumbel variates) instead of a key, so tests can feed the
JAX reference and the port the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import tile_size
from repro_torch.kernels import tuning

_L2_KINDS = ("gaussian", "exponential", "rational_quadratic")
# Kinds with closed-form math in this module and a CUDA kernel.
BUILTIN_KINDS = _L2_KINDS + ("laplacian",)

# Floor applied to every (corrected) block-sum estimate: keeps log()
# finite and the own-block sum positive after the k(x, x) = 1 subtraction.
BLOCK_SUM_FLOOR = 1e-12

# Cap on the (rows, n, d) broadcast of the L1 distance, in elements (1 GiB
# of f32) -- the same cap as the reference's laplacian pairwise.
_L1_BUDGET = 1 << 28


def static_pairwise(kernel):
    """None for built-in kinds (evaluated by name), the kernel's own
    callable for custom kinds."""
    return None if kernel.name in BUILTIN_KINDS else kernel.pairwise


def l1_dists(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(m, n) L1 distances by a broadcast over query chunks, with the
    (chunk, n, d) intermediate capped at ``_L1_BUDGET`` elements."""
    m, d = q.shape
    n = x.shape[0]
    chunk = max(_L1_BUDGET // max(n * d, 1), 1)
    outs = [torch.sum(torch.abs(q[lo:lo + chunk, None, :] - x[None, :, :]),
                      dim=-1) for lo in range(0, m, chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _finish_l2(d2, kind: str, inv_bw: float, beta: float):
    d2 = torch.clamp(d2, min=0.0)
    if kind == "gaussian":
        return torch.exp(-d2 * (inv_bw * inv_bw))
    if kind == "exponential":
        return torch.exp(-torch.sqrt(d2) * inv_bw)
    return (1.0 + d2 * (inv_bw * inv_bw)) ** (-beta)


# --------------------------------------------------------------------- #
# mixed precision (DESIGN.md §14)
#
# ``precision="bf16"`` rounds query and dataset coordinates to bfloat16
# (round to nearest even) and keeps everything downstream in f32: products
# of two bf16 values are exact in f32 and the cross term accumulates in
# f32, both squared norms are recomputed in f32 from the *rounded*
# coordinates (a precomputed ``x_sq`` describes the unrounded rows and is
# never reused here), and exp() of the bf16-rounded argument is a read of
# ``bf16_exp_table``.  Only the level-1 sweeps take the policy: level-2
# rows, CDFs, draws and probabilities stay f32.
# --------------------------------------------------------------------- #
PRECISIONS = ("f32", "bf16")

# The reference's documented accuracy bound of the bf16 path for the
# Table-1 kernels (input rounding: d2 drifts by ~2^-7 d2, and terms with
# d2 > 8 carry < 3e-4 of a row's mass); estimators are held to 2x it.
BF16_REL_ERR = 2.0 ** -4

# The pad offset of kde_rowsum.ops._PAD_OFFSET: bf16-representable, and
# its squared norm overflows f32 to inf, so pad rows give exactly 0 on the
# bf16 path too (table[bits(-inf)] = 0).
_FAR_OFFSET = 1.0e30

_EXP_TABLE = None
#: the table as a float32 tensor, one per device it was asked for on
_EXP_TABLES: dict = {}


def bf16_exp_table():
    """(65536,) float32 numpy table of exp() over every bfloat16 bit
    pattern: numpy's float64 exp, rounded to f32 (-inf -> 0, NaN patterns
    stay NaN).  Built once a process."""
    global _EXP_TABLE
    if _EXP_TABLE is None:
        with np.errstate(over="ignore", invalid="ignore"):
            args = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
            _EXP_TABLE = np.exp(args.astype(np.float64)).astype(np.float32)
    return _EXP_TABLE


def exp_table_on(device) -> torch.Tensor:
    """``bf16_exp_table()`` as a float32 tensor on ``device``, copied there
    once and kept (the kernels gather from it, as the plain versions)."""
    device = torch.device(device)
    table = _EXP_TABLES.get(device)
    if table is None:
        table = _EXP_TABLES[device] = torch.as_tensor(
            bf16_exp_table()).to(device)
    return table


def bf16_bits(y: torch.Tensor) -> torch.Tensor:
    """The 16-bit pattern of ``y`` rounded to bfloat16 (nearest even), as
    int64 indices in [0, 65536)."""
    return y.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def exp_bf16(y: torch.Tensor, table: torch.Tensor | None = None):
    """exp() of ``y`` after rounding it to bfloat16, read from the table
    (``table``: ``bf16_exp_table()`` as a tensor on y's device; None takes
    ``exp_table_on(y.device)``)."""
    if table is None:
        table = exp_table_on(y.device)
    return table[bf16_bits(y)]


def check_precision(precision: str, kind: str, pairwise=None) -> None:
    """Refuse what the reference refuses, at construction: an unknown
    precision, and bf16 with any kernel but the three built-in L2 kinds
    (laplacian, or a custom ``pairwise``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"expected one of {PRECISIONS}")
    if precision == "bf16" and (kind not in _L2_KINDS or pairwise is not None):
        raise ValueError(
            "precision='bf16' supports the built-in L2 kernels only "
            f"(gaussian / exponential / rational_quadratic); got {kind!r}")


def round_bf16(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to bfloat16 and back to float32."""
    return a.to(torch.bfloat16).to(torch.float32)


def _finish_l2_bf16(d2, kind: str, inv_bw: float, beta: float, table=None):
    """The L2 finish of the bf16 path: f32 d2 in, table exp out for the
    gaussian and exponential kinds, the f32 power for the rational
    quadratic."""
    d2 = torch.clamp(d2, min=0.0)
    if kind == "gaussian":
        return exp_bf16(-d2 * (inv_bw * inv_bw), table)
    if kind == "exponential":
        return exp_bf16(-torch.sqrt(d2) * inv_bw, table)
    return (1.0 + d2 * (inv_bw * inv_bw)) ** (-beta)


def kv_matrix_bf16(q, x, kind: str, inv_bw: float, beta: float):
    """(m, n) kernel values of the bf16 policy.  The rounded operands are
    upcast before the product, so the cross term is exact products summed
    in f32 (a bf16 matmul would round its output to bf16)."""
    qf, xf = round_bf16(q), round_bf16(x)
    qq = torch.sum(qf * qf, dim=1, keepdim=True)
    xx = torch.sum(xf * xf, dim=1)
    d2 = qq + xx[None, :] - 2.0 * (qf @ xf.T)
    return _finish_l2_bf16(d2, kind, inv_bw, beta)


def bf16_flip_slack(q, x, kind: str, inv_bw: float, bn: int | None = None,
                    chunk: int = 1024) -> torch.Tensor:
    """How far a kernel value of the bf16 policy may move between two
    correct computations that sum in different orders (a kernel and its
    plain version), as a float64 tensor: (m, n) for x (n, d), or (w, t)
    for per-row gathered rows x (w, t, d); with ``bn``, the slack of each
    block sum instead, (m, ceil(n / bn)) (the last block ragged), as a
    blocksum returns them.  Computed over query chunks of ``chunk`` rows,
    so its float64 intermediates stay (chunk, n)."""
    parts = []
    for lo in range(0, q.shape[0], chunk):
        s = _pair_slack(q[lo:lo + chunk],
                        x[lo:lo + chunk] if x.dim() == 3 else x, kind, inv_bw)
        if bn is not None:
            s = torch.nn.functional.pad(s, (0, -s.shape[1] % bn)).view(
                s.shape[0], -1, bn).sum(-1)
        parts.append(s)
    return torch.cat(parts)


def _pair_slack(q, x, kind: str, inv_bw: float) -> torch.Tensor:
    """``bf16_flip_slack`` of one query chunk, pair by pair.

    Both compute the gaussian / exponential argument y in f32 from exact
    bf16 products, each within ``err`` of the exact y (f32 sums of any
    order: (d + 2) u (qq + xx + 2 sum|q_k x_k|) on d2, u = 2^-24, plus the
    scaling's rounding).  They round y to the same bf16 value, so read the
    same table entry, unless a bf16 rounding midpoint lies within ``err``
    of the exact y.  Only such a pair may differ: both rounded arguments
    lie within err + one bf16 step of y, so the slack there is
    exp(-(y - err - 2 ulp)) expm1(2 err + 4 ulp), 0 elsewhere (near y = 0,
    as for a point against itself, err is larger than the step).  The
    rational quadratic reads no table (its values differ by f32 rounding
    alone): all 0.

    The bf16 sampler kernels form the cross term on the tensor cores
    (``mma.sync`` m16n8k16, bf16 in, f32 accumulate), which do not round
    each addition: the 16 products of a k-step are exact, and the tensor
    core adds them (and the accumulator) after aligning them to the
    largest exponent, dropping the bits below f32's precision there
    (truncation), and rounds once to f32.  Each dropped tail is smaller
    than one f32 unit of the largest term, so a k-step errs by less than
    a few units of max |q_k x_k| <= sum |q_k x_k|: a handful of
    truncations, each within 2u of sum |q_k x_k|, where the model above
    allows (d + 2) roundings of u each on the cross term's 2 sum |q_k x_k|
    share and as many again on qq + xx >= 2 sum |q_k x_k|.  d <= 16 is one
    k-step, 17 <= d <= 32 two (the second adds the first's f32 result as
    its accumulator).  The norms stay the f32 FMA chains of the other
    tiles.  ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold those
    kernels to this slack on inputs built for cancellation: a common
    offset large against the spread (qq + xx - 2c cancels all but a few
    bits) and points against themselves (d2 = 0)."""
    qf, xf = round_bf16(q).double(), round_bf16(x).double()
    if xf.dim() == 3:
        cross = torch.einsum("wd,wtd->wt", qf, xf)
        acs = torch.einsum("wd,wtd->wt", qf.abs(), xf.abs())
        xx = torch.sum(xf * xf, dim=-1)
    else:
        cross, acs = qf @ xf.T, qf.abs() @ xf.abs().T
        xx = torch.sum(xf * xf, dim=-1)[None, :]
    qq = torch.sum(qf * qf, dim=-1)[:, None]
    if kind not in ("gaussian", "exponential"):
        return torch.zeros_like(cross)
    u = 2.0 ** -24
    d2 = torch.clamp(qq + xx - 2.0 * cross, min=0.0)
    err = (q.shape[-1] + 2) * u * (qq + xx + 2.0 * acs)
    if kind == "gaussian":
        y = d2 * (inv_bw * inv_bw)
        ey = err * (inv_bw * inv_bw)
    else:
        y = torch.sqrt(d2) * inv_bw
        ey = (torch.sqrt(d2 + err) - torch.sqrt(torch.clamp(d2 - err, min=0.0))
              ) * inv_bw
    ey = ey + 4.0 * u * y
    # bf16 keeps 8 significant bits: spacing 2^(e - 7) in [2^e, 2^(e + 1)),
    # rounding midpoints at odd multiples of half of it; the midpoint below
    # 2^e lies a quarter spacing under it
    yc = torch.clamp(y, min=1e-30)
    low = torch.exp2(torch.floor(torch.log2(yc)))
    ulp = low / 128.0
    frac = yc / ulp - torch.floor(yc / ulp)
    dist = torch.minimum(torch.abs(frac - 0.5) * ulp, yc - low + ulp / 4.0)
    slack = torch.exp(-torch.clamp(y - ey - 2.0 * ulp, min=0.0)) \
        * torch.expm1(2.0 * ey + 4.0 * ulp)
    return torch.where(dist <= ey, slack, 0.0)


def kv_block_sums_bf16(q, x, kind: str, inv_bw: float, beta: float,
                       bn: int, blocks_per_tile: int | None = None):
    """(m, ceil(n / bn)) per-block sums of the bf16 values, swept over
    column tiles of ``blocks_per_tile`` blocks (None:
    ``tuning.sweep_blocks_per_tile(bn, d)``, as the reference's), so the
    (m, n) matrix is never formed; each block's sum is the same whatever
    the tile.  The tail is padded at the far offset (values exactly 0)."""
    tile_size("blocks_per_tile", blocks_per_tile)
    m = q.shape[0]
    n, d = x.shape
    num_b = -(-n // bn)
    t = blocks_per_tile or tuning.sweep_blocks_per_tile(bn, d)
    pad = num_b * bn - n
    if pad:
        x = torch.cat([x, torch.full((pad, d), _FAR_OFFSET, dtype=x.dtype,
                                     device=x.device)], dim=0)
    outs = [kv_matrix_bf16(q, x[lo * bn:(lo + t) * bn], kind, inv_bw, beta)
            .reshape(m, -1, bn).sum(-1) for lo in range(0, num_b, t)]
    return torch.cat(outs, dim=1)


def kv_matrix(q, x, x_sq, kind: str, inv_bw: float, beta: float,
              pairwise=None, precision: str = "f32") -> torch.Tensor:
    """(m, n) kernel values; L2 kinds reuse precomputed ``x_sq``.  Unknown
    kinds fall back to the ``pairwise`` callable.  ``precision="bf16"``
    takes ``kv_matrix_bf16`` (L2 kinds only; ``x_sq`` is not used)."""
    if precision != "f32":
        check_precision(precision, kind, pairwise)
        return kv_matrix_bf16(q, x, kind, inv_bw, beta)
    if kind in _L2_KINDS:
        qq = torch.sum(q * q, dim=1, keepdim=True)
        d2 = qq + x_sq[None, :] - 2.0 * (q @ x.T)
        return _finish_l2(d2, kind, inv_bw, beta)
    if kind == "laplacian":
        return torch.exp(-l1_dists(q, x) * inv_bw)
    return pairwise(q, x)


def kv_rows(xs, xb, xs_sq, xb_sq, kind: str, inv_bw: float, beta: float,
            pairwise=None) -> torch.Tensor:
    """Per-row block values k(xs_i, xb_i_j): xs (w, d), xb (w, bs, d) ->
    (w, bs).  The level-2 read of the depth-2 sampler."""
    if kind in _L2_KINDS:
        cross = torch.sum(xs[:, None, :] * xb, dim=-1)
        d2 = xs_sq[:, None] + xb_sq - 2.0 * cross
        return _finish_l2(d2, kind, inv_bw, beta)
    if kind == "laplacian":
        d1 = torch.sum(torch.abs(xs[:, None, :] - xb), dim=-1)
        return torch.exp(-d1 * inv_bw)
    return torch.stack([pairwise(a[None, :], b)[0] for a, b in zip(xs, xb)])


def kv_pairs(a, b, kind: str, inv_bw: float, beta: float,
             pairwise=None) -> torch.Tensor:
    """Elementwise k(a_i, b_i) for aligned (w, d) arrays -- O(w d)."""
    if kind in _L2_KINDS:
        d2 = torch.sum((a - b) ** 2, dim=-1)
        return _finish_l2(d2, kind, inv_bw, beta)
    if kind == "laplacian":
        d1 = torch.sum(torch.abs(a - b), dim=-1)
        return torch.exp(-d1 * inv_bw)
    return torch.stack([pairwise(u[None, :], v[None, :])[0, 0]
                        for u, v in zip(a, b)])


# --------------------------------------------------------------------- #
# draw half
# --------------------------------------------------------------------- #
def inverse_cdf_index(cdf, u) -> torch.Tensor:
    """Vectorized inverse-CDF lookup over a normalized prefix array:
    cdf (n,) nondecreasing with cdf[-1] ~= 1, u (w,) uniforms -> (w,)
    int64 indices (``searchsorted(side="right")``, then clipped, as the
    reference)."""
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, 0, cdf.shape[0] - 1)


def block_views(x, x_sq, block_size: int):
    """(B, bs, d) / (B, bs) views of the dataset zero-padded to a block
    multiple.  Built once per sampler; the level-2 read gathers whole
    block slices."""
    pad = -x.shape[0] % block_size
    xb_all = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(
        -1, block_size, x.shape[1])
    xb_sq_all = torch.nn.functional.pad(x_sq, (0, pad)).reshape(
        -1, block_size)
    return xb_all, xb_sq_all


def level2_row(x, x_sq, views, src, blk, kind: str, inv_bw: float,
               beta: float, block_size: int, n: int, pairwise=None,
               off=None):
    """Exact kernel row of each source against its chosen block, with the
    self edge and out-of-range tail columns masked to 0.  ``off`` (the
    serving layer's stacked tenants): ``(row offset (w,), view offset
    (w,))`` of each row's tenant in x / x_sq (T datasets of n rows) and in
    the views (T datasets' blocks); ``src``, ``blk`` and the returned
    columns stay tenant-relative."""
    xb_all, xb_sq_all = views
    lo = blk * block_size
    cols = lo[:, None] + torch.arange(block_size, device=blk.device)[None, :]
    rows, vblk = (src, blk) if off is None else (off[0] + src, off[1] + blk)
    kv = kv_rows(x[rows], xb_all[vblk], x_sq[rows], xb_sq_all[vblk], kind,
                 inv_bw, beta, pairwise)
    if n % block_size == 0:
        live = cols != src[:, None]
        return torch.where(live, kv, 0.0), live, cols
    valid = cols < n
    cols_c = torch.clamp(cols, max=n - 1)
    live = valid & (cols_c != src[:, None])
    return torch.where(live, kv, 0.0), live, cols_c


def level2_draw(kv, live, cols_c, u2):
    """Inverse-CDF draw from each row of ``kv``; all-zero rows
    (numerically underflowed blocks) fall back to uniform over the live
    columns instead of producing NaN."""
    rowsum = kv.sum(dim=1)
    use = torch.where((rowsum > 0.0)[:, None], kv, live.to(kv.dtype))
    c = torch.cumsum(use, dim=1)
    tot = c[:, -1]
    j = torch.sum((u2 * tot)[:, None] > c, dim=1).clamp(0, kv.shape[1] - 1)
    nb = torch.gather(cols_c, 1, j[:, None])[:, 0]
    pin = torch.gather(use, 1, j[:, None])[:, 0] / torch.clamp(tot, min=1e-30)
    return nb, pin


def choose_block(bs, u):
    """Exact inverse-CDF categorical over rows of the (floored) block sums
    with explicit uniforms ``u`` (w,); returns (block, realized block
    probability)."""
    c = torch.cumsum(bs, dim=1)
    tot = c[:, -1]
    blk = torch.sum((u * tot)[:, None] > c, dim=1)
    blk = blk.clamp(0, bs.shape[1] - 1)
    pb = torch.gather(bs, 1, blk[:, None])[:, 0] / tot
    return blk, pb


def cdf_group(m: int) -> int:
    """Largest divisor of ``m`` that is <= sqrt(m) -- the inner group width
    of the two-level inverse CDF (1 for prime ``m``: the flat search)."""
    g = max(int(m ** 0.5), 1)
    while m % g:
        g -= 1
    return g


def grouped_inverse_cdf(vals, u, group: int):
    """Two-level inverse-CDF categorical over each row of ``vals`` (w, m)
    with uniforms ``u`` (w,): the group of ``group`` contiguous columns by
    the cumsum of the group sums, then the column by the cumsum inside the
    group.  The same law as the flat search; the realized index differs
    from it only where ``u * total`` lies within a few ulps of a partial
    sum (fp regrouping).  Returns (index, vals[index], row total)."""
    w, m = vals.shape
    ng = m // group
    v3 = vals.reshape(w, ng, group)
    grp = v3.sum(-1)
    cg = torch.cumsum(grp, dim=1)
    tot = cg[:, -1]
    t = u * tot
    g = torch.sum(t[:, None] > cg, dim=1).clamp(0, ng - 1)
    prev = (torch.gather(cg, 1, g[:, None])
            - torch.gather(grp, 1, g[:, None]))[:, 0]
    sub = v3[torch.arange(w, device=vals.device), g]
    cs = torch.cumsum(sub, dim=1)
    j = torch.sum((t - prev)[:, None] > cs, dim=1).clamp(0, group - 1)
    val = torch.gather(sub, 1, j[:, None])[:, 0]
    return g * group + j, val, tot


def choose_block_grouped(bs, u, group: int):
    """``choose_block`` by the two-level inverse CDF, uniforms ``u`` (w,):
    (block, realized block probability)."""
    blk, val, tot = grouped_inverse_cdf(bs, u, group)
    return blk, val / tot


def level2_draw_grouped(kv, live, cols_c, u2, group: int):
    """``level2_draw`` by the two-level inverse CDF (the same all-zero-row
    fallback to uniform over the live columns)."""
    rowsum = kv.sum(dim=1)
    use = torch.where((rowsum > 0.0)[:, None], kv, live.to(kv.dtype))
    j, val, tot = grouped_inverse_cdf(use, u2, group)
    nb = torch.gather(cols_c, 1, j[:, None])[:, 0]
    return nb, val / torch.clamp(tot, min=1e-30)


def sample_from_sums(x, x_sq, views, src, bs, u_blk, u_in, kind: str,
                     inv_bw: float, beta: float, block_size: int, n: int,
                     pairwise=None, off=None):
    """One depth-2 draw from given level-1 sums ``bs``: inverse-CDF block
    draw (uniforms ``u_blk``) -> exact level-2 row -> in-block draw
    (uniforms ``u_in``).  Returns (neighbors, realized probabilities).
    ``off``: ``level2_row``'s tenant offsets."""
    blk, pb = choose_block(bs, u_blk)
    kv, live, cols_c = level2_row(x, x_sq, views, src, blk, kind, inv_bw,
                                  beta, block_size, n, pairwise, off)
    nb, pin = level2_draw(kv, live, cols_c, u_in)
    return nb, pb * pin


def masked_exact_sums_ref(q, x, x_sq, own, kind: str, inv_bw: float,
                          beta: float, bn: int, n: int, pairwise=None,
                          precision: str = "f32"):
    """Masked level-1 sums by one dense sweep over the unpadded dataset,
    zero-padded to a block multiple, own-block corrected by the self
    kernel k(x, x) = 1, floored."""
    m = q.shape[0]
    kv = kv_matrix(q, x, x_sq, kind, inv_bw, beta, pairwise, precision)
    pad = -n % bn
    if pad:
        kv = torch.nn.functional.pad(kv, (0, pad))
    bs = kv.reshape(m, -1, bn).sum(-1)
    corr = torch.arange(bs.shape[1], device=bs.device)[None, :] \
        == own[:, None]
    bs = torch.where(corr, bs - 1.0, bs)
    return torch.clamp(bs, min=BLOCK_SUM_FLOOR)


def masked_block_sums_ref(q, x, x_sq, own, kind: str, inv_bw: float,
                          beta: float, bn: int, pairwise=None):
    """(m, B) per-block sums over a padded dataset (n a multiple of
    ``bn``; padding rows at the far offset evaluate to 0), with
    k(x, x) = 1 subtracted from each query's own block and the result
    floored at BLOCK_SUM_FLOOR."""
    m, n = q.shape[0], x.shape[0]
    kv = kv_matrix(q, x, x_sq, kind, inv_bw, beta, pairwise)
    bs = kv.reshape(m, n // bn, bn).sum(-1)
    corr = torch.arange(n // bn, device=bs.device)[None, :] == own[:, None]
    bs = torch.where(corr, bs - 1.0, bs)
    return torch.clamp(bs, min=BLOCK_SUM_FLOOR)


def argmax_draw(bs, gumbel):
    """Gumbel-max block draw over masked sums: blk = argmax_b log(bs_b) +
    g_b (first maximum on ties), tot = sum_b bs_b, p_blk = bs[blk] / tot."""
    score = torch.log(bs) + gumbel
    blk = torch.argmax(score, dim=1)
    tot = torch.sum(bs, dim=1)
    pb = torch.gather(bs, 1, blk[:, None])[:, 0] / tot
    return blk, pb, tot


def sample_block_ref(q, x, x_sq, own, gumbel, kind: str, inv_bw: float,
                     beta: float, bn: int, pairwise=None):
    """Oracle of the sample-block kernel: (blk, p_blk, tot, block_sums)
    with blk = argmax_b log(bs_b) + g_b."""
    bs = masked_block_sums_ref(q, x, x_sq, own, kind, inv_bw, beta, bn,
                               pairwise)
    blk, pb, tot = argmax_draw(bs, gumbel)
    return blk, pb, tot, bs


# --------------------------------------------------------------------- #
# single-process oracles of the sharded engine (``sharded.ShardedBlocks``)
# --------------------------------------------------------------------- #
# They emulate P shards with plain torch ops, as the reference's jnp
# oracles do, and start no process group.  They take the reference's
# parameters in its order; its threefry ``key`` (``keys``) becomes the
# noise the reference derives from it, named after it (ROADMAP.md
# section 3): ``key_u`` / ``keys_u``.


def sharded_masked_sums_ref(x_pad, x_sq_pad, src, key_u, kind: str,
                            inv_bw: float, beta: float, block_size: int,
                            blocks_per_shard: int, num_shards: int, n: int,
                            exact: bool = True, s: int = 16, pairwise=None):
    """The engine's local level-1 sums, concatenated over shards: the
    §2-contract read on the padded ``P * shard_size`` layout -- own-block
    corrected, real blocks floored at 1e-12, all-sentinel blocks pinned to
    0.  ``key_u`` is the stratified read's (P B_p, bs) subsample uniforms,
    shard p's rows ``[p B_p, (p + 1) B_p)`` (the reference draws them from
    ``fold_in(key, p)``); ignored on the exact read."""
    w = src.shape[0]
    bs = block_size
    shard_size = blocks_per_shard * bs
    num_blocks_pad = num_shards * blocks_per_shard
    dev = x_pad.device
    q = x_pad[src]
    if exact:
        kv = kv_matrix(q, x_pad, x_sq_pad, kind, inv_bw, beta, pairwise)
        sums = kv.reshape(w, num_blocks_pad, bs).sum(-1)
    else:
        parts = []
        base = torch.arange(blocks_per_shard, device=dev) * bs
        pos = base[:, None] + torch.arange(bs, device=dev)[None, :]
        for p in range(num_shards):
            lo = p * shard_size
            u = key_u[p * blocks_per_shard:(p + 1) * blocks_per_shard]
            valid = (lo + pos) < n
            u = torch.where(valid, u, torch.inf)
            order = torch.topk(-u, s, dim=1).indices
            idx = torch.gather(pos, 1, order)
            sel_valid = torch.gather(valid, 1, order)
            flat = lo + idx.reshape(-1)
            kv = kv_matrix(q, x_pad[flat], x_sq_pad[flat], kind, inv_bw,
                           beta, pairwise)
            kv = kv.reshape(w, blocks_per_shard, s) * sel_valid[None]
            sizes = torch.clamp(n - (lo + base), 0, bs).to(torch.float32)
            s_b = torch.clamp(sizes, max=float(s))
            parts.append(kv.sum(-1)
                         * (sizes / torch.clamp(s_b, min=1.0))[None, :])
        sums = torch.cat(parts, dim=1)
    own = src // bs
    corr = torch.arange(num_blocks_pad, device=dev)[None, :] == own[:, None]
    sums = torch.where(corr, sums - 1.0, sums)
    gbase = torch.arange(num_blocks_pad, device=dev) * bs
    real = torch.clamp(n - gbase, 0, bs) > 0
    return torch.where(real[None, :],
                       torch.clamp(sums, min=BLOCK_SUM_FLOOR), 0.0)


def sharded_sample_from_sums_ref(x_pad, x_sq_pad, views, src, sums, key_u,
                                 kind: str, inv_bw: float, beta: float,
                                 block_size: int, blocks_per_shard: int,
                                 n: int, pairwise=None):
    """The two-stage collective draw in one process: inverse CDF over the
    shard totals, then the owner's local block sums, then the in-block
    columns.  ``key_u`` is the draw's (3, w) uniforms: owner shard, local
    block, in-block column (the reference's ``(k_shard, k_blk, k_in) =
    split(key, 3)``).  Returns (nb, prob, total)."""
    w, num_blocks_pad = sums.shape
    num_shards = num_blocks_pad // blocks_per_shard
    u0, u1, u2 = key_u[0], key_u[1], key_u[2]
    by_shard = sums.reshape(w, num_shards, blocks_per_shard)
    t = by_shard.sum(-1)                                  # (w, P)
    ct = torch.cumsum(t, dim=1)
    tot = ct[:, -1]
    owner = torch.sum((u0 * tot)[:, None] > ct, dim=1).clamp(0,
                                                             num_shards - 1)
    local = by_shard[torch.arange(w, device=sums.device), owner]  # (w, B_p)
    t_o = torch.gather(t, 1, owner[:, None])[:, 0]
    c = torch.cumsum(local, dim=1)
    blk_l = torch.sum((u1 * t_o)[:, None] > c, dim=1).clamp(
        0, blocks_per_shard - 1)
    s_b = torch.gather(local, 1, blk_l[:, None])[:, 0]
    gblk = owner * blocks_per_shard + blk_l
    kv, live, cols_c = level2_row(x_pad, x_sq_pad, views, src, gblk, kind,
                                  inv_bw, beta, block_size, n, pairwise)
    nb, pin = level2_draw(kv, live, cols_c, u2)
    return nb, s_b * pin / torch.clamp(tot, min=1e-30), tot


def sharded_fused_sample_ref(x_pad, x_sq_pad, src, key_u, kind: str,
                             inv_bw: float, beta: float, block_size: int,
                             blocks_per_shard: int, num_shards: int, n: int,
                             exact: bool = True, s: int = 16, pairwise=None):
    """``ShardedBlocks.fused_sample`` in one process: the §2 level-1 read,
    then the two-stage draw.  ``key_u`` is ``(l1, u)``, the reference's
    ``k_l1, k_rest = split(key)`` as noise: the read's (P B_p, bs)
    uniforms (None on the exact read) and the draw's (3, w) ones.
    Returns (nb, prob, sums)."""
    l1, u = key_u
    sums = sharded_masked_sums_ref(x_pad, x_sq_pad, src, l1, kind, inv_bw,
                                   beta, block_size, blocks_per_shard,
                                   num_shards, n, exact=exact, s=s,
                                   pairwise=pairwise)
    views = block_views(x_pad, x_sq_pad, block_size)
    nb, prob, _ = sharded_sample_from_sums_ref(
        x_pad, x_sq_pad, views, src, sums, u, kind, inv_bw, beta,
        block_size, blocks_per_shard, n, pairwise)
    return nb, prob, sums


def sharded_walk_ref(x_pad, x_sq_pad, starts, keys_u, kind: str,
                     inv_bw: float, beta: float, block_size: int,
                     blocks_per_shard: int, num_shards: int, n: int,
                     exact: bool = True, s: int = 16, pairwise=None):
    """``ShardedBlocks.walk_scan`` (rounds = 0) in one process: a host loop
    of a level-1 read and a two-stage draw a step.  ``keys_u`` holds one
    ``(l1, u)`` pair a step, as ``sharded_fused_sample_ref`` takes it (the
    reference's per-step key).  Returns the endpoints."""
    cur = starts
    for key_u in keys_u:
        cur, _, _ = sharded_fused_sample_ref(
            x_pad, x_sq_pad, cur, key_u, kind, inv_bw, beta, block_size,
            blocks_per_shard, num_shards, n, exact=exact, s=s,
            pairwise=pairwise)
    return cur


def fused_edge_batch_ref(x, x_sq, cdf, degs, inv_total, inv_t, u_vert,
                         gumbel, u_in, kind: str, inv_bw: float, beta: float,
                         block_size: int, n: int, pairwise=None):
    """Oracle of one fused Algorithm 5.1 edge batch with explicit noise:
    u ~ degrees by inverse CDF (uniforms ``u_vert``), v by Gumbel-max
    block draw (``gumbel``) + exact in-block draw (``u_in``), the collapsed
    reverse probability q(u | v) = k(u,v)/deg(v), and the reweighting
    ``k(u,v) / (t (p_u q_uv + p_v q_vu))``."""
    from repro_torch.kernels.kde_rowsum.ops import _PAD_OFFSET, _pad_rows
    views = block_views(x, x_sq, block_size)
    xp = _pad_rows(x, block_size, _PAD_OFFSET)
    xp_sq = torch.sum(xp * xp, dim=-1)
    u = inverse_cdf_index(cdf, u_vert)
    blk, pb, _, _ = sample_block_ref(x[u], xp, xp_sq, u // block_size,
                                     gumbel, kind, inv_bw, beta, block_size,
                                     pairwise)
    kv, live, cols_c = level2_row(x, x_sq, views, u, blk, kind, inv_bw, beta,
                                  block_size, n, pairwise)
    v, pin = level2_draw(kv, live, cols_c, u_in)
    q_uv = pb * pin
    kuv = kv_pairs(x[u], x[v], kind, inv_bw, beta, pairwise)
    q_vu = kuv / torch.clamp(degs[v], min=BLOCK_SUM_FLOOR)
    q_edge = inv_total * (degs[u] * q_uv + kuv)
    wgt = kuv * inv_t / torch.clamp(q_edge, min=1e-30)
    return u, v, wgt, q_uv, q_vu


# --------------------------------------------------------------------- #
# application oracles (DESIGN.md §7)
# --------------------------------------------------------------------- #
def degree_precedes(degs, a, b):
    """Degree-then-index total vertex order from Theorem 6.17's proof:
    a < b iff (deg_a, a) < (deg_b, b) lexicographically."""
    return (degs[a] < degs[b]) | ((degs[a] == degs[b]) & (a < b))


def noisy_power_step(ksub, v, u):
    """One BIMW21 noisy power iteration with uniforms ``u``
    (num_samples,): j ~ |v_j| by inverse CDF, the unbiased sampled matvec
    ``sum_j sign(v_j) z / S ksub[:, j]``, renormalized (the previous
    iterate is kept where the matvec or the mass collapsed).  Returns
    (next iterate, sampled matvec, ok)."""
    t = ksub.shape[0]
    absv = torch.abs(v)
    z = torch.sum(absv)
    cdf = torch.cumsum(absv, dim=0)
    uu = u * torch.clamp(z, min=1e-30)
    idx = torch.clamp(torch.searchsorted(cdf, uu, right=True), 0, t - 1)
    contrib = torch.sign(v[idx]) * z / u.shape[0]
    w = ksub[:, idx] @ contrib
    nw = torch.linalg.norm(w)
    ok = (nw > 0.0) & (z > 0.0)
    return torch.where(ok, w / torch.clamp(nw, min=1e-30), v), w, ok


def noisy_power_ref(ksub, v0, us):
    """Oracle of ``ops.noisy_power_scan``: the iterations of
    ``noisy_power_step`` with uniforms ``us`` (iters, num_samples), then
    the Rayleigh quotient.  Returns (eigenvalue, final unit vector)."""
    v = v0
    for u in us:
        v, _, _ = noisy_power_step(ksub, v, u)
    return v @ (ksub @ v), v


def edge_degrees(src, dst, w, n: int):
    """Weighted degrees D of a COO edge list by two scatter-adds."""
    deg = torch.zeros(n, dtype=w.dtype, device=w.device)
    return deg.index_add_(0, src, w).index_add_(0, dst, w)


def laplacian_matvec_ref(src, dst, w, p, n: int, deg=None):
    """L p = D p - A p over a COO edge list by two scatter-adds (the torch
    transcription of ``SparseGraph.matvec``); ``deg`` is D when the caller
    has it already (``edge_degrees``)."""
    av = torch.zeros(n, dtype=w.dtype, device=w.device)
    av.index_add_(0, src, w * p[dst]).index_add_(0, dst, w * p[src])
    if deg is None:
        deg = edge_degrees(src, dst, w, n)
    return deg * p - av


def triangle_batch_ref(x, x_sq, u, v, degs, u_blk, u_in, kind: str,
                       inv_bw: float, beta: float, block_size: int, n: int,
                       pairwise=None):
    """Oracle of ``ops.triangle_edge_scan`` on its exact level-1 read:
    degree-ordered orientation, one masked level-1 read of the v frontier,
    then per draw i one ``sample_from_sums`` neighbor (uniforms
    ``u_blk[i]``, ``u_in[i]``), the validity mask ``v < w`` (degree order)
    and ``w != u``, and the reweighting by deg(v) / num_draws.  Returns
    (oriented u, oriented v, per-edge weight estimates)."""
    views = block_views(x, x_sq, block_size)
    prec = degree_precedes(degs, u, v)
    uu = torch.where(prec, u, v)
    vv = torch.where(prec, v, u)
    kuv = kv_pairs(x[uu], x[vv], kind, inv_bw, beta, pairwise)
    bs = masked_exact_sums_ref(x[vv], x, x_sq, vv // block_size, kind,
                               inv_bw, beta, block_size, n, pairwise)
    acc = torch.zeros_like(kuv)
    for ub, ui in zip(u_blk, u_in):
        w, _ = sample_from_sums(x, x_sq, views, vv, bs, ub, ui, kind,
                                inv_bw, beta, block_size, n, pairwise)
        valid = degree_precedes(degs, vv, w) & (w != uu)
        kuw = kv_pairs(x[uu], x[w], kind, inv_bw, beta, pairwise)
        acc = acc + torch.where(valid, kuv * kuw, 0.0)
    return uu, vv, acc * degs[vv] / u_blk.shape[0]


# --------------------------------------------------------------------- #
# streaming patches (DESIGN.md §12)
# --------------------------------------------------------------------- #
def patch_block_sums_ref(bs, q, slots, old_x, new_x, kind: str,
                         inv_bw: float, beta: float, bn: int, pairwise=None):
    """Oracle of ``ops.patch_block_sums``: incremental §2 level-1 update.

    Subtracts the mutated slots' *old* kernel contributions from the
    cached (w, B) block sums and adds the *new* ones -- O(w m) evals for an
    m-row mutation batch instead of the O(w n) rebuild.  Sentinel
    coordinates (dead side of inserts / deletes) evaluate to exactly 0.0,
    so one delta formula covers insert, delete and update.  The stored
    sums are post-floor, so a block clamped at BLOCK_SUM_FLOOR cannot be
    un-clamped exactly; the consumer drops the cache when the frontier
    itself mutates.
    """
    old_sq = torch.sum(old_x * old_x, dim=-1)
    new_sq = torch.sum(new_x * new_x, dim=-1)
    kv_new = kv_matrix(q, new_x, new_sq, kind, inv_bw, beta, pairwise)
    kv_old = kv_matrix(q, old_x, old_sq, kind, inv_bw, beta, pairwise)
    blk = torch.div(slots, bn, rounding_mode="floor").long()
    out = bs.index_add(1, blk, kv_new - kv_old)
    return torch.clamp(out, min=BLOCK_SUM_FLOOR)


def live_degrees_ref(x, x_sq, live, kind: str, inv_bw: float, beta: float,
                     pairwise=None):
    """Exact degrees of a live-masked padded dataset (the rebuild oracle
    for ``ops.degree_delta``): dead slots get degree 0 and contribute no
    mass; live rows get the row sum minus the self kernel k(x, x) = 1."""
    q = torch.where(live[:, None], x, 0.0)     # dead-vs-dead would be NaN
    kv = kv_matrix(q, x, x_sq, kind, inv_bw, beta, pairwise)
    return torch.where(live, kv.sum(dim=1) - 1.0, 0.0)


def degree_delta_ref(degs, x, x_sq, slots, old_x, new_x, old_live, new_live,
                     kind: str, inv_bw: float, beta: float, pairwise=None):
    """Oracle of ``ops.degree_delta``: O(n m) incremental degree update.

    ``x`` / ``x_sq`` are the *post-mutation* padded arrays.  Unmutated rows
    receive the exact column delta sum_j [k(x_i, new_j) - k(x_i, old_j)];
    the mutated slots' own degrees are recomputed exactly from their new
    rows (dead slots get 0).  Forms the (m, n) value matrices whole.
    """
    old_q = torch.where(old_live[:, None], old_x, 0.0)
    new_q = torch.where(new_live[:, None], new_x, 0.0)
    a_new = kv_matrix(new_q, x, x_sq, kind, inv_bw, beta, pairwise) \
        * new_live[:, None]
    a_old = kv_matrix(old_q, x, x_sq, kind, inv_bw, beta, pairwise) \
        * old_live[:, None]
    out = degs + (a_new - a_old).sum(dim=0)
    row_new = torch.where(new_live, a_new.sum(dim=1) - 1.0, 0.0)
    return out.index_copy(0, slots.long(), row_new)
