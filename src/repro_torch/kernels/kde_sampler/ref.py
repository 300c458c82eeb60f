"""Plain-torch kernel-value math and draw stages of the depth-2 sampler.

The torch mirror of ``repro.kernels.kde_sampler.ref``: the evaluation
half (``kv_matrix`` / ``kv_rows`` / ``kv_pairs``) and the draw half
(inverse CDF, block views, the exact level-2 row and its in-block draw,
and the oracles of the level-1 kernels).  Every function takes explicit
noise (uniforms, Gumbel variates) instead of a key, so tests can feed the
JAX reference and the port the same numbers.
"""
from __future__ import annotations

import torch

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


def kv_matrix(q, x, x_sq, kind: str, inv_bw: float, beta: float,
              pairwise=None) -> torch.Tensor:
    """(m, n) kernel values; L2 kinds reuse precomputed ``x_sq``.  Unknown
    kinds fall back to the ``pairwise`` callable."""
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
               beta: float, block_size: int, n: int, pairwise=None):
    """Exact kernel row of each source against its chosen block, with the
    self edge and out-of-range tail columns masked to 0."""
    xb_all, xb_sq_all = views
    lo = blk * block_size
    cols = lo[:, None] + torch.arange(block_size, device=blk.device)[None, :]
    kv = kv_rows(x[src], xb_all[blk], x_sq[src], xb_sq_all[blk], kind,
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


def sample_from_sums(x, x_sq, views, src, bs, u_blk, u_in, kind: str,
                     inv_bw: float, beta: float, block_size: int, n: int,
                     pairwise=None):
    """One depth-2 draw from given level-1 sums ``bs``: inverse-CDF block
    draw (uniforms ``u_blk``) -> exact level-2 row -> in-block draw
    (uniforms ``u_in``).  Returns (neighbors, realized probabilities)."""
    blk, pb = choose_block(bs, u_blk)
    kv, live, cols_c = level2_row(x, x_sq, views, src, blk, kind, inv_bw,
                                  beta, block_size, n, pairwise)
    nb, pin = level2_draw(kv, live, cols_c, u_in)
    return nb, pb * pin


def masked_exact_sums_ref(q, x, x_sq, own, kind: str, inv_bw: float,
                          beta: float, bn: int, n: int, pairwise=None):
    """Masked level-1 sums by one dense sweep over the unpadded dataset,
    zero-padded to a block multiple, own-block corrected by the self
    kernel k(x, x) = 1, floored."""
    m = q.shape[0]
    kv = kv_matrix(q, x, x_sq, kind, inv_bw, beta, pairwise)
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
