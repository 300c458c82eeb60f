"""Device-resident depth-2 neighbor sampling programs (DESIGN.md §3).

Each program reads the level-1 block sums of a frontier through the CUDA
kernels on a CUDA tensor (the plain versions on a CPU tensor), then runs
the exact level-2 row and the in-block draw as plain torch ops on the same
device.  The level-1 read is exact (``level1="blocked"``, the masked
block-sum and sample-block kernels) or hashed (``level1="hash"``: the
``kde_hash`` padded-bucket estimator, whose ``HashState`` rides along as
the ``hstate`` operand and whose per-block FAR budget is ``num_far``;
DESIGN.md §10).  There is no host synchronisation inside a program; the reference's
``lax.scan`` over edge batches is a Python loop that keeps every tensor on
the device and copies to the host once at the end.

Every program's core takes its noise explicitly, so tests can feed the
JAX reference and the port identical numbers; the ``draw_*_noise``
helpers draw it from a ``torch.Generator`` for the public entry points.
A depth-2 step's noise is ``(gumbel (w, B), u_in (w,))`` on the exact read
and ``(off (w, B, num_far), u_blk (w,), u_in (w,))`` on the hashed read;
an edge batch puts ``u_vert (batch,)`` in front.  The exact read draws the
block by Gumbel-max inside the sample-block kernel, as the reference's
kernel path; the hashed read and the cached-sums path
(``sample_from_block_sums``) draw it by inverse CDF, as the reference
does.  Both are exact samplers of the same law.

Every program also returns the ``(obs.WIDTH,)`` counter word of the
reference for the same static shapes: slot 0 the status bits
(``ft.guards``), slots 1+ the realized kernel evaluations, level-1 reads
and draws.

Configuration keywords (static in the reference): ``kind``, ``inv_bw``,
``beta``, ``block_size``, ``num_blocks``, ``n``, ``level1``,
``num_far``.
"""
from __future__ import annotations

import torch

from repro_torch.ft import guards as _g
from repro_torch.kernels.kde_hash import ops as _hops
from repro_torch.kernels.kde_rowsum import kernel as _rk
from repro_torch.kernels.kde_sampler import kernel as _k
from repro_torch.kernels.kde_sampler import ref as _ref
from repro_torch.obs import counters as _c

FLOOR = _ref.BLOCK_SUM_FLOOR


# --------------------------------------------------------------------- #
# noise
# --------------------------------------------------------------------- #
def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel variates -log(-log(u)), u uniform on [tiny, 1) as
    ``jax.random.gumbel`` draws them."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def draw_sample_noise(w: int, num_blocks: int, generator, device, *,
                      level1="blocked", num_far=1, block_size=1):
    """The noise of one depth-2 step: ``(gumbel (w, B), u_in (w,))`` for
    the exact read, ``(off (w, B, num_far), u_blk (w,), u_in (w,))`` for
    the hashed read."""
    if level1 == "hash":
        off = _hops.draw_frontier_noise(w, num_blocks, num_far, block_size,
                                        generator, device)
        return (off, torch.rand(w, generator=generator, device=device),
                torch.rand(w, generator=generator, device=device))
    g = gumbel((w, num_blocks), generator, device)
    return g, torch.rand(w, generator=generator, device=device)


def draw_edge_noise(batch: int, num_blocks: int, generator, device, **kw):
    """``(u_vert (batch,),) + draw_sample_noise(...)`` for one edge
    batch."""
    u_vert = torch.rand(batch, generator=generator, device=device)
    return (u_vert,) + draw_sample_noise(batch, num_blocks, generator,
                                         device, **kw)


# --------------------------------------------------------------------- #
# level-1: (m, B) block-sum reads
# --------------------------------------------------------------------- #
def _l1_cols(level1, num_blocks, n, num_far, hstate):
    """(cols, far, overflow) realized PER FRONTIER ROW by one level-1 read
    -- the static shape products the counter words are built from: hashed
    reads sweep ``max_bucket + overflow_cap`` exact columns plus
    ``B * num_far`` stratified FAR slots, exact reads sweep ``n``."""
    if level1 == "hash":
        mb, ov = _hops._widths(hstate)
        far = int(num_blocks) * int(num_far)
        return mb + ov + far, far, ov
    return int(n), 0, 0


def stratified_block_sums(y, x, x_sq, u, *, kind, inv_bw, beta,
                          pairwise=None, block_size, num_blocks, n, s):
    """Per-block uniform-subsample estimates of the block sums, (m, B),
    with explicit uniforms ``u`` (B, block_size): each block's ``s``
    slots of smallest ``u`` (top-k without replacement) are its sample.
    Each block contributes ``size_b / s_b * sum(sampled values)`` with
    ``s_b`` the count of real (non-padded) samples.  Plain torch on every
    device, as in the reference.  Returns ``(block sums, counter word)``."""
    m = y.shape[0]
    dev = y.device
    base = torch.arange(num_blocks, device=dev) * block_size
    pos = base[:, None] + torch.arange(block_size, device=dev)[None, :]
    valid_pos = pos < n
    u = torch.where(valid_pos, u, torch.inf)      # invalid slots sort last
    order = torch.topk(-u, s, dim=1).indices      # (B, s) w/o replacement
    idx = torch.clamp(torch.gather(pos, 1, order), max=n - 1)
    sel_valid = torch.gather(valid_pos, 1, order)
    flat = idx.reshape(-1)
    kv = _ref.kv_matrix(y, x[flat], x_sq[flat], kind, inv_bw, beta,
                        pairwise).reshape(m, num_blocks, s) * sel_valid[None]
    sizes = torch.clamp(n - base, max=block_size).to(torch.float32)
    s_b = torch.clamp(sizes, max=float(s))
    bs = kv.sum(-1) * (sizes / torch.clamp(s_b, min=1.0))[None, :]
    return bs, _c.word(status=_g.nonfinite_status(bs),
                       evals=m * num_blocks * s, l1_reads=m)


def exact_block_sums(y, x, x_sq, *, kind, inv_bw, beta, block_size,
                     num_blocks, n):
    """Exact (m, B) block sums; returns ``(block sums, counter word)``.
    A CUDA tensor goes through the blocksum kernel and never forms the
    (m, n) matrix."""
    m = y.shape[0]
    fn = _rk.blocksum_cuda if y.is_cuda else _rk.blocksum_plain
    bs = fn(y, x, kind, inv_bw, beta, block_size)
    return bs, _c.word(status=_g.nonfinite_status(bs), evals=m * n,
                       l1_reads=m)


def _masked_sums_any(x, x_sq, src, off=None, hstate=None, *, kind, inv_bw,
                     beta, block_size, num_blocks, n, level1="blocked",
                     num_far=1):
    """Masked level-1 sums of a frontier: the masked-blocksum kernel on the
    exact read, the hashed estimator's read (weighted-kv kernel, FAR
    offsets ``off``) on ``level1="hash"``.  Returns ``(bs, status)``."""
    if level1 == "hash":
        return _hops._hashed_block_sums(
            x, src, hstate, off, kind=kind, inv_bw=inv_bw, beta=beta,
            num_far=num_far, block_size=block_size, num_blocks=num_blocks,
            n=n)
    fn = _k.masked_blocksum_cuda if x.is_cuda else _k.masked_blocksum_plain
    bs = fn(x[src], x, src // block_size, kind, inv_bw, beta, block_size)
    return bs, _g.sums_status(bs, FLOOR)


def masked_block_sums(x, x_sq, src, off=None, hstate=None, *, kind, inv_bw,
                      beta, block_size, num_blocks, n,
                      level1="blocked", num_far=1):
    """Level-1 read of a frontier ``src`` of dataset indices: block sums,
    own block corrected by k(x, x) = 1, floored at 1e-12 -- exact through
    the masked-blocksum kernel, or hashed (``level1="hash"``, FAR offsets
    ``off``).  Returns ``(bs, counter word)``."""
    bs, st = _masked_sums_any(x, x_sq, src, off, hstate, kind=kind,
                              inv_bw=inv_bw, beta=beta,
                              block_size=block_size, num_blocks=num_blocks,
                              n=n, level1=level1, num_far=num_far)
    w = src.shape[0]
    cols, far, ov = _l1_cols(level1, num_blocks, n, num_far, hstate)
    return bs, _c.word(status=st, evals=w * cols, l1_reads=w,
                       far_samples=w * far, overflow=w * ov)


def sample_block(q, x, own, gumbel_noise, *, kind, inv_bw, beta,
                 block_size):
    """Masked block sums plus the Gumbel-max block draw: (blk, p_blk, tot,
    bs), through the sample-block kernel on CUDA."""
    fn = _k.sample_block_cuda if q.is_cuda else _k.sample_block_plain
    return fn(q, x, own, gumbel_noise, kind, inv_bw, beta, block_size)


# --------------------------------------------------------------------- #
# depth-2 draws
# --------------------------------------------------------------------- #
def _fused_sample_core(x, x_sq, views, src, noise, hstate=None, *, kind,
                       inv_bw, beta, block_size, num_blocks, n,
                       level1="blocked", num_far=1):
    """(neighbors, realized probs, level-1 sums, status tensor) of one
    depth-2 step with explicit ``noise`` (see the module note); no host
    traffic (the counter word is built by the callers from static
    shapes)."""
    if level1 == "hash":
        off, u_blk, u_in = noise
        bs, st = _masked_sums_any(x, x_sq, src, off, hstate, kind=kind,
                                  inv_bw=inv_bw, beta=beta,
                                  block_size=block_size,
                                  num_blocks=num_blocks, n=n, level1=level1,
                                  num_far=num_far)
        nb, prob = _ref.sample_from_sums(x, x_sq, views, src, bs, u_blk,
                                         u_in, kind, inv_bw, beta,
                                         block_size, n)
        return nb, prob, bs, st | _g.result_status(prob)
    gumbel_noise, u_in = noise
    blk, pb, _, bs = sample_block(x[src], x, src // block_size,
                                  gumbel_noise, kind=kind, inv_bw=inv_bw,
                                  beta=beta, block_size=block_size)
    kv, live, cols_c = _ref.level2_row(x, x_sq, views, src, blk, kind,
                                       inv_bw, beta, block_size, n)
    nb, pin = _ref.level2_draw(kv, live, cols_c, u_in)
    prob = pb * pin
    return nb, prob, bs, _g.sums_status(bs, FLOOR) | _g.result_status(prob)


def fused_sample(x, x_sq, src, *noise, views=None, hstate=None, kind,
                 inv_bw, beta, block_size, num_blocks, n,
                 level1="blocked", num_far=1):
    """One depth-2 sampling step with explicit noise: the level-1 read and
    block draw (one sample-block kernel call on the exact read; the
    hashed read then an inverse-CDF draw on ``level1="hash"``), then the
    exact level-2 row and the in-block draw.  Returns (neighbors, realized
    probs, level-1 sums, counter word)."""
    if views is None:
        views = _ref.block_views(x, x_sq, block_size)
    w = src.shape[0]
    nb, prob, bs, st = _fused_sample_core(
        x, x_sq, views, src, noise, hstate, kind=kind, inv_bw=inv_bw,
        beta=beta, block_size=block_size, num_blocks=num_blocks, n=n,
        level1=level1, num_far=num_far)
    # one level-1 read of the w-frontier + w exact level-2 rows
    cols, far, ov = _l1_cols(level1, num_blocks, n, num_far, hstate)
    cw = _c.word(status=st, evals=w * (cols + block_size), l1_reads=w,
                 draws=w, far_samples=w * far, overflow=w * ov)
    return nb, prob, bs, cw


def sample_from_block_sums(x, x_sq, src, bs, u_blk, u_in, views=None, *,
                           kind, inv_bw, beta, block_size, n):
    """Depth-2 step reusing cached level-1 sums (no dataset re-sweep):
    inverse-CDF block draw with uniforms ``u_blk``.  Returns (neighbors,
    realized probs, counter word)."""
    if views is None:
        views = _ref.block_views(x, x_sq, block_size)
    nb, prob = _ref.sample_from_sums(x, x_sq, views, src, bs, u_blk, u_in,
                                     kind, inv_bw, beta, block_size, n)
    st = _g.sums_status(bs, FLOOR) | _g.result_status(prob)
    w = src.shape[0]
    return nb, prob, _c.word(status=st, evals=w * block_size, draws=w)


def prob_of_from_block_sums(x, x_sq, src, dst, bs, views=None, *, kind,
                            inv_bw, beta, block_size, n):
    """q(dst | src) the sampler assigns, from cached level-1 sums; mirrors
    ``ref.level2_draw``'s zero-row guard (an underflowed block row is
    drawn uniformly over its live columns).  Returns ``(probs, word)``."""
    if views is None:
        views = _ref.block_views(x, x_sq, block_size)
    blk = dst // block_size
    pb = torch.gather(bs, 1, blk[:, None])[:, 0] / bs.sum(dim=1)
    kv, live, _ = _ref.level2_row(x, x_sq, views, src, blk, kind, inv_bw,
                                  beta, block_size, n)
    col = (dst - blk * block_size)[:, None]
    kd = torch.gather(kv, 1, col)[:, 0]
    rowsum = kv.sum(dim=1)
    live_d = torch.gather(live, 1, col)[:, 0].to(kv.dtype)
    pin_fallback = live_d / torch.clamp(live.sum(dim=1).to(kv.dtype),
                                        min=1.0)
    pin = torch.where(rowsum > 0.0, kd / torch.clamp(rowsum, min=1e-30),
                      pin_fallback)
    prob = pb * pin
    st = _g.sums_status(bs, FLOOR) | _g.result_status(prob)
    return prob, _c.word(status=st, evals=src.shape[0] * block_size)


# --------------------------------------------------------------------- #
# fused Algorithm 5.1 edge batches + LRA sketch rows
# --------------------------------------------------------------------- #
def _edge_batch_core(x, x_sq, views, cdf, degs, inv_total, inv_t, u_vert,
                     noise, hstate=None, *, kind, inv_bw, beta, block_size,
                     num_blocks, n, level1="blocked", num_far=1):
    """Algorithm 5.1 steps (a)-(d) for one batch with explicit noise:
    u ~ degrees (inverse CDF over the device prefix array), v | u by the
    depth-2 engine, the collapsed reverse probability q(u | v) =
    k(u,v)/deg(v), and the weight ``k(u,v) / (t (p_u q_uv + p_v q_vu))``.
    Returns (u, v, wgt, q_uv, q_vu, status tensor)."""
    u = _ref.inverse_cdf_index(cdf, u_vert)
    v, q_uv, _, st = _fused_sample_core(
        x, x_sq, views, u, noise, hstate, kind=kind, inv_bw=inv_bw,
        beta=beta, block_size=block_size, num_blocks=num_blocks, n=n,
        level1=level1, num_far=num_far)
    kuv = _ref.kv_pairs(x[u], x[v], kind, inv_bw, beta)
    q_vu = kuv / torch.clamp(degs[v], min=FLOOR)
    # q_e = p_u q_uv + p_v q_vu with p_i = deg_i / sum(deg); the second
    # term telescopes to k(u,v) / sum(deg).
    q_edge = inv_total * (degs[u] * q_uv + kuv)
    wgt = kuv * inv_t / torch.clamp(q_edge, min=1e-30)
    return u, v, wgt, q_uv, q_vu, st | _g.result_status(wgt, q_vu)


def _edge_batch_word(status, batch: int, cols: int, far: int, ov: int,
                     block_size: int):
    # fused_sample's word + the batch aligned k(u,v) pairs + the batch
    # inverse-CDF u draws (host accounting: level1 + batch*bs + batch)
    return _c.word(status=status, evals=batch * (cols + block_size) + batch,
                   l1_reads=batch, draws=2 * batch, far_samples=batch * far,
                   overflow=batch * ov)


def fused_edge_batch(x, x_sq, cdf, degs, inv_total, inv_t, u_vert, *noise,
                     views=None, hstate=None, kind, inv_bw, beta,
                     block_size, num_blocks, n, level1="blocked",
                     num_far=1):
    """One fused Algorithm 5.1 edge batch with explicit noise ``u_vert``
    then the depth-2 step's noise: (u, v, weight, q_uv, q_vu, counter
    word)."""
    if views is None:
        views = _ref.block_views(x, x_sq, block_size)
    *out, st = _edge_batch_core(x, x_sq, views, cdf, degs, inv_total, inv_t,
                                u_vert, noise, hstate, kind=kind,
                                inv_bw=inv_bw, beta=beta,
                                block_size=block_size,
                                num_blocks=num_blocks, n=n, level1=level1,
                                num_far=num_far)
    cols, far, ov = _l1_cols(level1, num_blocks, n, num_far, hstate)
    return (*out, _edge_batch_word(st, u_vert.shape[0], cols, far, ov,
                                   block_size))


def edge_batch_scan(x, x_sq, cdf, degs, inv_total, inv_t, generator,
                    num_batches: int, hstate=None, *, batch, kind, inv_bw,
                    beta, block_size, num_blocks, n,
                    level1="blocked", num_far=1):
    """All ``num_batches`` edge batches of a sparsifier call: a device
    loop whose body is one fused edge batch, noise drawn per batch from
    ``generator``.  Returns ((T, batch) u, v, wgt, q_uv, q_vu on the
    device, merged counter word); statuses or-fold on the device, so the
    loop never synchronises."""
    views = _ref.block_views(x, x_sq, block_size)
    dev = x.device
    ints = [torch.empty((num_batches, batch), dtype=torch.int64, device=dev)
            for _ in range(2)]
    floats = [torch.empty((num_batches, batch), dtype=torch.float32,
                          device=dev) for _ in range(3)]
    outs = ints + floats
    st = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(num_batches):
        u_vert, *noise = draw_edge_noise(batch, num_blocks, generator, dev,
                                         level1=level1, num_far=num_far,
                                         block_size=block_size)
        *res, s_i = _edge_batch_core(x, x_sq, views, cdf, degs, inv_total,
                                     inv_t, u_vert, noise, hstate, kind=kind,
                                     inv_bw=inv_bw, beta=beta,
                                     block_size=block_size,
                                     num_blocks=num_blocks, n=n,
                                     level1=level1, num_far=num_far)
        for o, r in zip(outs, res):
            o[i] = r
        st = st | s_i
    cols, far, ov = _l1_cols(level1, num_blocks, n, num_far, hstate)
    word = _c.scale(_edge_batch_word(st, batch, cols, far, ov, block_size),
                    num_batches)
    return (*outs, word)


def kernel_rows(q, x, x_sq, *, kind, inv_bw, beta):
    """Exact (m, n) kernel rows -- the FKV sketch rows and the CP17 column
    reads of Section 5.2 (plain torch on every device, as the reference
    leaves them outside any kernel).  Returns ``(rows, counter word)``."""
    kv = _ref.kv_matrix(q, x, x_sq, kind, inv_bw, beta)
    return kv, _c.word(status=_g.nonfinite_status(kv),
                       evals=q.shape[0] * x.shape[0])
