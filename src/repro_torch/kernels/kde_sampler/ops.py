"""Device-resident depth-2 neighbor sampling programs (DESIGN.md §3).

Each program reads the level-1 block sums of a frontier, then runs the
exact level-2 row and the in-block draw as plain torch ops on the same
device.  Three level-1 reads are ported:

* exact (``level1="blocked", exact=True``): the masked block-sum and
  sample-block CUDA kernels on a CUDA tensor (their plain versions on a
  CPU tensor);
* stratified (``level1="blocked", exact=False``, the reference's default):
  ``s`` subsampled rows a block, plain torch on every device as in the
  reference (``stratified_block_sums``; its cross term is a cuBLAS GEMM in
  IEEE f32);
* hashed (``level1="hash"``): the ``kde_hash`` padded-bucket estimator,
  whose ``HashState`` rides along as the ``hstate`` operand and whose
  per-block FAR budget is ``num_far`` (DESIGN.md §10).

There is no host synchronisation inside a program; the reference's
``lax.scan`` over edge batches is a Python loop that keeps every tensor on
the device and copies to the host once at the end.

Every program's core takes its noise explicitly, so tests can feed the
JAX reference and the port identical numbers; the ``draw_*_noise``
helpers draw it from a ``torch.Generator`` for the public entry points.
A depth-2 step's noise is ``(gumbel (w, B), u_in (w,))`` on the exact
read, ``(u_strat (B, block_size), u_blk (w,), u_in (w,))`` on the
stratified read and ``(off (w, B, num_far), u_blk (w,), u_in (w,))`` on
the hashed read; an edge batch puts ``u_vert (batch,)`` in front.  The
exact read draws the block by Gumbel-max inside the sample-block kernel,
as the reference's kernel path; the stratified and hashed reads and the
cached-sums path (``sample_from_block_sums``) draw it by inverse CDF, as
the reference does.  Both are exact samplers of the same law.  The
Theorem 4.12 rejection rounds (``fused_sample_exact``) take ``(u_blk
(rounds + 1, w), u_in (rounds + 1, w), u_acc (rounds, w))``: row 0 is the
round-0 proposal, row r + 1 and ``u_acc[r]`` round r's.

Walks (``walk_scan``, Algorithm 4.16) loop over their steps in Python on
the device, with the noise of every step given up front
(``draw_walk_noise``); a stratified walk reads level 1 from a subsample
cached once a walk (the walk-resident layout of ``walk_layout``) and
draws by the two-level inverse CDF.  The application programs (noisy
power, the Laplacian matvec and CG solve, the endpoint statistic, the
triangle edge scan) follow the reference's ``ops`` one for one.

Every program also returns the ``(obs.WIDTH,)`` counter word of the
reference for the same static shapes: slot 0 the status bits
(``ft.guards``), slots 1+ the realized kernel evaluations, level-1 reads,
draws and rejection fallbacks.

Configuration keywords (static in the reference): ``kind``, ``inv_bw``,
``beta``, ``block_size``, ``num_blocks``, ``n``, ``s`` (rows a block on
the stratified read), ``exact``, ``level1``, ``num_far``, ``rounds``,
``slack``, ``precision``.  ``precision="bf16"`` (DESIGN.md §14) changes
the level-1 reads only, as in the reference: the bf16 instances of the
blocksum, masked-blocksum, sample-block and weighted-kv kernels, and the
bf16 values in the stratified read's plain torch sweep.  Level-2 rows,
CDFs, draws, probabilities and the aligned k(u, v) pairs stay f32.
"""
from __future__ import annotations

import torch

from repro_torch.ft import guards as _g
from repro_torch.kernels import tuning as _tuning
from repro_torch.kernels.kde_hash import ops as _hops
from repro_torch.kernels.kde_rowsum import kernel as _rk
from repro_torch.kernels.kde_sampler import kernel as _k
from repro_torch.kernels.kde_sampler import ref as _ref
from repro_torch.obs import counters as _c

FLOOR = _ref.BLOCK_SUM_FLOOR


def custom_kind(pairwise) -> bool:
    """Whether a read evaluates a custom kind: ``pairwise`` is the
    kernel's own callable (``ref.static_pairwise``; None for the built-in
    kinds).  No CUDA kernel can evaluate a Python closure, so such a read
    runs the plain version on every device, the card included, and
    launches no kernel: a dispatch by kind, as the reference's Pallas
    kernels take the built-in kinds only (ROADMAP.md section 3)."""
    return pairwise is not None


# --------------------------------------------------------------------- #
# noise
# --------------------------------------------------------------------- #
def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel variates -log(-log(u)), u uniform on [tiny, 1) as
    ``jax.random.gumbel`` draws them."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _level1_noise(w: int, num_blocks: int, generator, device, *, level1,
                  exact, num_far, block_size):
    """The noise of one level-1 read of a w-frontier: FAR offsets (w, B,
    num_far) on the hashed read, subsample uniforms (B, block_size) on the
    stratified read, None on the exact read."""
    if level1 == "hash":
        return _hops.draw_frontier_noise(w, num_blocks, num_far, block_size,
                                         generator, device)
    if not exact:
        return torch.rand((num_blocks, block_size), generator=generator,
                          device=device)
    return None


def draw_sample_noise(w: int, num_blocks: int, generator, device, *,
                      level1="blocked", exact, num_far=64, block_size=1):
    """The noise of one depth-2 step: ``(gumbel (w, B), u_in (w,))`` for
    the exact read, ``(level-1 noise, u_blk (w,), u_in (w,))`` for the
    stratified and hashed reads."""
    if level1 != "hash" and exact:
        g = gumbel((w, num_blocks), generator, device)
        return g, torch.rand(w, generator=generator, device=device)
    l1 = _level1_noise(w, num_blocks, generator, device, level1=level1,
                       exact=exact, num_far=num_far, block_size=block_size)
    return (l1, torch.rand(w, generator=generator, device=device),
            torch.rand(w, generator=generator, device=device))


def draw_edge_noise(batch: int, num_blocks: int, generator, device, **kw):
    """``(u_vert (batch,),) + draw_sample_noise(...)`` for one edge
    batch."""
    u_vert = torch.rand(batch, generator=generator, device=device)
    return (u_vert,) + draw_sample_noise(batch, num_blocks, generator,
                                         device, **kw)


def draw_exact_noise(w: int, rounds: int, generator, device):
    """The noise of ``fused_sample_exact``: ``(u_blk (rounds + 1, w), u_in
    (rounds + 1, w), u_acc (rounds, w))``."""
    return tuple(torch.rand((r, w), generator=generator, device=device)
                 for r in (rounds + 1, rounds + 1, rounds))


# --------------------------------------------------------------------- #
# level-1: (m, B) block-sum reads
# --------------------------------------------------------------------- #
def _l1_cols(level1, exact, num_blocks, s, n, num_far, hstate):
    """(cols, far, overflow) realized PER FRONTIER ROW by one level-1 read
    -- the static shape products the counter words are built from: hashed
    reads sweep ``max_bucket + overflow_cap`` exact columns plus
    ``B * num_far`` stratified FAR slots, blocked reads sweep ``n``
    (exact) or ``B * s`` (stratified)."""
    if level1 == "hash":
        mb, ov = _hops._widths(hstate)
        far = int(num_blocks) * int(num_far)
        return mb + ov + far, far, ov
    return (int(n) if exact else int(num_blocks) * int(s)), 0, 0


def stratified_columns(u, *, block_size, num_blocks, n, s):
    """The subsample of a stratified read, from explicit uniforms ``u``
    (B, block_size): each block's ``s`` slots of smallest ``u`` (top-k
    without replacement; slots past n sort last).  Returns ``(rows (B s,)
    dataset indices, valid (B, s) real-sample mask, scale (B,))`` with
    scale = size_b / s_b, ``s_b`` the block's count of real samples.
    Leading axes of ``u`` (one subsample a request) carry through."""
    dev = u.device
    base = torch.arange(num_blocks, device=dev) * block_size
    pos = base[:, None] + torch.arange(block_size, device=dev)[None, :]
    valid_pos = pos < n
    u = torch.where(valid_pos, u, torch.inf)      # invalid slots sort last
    order = torch.topk(-u, s, dim=-1).indices     # (B, s) w/o replacement
    idx = torch.clamp(torch.gather(pos.expand(u.shape), -1, order),
                      max=n - 1)
    valid = torch.gather(valid_pos.expand(u.shape), -1, order)
    sizes = torch.clamp(n - base, max=block_size).to(torch.float32)
    s_b = torch.clamp(sizes, max=float(s))
    return idx.flatten(-2), valid, sizes / torch.clamp(s_b, min=1.0)


def stratified_block_sums(y, x, x_sq, u, *, kind, inv_bw, beta,
                          pairwise=None, block_size, num_blocks, n, s,
                          precision="f32"):
    """Per-block uniform-subsample estimates of the block sums, (m, B),
    with explicit uniforms ``u`` (B, block_size) (``stratified_columns``):
    each block contributes ``size_b / s_b * sum(sampled values)``.  Plain
    torch on every device, as in the reference; the subsample is the same
    at either precision, only the gathered values take ``precision``.
    Returns ``(block sums, counter word)``."""
    m = y.shape[0]
    rows, valid, scale = stratified_columns(u, block_size=block_size,
                                            num_blocks=num_blocks, n=n, s=s)
    kv = _ref.kv_matrix(y, x[rows], x_sq[rows], kind, inv_bw, beta,
                        pairwise, precision).reshape(m, num_blocks, s) \
        * valid[None]
    bs = kv.sum(-1) * scale[None, :]
    return bs, _c.word(status=_g.nonfinite_status(bs),
                       evals=m * num_blocks * s, l1_reads=m)


def exact_block_sums(y, x, x_sq, *, kind, inv_bw, beta, pairwise=None,
                     block_size, num_blocks, n, precision="f32"):
    """Exact (m, B) block sums; returns ``(block sums, counter word)``.
    A CUDA tensor goes through the blocksum kernel (its bf16 instance at
    ``precision="bf16"``) and never forms the (m, n) matrix; a custom
    kind sums its ``pairwise`` values (``custom_kind``)."""
    m = y.shape[0]
    if custom_kind(pairwise):
        kv = _ref.kv_matrix(y, x, x_sq, kind, inv_bw, beta, pairwise,
                            precision)
        bs = torch.nn.functional.pad(kv, (0, -n % block_size)).reshape(
            m, -1, block_size).sum(-1)
    else:
        fn = _rk.blocksum_cuda if y.is_cuda else _rk.blocksum_plain
        bs = fn(y, x, kind, inv_bw, beta, block_size, precision)
    return bs, _c.word(status=_g.nonfinite_status(bs), evals=m * n,
                       l1_reads=m)


def _own_correct(bs, src, block_size: int, num_blocks: int):
    """Own block less k(x, x) = 1, floored (the masked reads' finish)."""
    own = src // block_size
    corr = torch.arange(num_blocks, device=src.device)[None, :] \
        == own[:, None]
    return torch.clamp(torch.where(corr, bs - 1.0, bs), min=FLOOR)


def _stratified_masked_sums(x, x_sq, src, u, *, kind, inv_bw, beta,
                            pairwise=None, block_size, num_blocks, n, s,
                            precision="f32"):
    """Stratified level-1 sums of a frontier, own block corrected by
    k(x, x) = 1 and floored (the reference's ``_masked_block_sums(exact=
    False)``)."""
    bs, _ = stratified_block_sums(x[src], x, x_sq, u, kind=kind,
                                  inv_bw=inv_bw, beta=beta,
                                  pairwise=pairwise, block_size=block_size,
                                  num_blocks=num_blocks, n=n, s=s,
                                  precision=precision)
    return _own_correct(bs, src, block_size, num_blocks)


def _masked_sums_any(x, x_sq, src, l1_noise=None, hstate=None, *, kind,
                     inv_bw, beta, pairwise=None, block_size, num_blocks, n,
                     s, exact, level1="blocked", num_far=64,
                     precision="f32"):
    """Masked level-1 sums of a frontier: the masked-blocksum kernel on the
    exact read, ``s`` subsampled rows a block on the stratified read
    (uniforms ``l1_noise``), the hashed estimator's read (weighted-kv
    kernel, FAR offsets ``l1_noise``) on ``level1="hash"``.  Returns
    ``(bs, status)``."""
    if level1 == "hash":
        return _hops._hashed_block_sums(
            x, src, hstate, l1_noise, kind=kind, inv_bw=inv_bw, beta=beta,
            pairwise=pairwise, num_far=num_far, block_size=block_size,
            num_blocks=num_blocks, n=n, precision=precision)
    if exact and custom_kind(pairwise):
        bs = _ref.masked_exact_sums_ref(x[src], x, x_sq, src // block_size,
                                        kind, inv_bw, beta, block_size, n,
                                        pairwise, precision)
    elif exact:
        fn = (_k.masked_blocksum_cuda if x.is_cuda
              else _k.masked_blocksum_plain)
        bs = fn(x[src], x, src // block_size, kind, inv_bw, beta, block_size,
                precision)
    else:
        bs = _stratified_masked_sums(x, x_sq, src, l1_noise, kind=kind,
                                     inv_bw=inv_bw, beta=beta,
                                     pairwise=pairwise, block_size=block_size,
                                     num_blocks=num_blocks, n=n, s=s,
                                     precision=precision)
    return bs, _g.sums_status(bs, FLOOR)


def masked_block_sums(x, x_sq, src, l1_noise=None, hstate=None, *, kind,
                      inv_bw, beta, pairwise, block_size, num_blocks, n, s,
                      exact, level1="blocked", num_far=64, precision="f32"):
    """Level-1 read of a frontier ``src`` of dataset indices: block sums,
    own block corrected by k(x, x) = 1, floored at 1e-12 -- exact through
    the masked-blocksum kernel, stratified (``exact=False``: ``s`` rows a
    block, subsample uniforms ``l1_noise``), or hashed (``level1="hash"``,
    FAR offsets ``l1_noise``).  Returns ``(bs, counter word)``."""
    bs, st = _masked_sums_any(x, x_sq, src, l1_noise, hstate, kind=kind,
                              inv_bw=inv_bw, beta=beta, pairwise=pairwise,
                              block_size=block_size, num_blocks=num_blocks,
                              n=n, s=s, exact=exact, level1=level1,
                              num_far=num_far, precision=precision)
    w = src.shape[0]
    cols, far, ov = _l1_cols(level1, exact, num_blocks, s, n, num_far,
                             hstate)
    return bs, _c.word(status=st, evals=w * cols, l1_reads=w,
                       far_samples=w * far, overflow=w * ov)


def sample_block(q, x, own, gumbel_noise, *, kind, inv_bw, beta,
                 pairwise=None, block_size, precision="f32"):
    """Masked block sums plus the Gumbel-max block draw: (blk, p_blk, tot,
    bs), through the sample-block kernel on CUDA (a custom kind: its
    ``pairwise`` sums and the same draw, on every device)."""
    if custom_kind(pairwise):
        bs = _ref.masked_exact_sums_ref(q, x, None, own, kind, inv_bw, beta,
                                        block_size, x.shape[0], pairwise,
                                        precision)
        return (*_ref.argmax_draw(bs, gumbel_noise), bs)
    fn = _k.sample_block_cuda if q.is_cuda else _k.sample_block_plain
    return fn(q, x, own, gumbel_noise, kind, inv_bw, beta, block_size,
              precision)


# --------------------------------------------------------------------- #
# depth-2 draws
# --------------------------------------------------------------------- #
def _fused_sample_core(x, x_sq, views, src, noise, hstate=None, *, kind,
                       inv_bw, beta, pairwise=None, block_size, num_blocks,
                       n, s, exact, level1="blocked", num_far=64,
                       precision="f32"):
    """(neighbors, realized probs, level-1 sums, status tensor) of one
    depth-2 step with explicit ``noise`` (see the module note); no host
    traffic (the counter word is built by the callers from static
    shapes)."""
    if level1 == "hash" or not exact:
        l1_noise, u_blk, u_in = noise
        bs, st = _masked_sums_any(x, x_sq, src, l1_noise, hstate, kind=kind,
                                  inv_bw=inv_bw, beta=beta,
                                  pairwise=pairwise, block_size=block_size,
                                  num_blocks=num_blocks, n=n, s=s,
                                  exact=exact, level1=level1,
                                  num_far=num_far, precision=precision)
        nb, prob = _ref.sample_from_sums(x, x_sq, views, src, bs, u_blk,
                                         u_in, kind, inv_bw, beta,
                                         block_size, n, pairwise)
        return nb, prob, bs, st | _g.result_status(prob)
    gumbel_noise, u_in = noise
    blk, pb, _, bs = sample_block(x[src], x, src // block_size,
                                  gumbel_noise, kind=kind, inv_bw=inv_bw,
                                  beta=beta, pairwise=pairwise,
                                  block_size=block_size, precision=precision)
    kv, live, cols_c = _ref.level2_row(x, x_sq, views, src, blk, kind,
                                       inv_bw, beta, block_size, n, pairwise)
    nb, pin = _ref.level2_draw(kv, live, cols_c, u_in)
    prob = pb * pin
    return nb, prob, bs, _g.sums_status(bs, FLOOR) | _g.result_status(prob)


def fused_sample(x, x_sq, src, *noise, views=None, hstate=None, kind,
                 inv_bw, beta, pairwise, block_size, num_blocks, n, s, exact,
                 level1="blocked", num_far=64, precision="f32"):
    """One depth-2 sampling step with explicit noise: the level-1 read and
    block draw (one sample-block kernel call on the exact read; the
    stratified or hashed read then an inverse-CDF draw otherwise), then
    the exact level-2 row and the in-block draw.  Returns (neighbors,
    realized probs, level-1 sums, counter word)."""
    if views is None:
        views = _ref.block_views(x, x_sq, block_size)
    w = src.shape[0]
    nb, prob, bs, st = _fused_sample_core(
        x, x_sq, views, src, noise, hstate, kind=kind, inv_bw=inv_bw,
        beta=beta, pairwise=pairwise, block_size=block_size,
        num_blocks=num_blocks, n=n, s=s, exact=exact, level1=level1,
        num_far=num_far, precision=precision)
    # one level-1 read of the w-frontier + w exact level-2 rows
    cols, far, ov = _l1_cols(level1, exact, num_blocks, s, n, num_far,
                             hstate)
    cw = _c.word(status=st, evals=w * (cols + block_size), l1_reads=w,
                 draws=w, far_samples=w * far, overflow=w * ov)
    return nb, prob, bs, cw


def sample_from_block_sums(x, x_sq, src, bs, u_blk, u_in, views=None, *,
                           kind, inv_bw, beta, pairwise=None, block_size, n):
    """Depth-2 step reusing cached level-1 sums (no dataset re-sweep):
    inverse-CDF block draw with uniforms ``u_blk``.  Returns (neighbors,
    realized probs, counter word)."""
    if views is None:
        views = _ref.block_views(x, x_sq, block_size)
    nb, prob = _ref.sample_from_sums(x, x_sq, views, src, bs, u_blk, u_in,
                                     kind, inv_bw, beta, block_size, n,
                                     pairwise)
    st = _g.sums_status(bs, FLOOR) | _g.result_status(prob)
    w = src.shape[0]
    return nb, prob, _c.word(status=st, evals=w * block_size, draws=w)


def prob_of_from_block_sums(x, x_sq, src, dst, bs, views=None, *, kind,
                            inv_bw, beta, pairwise=None, block_size, n):
    """q(dst | src) the sampler assigns, from cached level-1 sums; mirrors
    ``ref.level2_draw``'s zero-row guard (an underflowed block row is
    drawn uniformly over its live columns).  Returns ``(probs, word)``."""
    if views is None:
        views = _ref.block_views(x, x_sq, block_size)
    prob = _prob_core(x, x_sq, views, src, dst, bs, kind=kind,
                      inv_bw=inv_bw, beta=beta, pairwise=pairwise,
                      block_size=block_size, n=n)
    st = _g.sums_status(bs, FLOOR) | _g.result_status(prob)
    return prob, _c.word(status=st, evals=src.shape[0] * block_size)


def _prob_core(x, x_sq, views, src, dst, bs, *, kind, inv_bw, beta,
               pairwise=None, block_size, n, off=None):
    """The probabilities of ``prob_of_from_block_sums`` (``off``: the
    stacked tenants' offsets of ``ref.level2_row``)."""
    blk = dst // block_size
    pb = torch.gather(bs, 1, blk[:, None])[:, 0] / bs.sum(dim=1)
    kv, live, _ = _ref.level2_row(x, x_sq, views, src, blk, kind, inv_bw,
                                  beta, block_size, n, pairwise, off)
    col = (dst - blk * block_size)[:, None]
    kd = torch.gather(kv, 1, col)[:, 0]
    rowsum = kv.sum(dim=1)
    live_d = torch.gather(live, 1, col)[:, 0].to(kv.dtype)
    pin_fallback = live_d / torch.clamp(live.sum(dim=1).to(kv.dtype),
                                        min=1.0)
    pin = torch.where(rowsum > 0.0, kd / torch.clamp(rowsum, min=1e-30),
                      pin_fallback)
    return pb * pin


def _sample_exact_core(x, x_sq, views, src, bs, u_blk, u_in, u_acc, *,
                       kind, inv_bw, beta, pairwise=None, block_size, n,
                       rounds, slack, off=None, lanes=None):
    """Theorem 4.12 accept/reject rounds on cached level-1 sums: propose
    from ``bs`` and accept v with probability min(1, k(u, v) / (slack q(v)
    Z_hat)), Z_hat = sum of the (own-block corrected, floored) sums.
    Returns (neighbors, status tensor, fallback count tensor); a row whose
    rounds all reject keeps the round-0 proposal.  ``off``: the stacked
    tenants' offsets of ``ref.level2_row``; ``lanes``: the status and
    fallbacks come per lane of that many equal row runs."""
    zs = bs.sum(dim=1)
    cur, _ = _ref.sample_from_sums(x, x_sq, views, src, bs, u_blk[0],
                                   u_in[0], kind, inv_bw, beta, block_size,
                                   n, pairwise, off)
    accepted = torch.zeros(src.shape[0], dtype=torch.bool,
                           device=src.device)
    base = 0 if off is None else off[0]
    xs = x[base + src]
    for r in range(rounds):
        cand, q = _ref.sample_from_sums(x, x_sq, views, src, bs,
                                        u_blk[r + 1], u_in[r + 1], kind,
                                        inv_bw, beta, block_size, n,
                                        pairwise, off)
        kuv = _ref.kv_pairs(xs, x[base + cand], kind, inv_bw, beta,
                            pairwise)
        ratio = kuv / torch.clamp(slack * q * zs, min=1e-30)
        acc = ~accepted & (u_acc[r] < torch.clamp(ratio, max=1.0))
        cur = torch.where(acc, cand, cur)
        accepted |= acc
    if lanes is not None:
        fallbacks = (~accepted).reshape(lanes, -1).sum(dim=1)
    else:
        fallbacks = torch.sum(~accepted)
    return cur, _g.flag_if(fallbacks > 0, _g.REJECT_EXHAUSTED), fallbacks


def fused_sample_exact(x, x_sq, src, bs, u_blk, u_in, u_acc, views=None, *,
                       kind, inv_bw, beta, pairwise=None, block_size, n,
                       rounds, slack):
    """Theorem 4.12 rejection rounds with explicit noise (see the module
    note).  The cached level-1 sums ``bs`` of the frontier serve every
    proposal round and the degree estimate.  Returns (neighbors, counter
    word, fallback count): draws whose rounds all rejected keep the
    round-0 proposal (biased) and are counted in the word's RETRIES slot
    and flagged REJECT_EXHAUSTED, not hidden."""
    w = src.shape[0]
    shapes = {"u_blk": (u_blk, rounds + 1), "u_in": (u_in, rounds + 1),
              "u_acc": (u_acc, rounds)}
    for name, (u, r) in shapes.items():
        if tuple(u.shape) != (r, w):
            raise ValueError(f"{name} must be ({r}, {w}), got "
                             f"{tuple(u.shape)}")
    if views is None:
        views = _ref.block_views(x, x_sq, block_size)
    cur, st, fallbacks = _sample_exact_core(
        x, x_sq, views, src, bs, u_blk, u_in, u_acc, kind=kind,
        inv_bw=inv_bw, beta=beta, pairwise=pairwise, block_size=block_size,
        n=n, rounds=rounds, slack=slack)
    # (rounds + 1) level-2 rows + rounds aligned accept pairs
    cw = _c.word(status=st | _g.sums_status(bs, FLOOR),
                 evals=(rounds + 1) * w * block_size + rounds * w,
                 draws=(rounds + 1) * w)
    cw[_c.RETRIES] = fallbacks
    return cur, cw, fallbacks


# --------------------------------------------------------------------- #
# fused Algorithm 5.1 edge batches + LRA sketch rows
# --------------------------------------------------------------------- #
def _edge_batch_core(x, x_sq, views, cdf, degs, inv_total, inv_t, u_vert,
                     noise, hstate=None, *, kind, inv_bw, beta,
                     pairwise=None, block_size, num_blocks, n, s, exact,
                     level1="blocked", num_far=64, precision="f32"):
    """Algorithm 5.1 steps (a)-(d) for one batch with explicit noise:
    u ~ degrees (inverse CDF over the device prefix array), v | u by the
    depth-2 engine, the collapsed reverse probability q(u | v) =
    k(u,v)/deg(v), and the weight ``k(u,v) / (t (p_u q_uv + p_v q_vu))``.
    Returns (u, v, wgt, q_uv, q_vu, status tensor)."""
    u = _ref.inverse_cdf_index(cdf, u_vert)
    v, q_uv, _, st = _fused_sample_core(
        x, x_sq, views, u, noise, hstate, kind=kind, inv_bw=inv_bw,
        beta=beta, pairwise=pairwise, block_size=block_size,
        num_blocks=num_blocks, n=n, s=s, exact=exact, level1=level1,
        num_far=num_far, precision=precision)
    kuv = _ref.kv_pairs(x[u], x[v], kind, inv_bw, beta, pairwise)
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
                     views=None, hstate=None, kind, inv_bw, beta, pairwise,
                     block_size, num_blocks, n, s, exact, level1="blocked",
                     num_far=64, precision="f32"):
    """One fused Algorithm 5.1 edge batch with explicit noise ``u_vert``
    then the depth-2 step's noise: (u, v, weight, q_uv, q_vu, counter
    word)."""
    if views is None:
        views = _ref.block_views(x, x_sq, block_size)
    *out, st = _edge_batch_core(x, x_sq, views, cdf, degs, inv_total, inv_t,
                                u_vert, noise, hstate, kind=kind,
                                inv_bw=inv_bw, beta=beta, pairwise=pairwise,
                                block_size=block_size,
                                num_blocks=num_blocks, n=n, s=s, exact=exact,
                                level1=level1, num_far=num_far,
                                precision=precision)
    cols, far, ov = _l1_cols(level1, exact, num_blocks, s, n, num_far,
                             hstate)
    return (*out, _edge_batch_word(st, u_vert.shape[0], cols, far, ov,
                                   block_size))


def edge_batch_scan(x, x_sq, cdf, degs, inv_total, inv_t, generator,
                    num_batches: int, hstate=None, *, batch, kind, inv_bw,
                    beta, pairwise, block_size, num_blocks, n, s, exact,
                    level1="blocked", num_far=64, precision="f32"):
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
                                         level1=level1, exact=exact,
                                         num_far=num_far,
                                         block_size=block_size)
        *res, s_i = _edge_batch_core(x, x_sq, views, cdf, degs, inv_total,
                                     inv_t, u_vert, noise, hstate, kind=kind,
                                     inv_bw=inv_bw, beta=beta,
                                     pairwise=pairwise,
                                     block_size=block_size,
                                     num_blocks=num_blocks, n=n, s=s,
                                     exact=exact, level1=level1,
                                     num_far=num_far, precision=precision)
        for o, r in zip(outs, res):
            o[i] = r
        st = st | s_i
    cols, far, ov = _l1_cols(level1, exact, num_blocks, s, n, num_far,
                             hstate)
    word = _c.scale(_edge_batch_word(st, batch, cols, far, ov, block_size),
                    num_batches)
    return (*outs, word)


def kernel_rows(q, x, x_sq, *, kind, inv_bw, beta, pairwise=None):
    """Exact (m, n) kernel rows -- the FKV sketch rows and the CP17 column
    reads of Section 5.2 (plain torch on every device, as the reference
    leaves them outside any kernel).  Returns ``(rows, counter word)``."""
    kv = _ref.kv_matrix(q, x, x_sq, kind, inv_bw, beta, pairwise)
    return kv, _c.word(status=_g.nonfinite_status(kv),
                       evals=q.shape[0] * x.shape[0])


# --------------------------------------------------------------------- #
# walks (Algorithm 4.16) on the device
# --------------------------------------------------------------------- #
def walk_cache_samples(num_blocks: int, s: int) -> int:
    """Per-block subsample width ``s_eff`` of the walk-resident cache, for
    the eval accounting of ``core.sampling.edge``."""
    return _tuning.walk_samples_per_block(num_blocks, s)


def walk_layout(n: int, block_size: int, num_blocks: int, s: int):
    """(stratum width, stratum count, per-stratum cache width) of the
    walk-resident layout (``tuning.walk_block_size``): the walk step's own
    block granularity, so the exact level-2 read stays narrow as n grows.
    The sampler's layout is returned unchanged while ``num_blocks * s <=
    WALK_CACHE_COLS``; past that the two layouts differ."""
    if num_blocks * s <= _tuning.WALK_CACHE_COLS:
        return block_size, num_blocks, s
    wbs = _tuning.walk_block_size(n, block_size)
    w_blocks = -(-int(n) // wbs)
    return wbs, w_blocks, _tuning.walk_samples_per_block(w_blocks, s)


def walk_cached(level1: str, exact: bool) -> bool:
    """Whether a walk reads level 1 from the walk-resident cache: every
    stratified blocked walk does, on every device (the reference's CPU
    behaviour; ROADMAP.md section 3)."""
    return level1 == "blocked" and not exact


def _walk_level1_cache(x, x_sq, u, *, block_size, num_blocks, n, s):
    """Walk-resident compact level-1 subsample (DESIGN.md §14), from
    explicit uniforms ``u`` (num_blocks, block_size): each stratum's ``s``
    rows of smallest ``u`` (``stratified_columns``), gathered once per
    walk into a compact (B * s, d) array that every step's level-1 read
    sweeps.  SAMPLE-major: column j holds sample j // B of stratum j % B.
    Returns ``(xs, xs_sq, valid (B s,) real-sample mask, scale (B,))``."""
    rows, valid, scale = stratified_columns(u, block_size=block_size,
                                            num_blocks=num_blocks, n=n, s=s)
    flat = rows.reshape(num_blocks, s).T.reshape(-1)
    return x[flat], x_sq[flat], valid.T.reshape(-1), scale


def _cached_block_sums(cache, x, src, *, kind, inv_bw, beta, pairwise=None,
                       block_size, num_blocks, s, precision="f32"):
    """Masked level-1 read against the walk-resident cache: one compact
    (w, B * s) kernel evaluation, the per-stratum sum and rescale, then the
    own-block correction and the floor."""
    xs, xs_sq, valid, scale = cache
    kv = _ref.kv_matrix(x[src], xs, xs_sq, kind, inv_bw, beta, pairwise,
                        precision) * valid[None, :]
    bs = kv.reshape(src.shape[0], s, num_blocks).sum(1) * scale[None, :]
    return _own_correct(bs, src, block_size, num_blocks)


def _walk_sample_core(x, x_sq, views, src, bs, u_blk, u_in, *, kind, inv_bw,
                      beta, pairwise=None, block_size, n, num_blocks,
                      off=None):
    """``sample_from_sums`` with the two-level inverse-CDF draws at both
    depths (``ref.grouped_inverse_cdf``): the walk-resident step.  Returns
    (neighbors, realized probabilities)."""
    blk, pb = _ref.choose_block_grouped(bs, u_blk, _ref.cdf_group(num_blocks))
    kv, live, cols_c = _ref.level2_row(x, x_sq, views, src, blk, kind,
                                       inv_bw, beta, block_size, n, pairwise,
                                       off)
    nb, pin = _ref.level2_draw_grouped(kv, live, cols_c, u_in,
                                       _ref.cdf_group(block_size))
    return nb, pb * pin


def draw_walk_noise(length: int, w: int, num_blocks: int, generator,
                    device, *, level1="blocked", exact, num_far=64,
                    block_size, n, s, rounds=0):
    """The noise of a ``length``-step walk of ``w`` walkers: ``(cache_u,
    steps)``.  ``cache_u`` (w_blocks, wbs) draws the walk-resident
    subsample (None off the cached layout); ``steps[i]`` is step i's
    noise: ``(l1, u_blk (rounds + 1, w), u_in (rounds + 1, w), u_acc
    (rounds, w))`` with rejection rounds (``l1`` the FAR offsets of a
    hashed read, else None), ``(u_blk, u_in)`` on the cached layout,
    ``draw_sample_noise``'s otherwise."""
    cache_u = None
    if walk_cached(level1, exact):
        wbs, w_blocks, _ = walk_layout(n, block_size, num_blocks, s)
        cache_u = torch.rand((w_blocks, wbs), generator=generator,
                             device=device)
    steps = []
    for _ in range(length):
        if rounds > 0:
            l1 = (_hops.draw_frontier_noise(w, num_blocks, num_far,
                                            block_size, generator, device)
                  if level1 == "hash" else None)
            steps.append((l1,) + draw_exact_noise(w, rounds, generator,
                                                  device))
        elif cache_u is not None:
            steps.append(tuple(torch.rand(w, generator=generator,
                                          device=device) for _ in range(2)))
        else:
            steps.append(draw_sample_noise(w, num_blocks, generator, device,
                                           level1=level1, exact=exact,
                                           num_far=num_far,
                                           block_size=block_size))
    return cache_u, steps


def walk_scan(x, x_sq, starts, noise, hstate=None, *, kind, inv_bw, beta,
              pairwise, block_size, num_blocks, n, s, exact, rounds, slack,
              record_path=True, level1="blocked", num_far=64,
              precision="f32"):
    """``len(steps)``-step random walk on the device with explicit noise
    ``(cache_u, steps)`` (``draw_walk_noise``): the frontier stays on the
    device and each step is one depth-2 draw -- the sample-block kernel on
    the exact read, the hashed read's weighted-kv kernels on
    ``level1="hash"``, the walk-resident cache on the stratified read (no
    kernel) -- or, with ``rounds > 0``, one level-1 read (the
    masked-blocksum kernel on the exact read) and the Theorem 4.12
    rejection rounds.  Statuses or-fold and fallbacks add on the device:
    no host synchronisation inside the loop.  ``record_path=False``
    consumes the same noise, so the endpoints are the same.

    Returns (endpoints, (T, w) path or None, counter word, fallback
    count)."""
    cache_u, steps = noise
    w = starts.shape[0]
    wbs, w_blocks, s_eff = block_size, num_blocks, s
    cache = None
    views = _ref.block_views(x, x_sq, block_size)
    if walk_cached(level1, exact):
        # walk-resident layout: ~WALK_CACHE_COLS cached level-1 columns
        # over finer strata, so the exact level-2 read is wbs wide
        wbs, w_blocks, s_eff = walk_layout(n, block_size, num_blocks, s)
        cache = _walk_level1_cache(x, x_sq, cache_u, block_size=wbs,
                                   num_blocks=w_blocks, n=n, s=s_eff)
        views = _ref.block_views(x, x_sq, wbs)
    cols, far, ov = _l1_cols(level1, exact, num_blocks, s, n, num_far,
                             hstate)
    l2 = dict(kind=kind, inv_bw=inv_bw, beta=beta, pairwise=pairwise)
    cur, st = starts, 0
    fb = torch.zeros((), dtype=torch.int64, device=starts.device)
    path = []
    for step in steps:
        if rounds > 0:
            l1, u_blk, u_in, u_acc = step
            if cache is not None:
                bs = _cached_block_sums(cache, x, cur, block_size=wbs,
                                        num_blocks=w_blocks, s=s_eff,
                                        precision=precision, **l2)
                st1 = _g.sums_status(bs, FLOOR)
            else:
                bs, st1 = _masked_sums_any(x, x_sq, cur, l1, hstate,
                                           block_size=block_size,
                                           num_blocks=num_blocks, n=n, s=s,
                                           exact=exact, level1=level1,
                                           num_far=num_far,
                                           precision=precision, **l2)
            cur, st2, fb_k = _sample_exact_core(
                x, x_sq, views, cur, bs, u_blk, u_in, u_acc,
                block_size=wbs, n=n, rounds=rounds, slack=slack, **l2)
            st, fb = st1 | st2 | st, fb + fb_k
        elif cache is not None:
            u_blk, u_in = step
            bs = _cached_block_sums(cache, x, cur, block_size=wbs,
                                    num_blocks=w_blocks, s=s_eff,
                                    precision=precision, **l2)
            cur, prob = _walk_sample_core(x, x_sq, views, cur, bs, u_blk,
                                          u_in, block_size=wbs, n=n,
                                          num_blocks=w_blocks, **l2)
            st = _g.sums_status(bs, FLOOR) | _g.result_status(prob) | st
        else:
            cur, _, _, st_k = _fused_sample_core(
                x, x_sq, views, cur, step, hstate, block_size=block_size,
                num_blocks=num_blocks, n=n, s=s, exact=exact, level1=level1,
                num_far=num_far, precision=precision, **l2)
            st = st_k | st
        if record_path:
            path.append(cur)
    # per step: one level-1 read of the frontier (the cached compact
    # columns, or ``cols`` a row) + w exact level-2 rows, and with
    # rejection rounds ``rounds`` more rows and aligned accept pairs
    l1_evals = w * w_blocks * s_eff if cache is not None else w * cols
    evals, draws = l1_evals + w * wbs, w
    if rounds > 0:
        evals += rounds * (w * wbs + w)
        draws = (rounds + 1) * w
    if cache is not None:
        far = ov = 0
    word = _c.scale(_c.word(status=st, evals=evals, l1_reads=w, draws=draws,
                            far_samples=w * far, overflow=w * ov,
                            device=starts.device), len(steps))
    word[_c.RETRIES] = fb
    if record_path:
        path = torch.stack(path) if path else starts.new_empty((0, w))
    return cur, (path if record_path else None), word, fb


# --------------------------------------------------------------------- #
# application programs (DESIGN.md §7): eigen / Laplacian / local
# clustering / triangles
# --------------------------------------------------------------------- #
def noisy_power_scan(ksub, v0, us, *, num_samples):
    """BIMW21 noisy power method (Algorithm 5.18 step 2) with explicit
    uniforms ``us`` (iters, num_samples): every iteration importance-
    samples ``num_samples`` indices j ~ |v_j| by inverse CDF, forms the
    unbiased matvec estimate and renormalizes (``ref.noisy_power_step``),
    all on the device.  Returns (Rayleigh quotient of one exact final
    matvec, final unit vector, counter word -- iterations whose sampled
    matvec collapsed or went non-finite are flagged; DRAWS counts the
    sampled lookups into ``ksub``, which are not fresh kernel evals)."""
    if us.shape[1:] != (num_samples,):
        raise ValueError(f"us must be (iters, {num_samples}), got "
                         f"{tuple(us.shape)}")
    v, st = v0, 0
    for u in us:
        v, w, ok = _ref.noisy_power_step(ksub, v, u)
        st = _g.flag_if(~ok, _g.ZERO_MASS) | _g.nonfinite_status(w) | st
    lam = v @ (ksub @ v)
    st = _g.merge(st, _g.result_status(lam, v))
    return lam, v, _c.word(status=st, draws=us.shape[0] * num_samples,
                           device=ksub.device)


def laplacian_matvec(src, dst, w, p, *, n, deg=None):
    """L_{G'} p = D p - A p over a COO edge list by scatter-adds; ``deg``
    is D when the caller has it already (``ref.edge_degrees``)."""
    return _ref.laplacian_matvec_ref(src, dst, w, p, n, deg)


# the host reads laplacian_cg's device-side ``done`` flag every this many
# iterations
_CG_CHECK_EVERY = 8


def laplacian_cg(src, dst, w, b, tol, *, n, iters):
    """Jacobi-preconditioned CG for ``L_{G'} x = b`` (b perp 1) on the
    device (Section 5.1.1's solve step), the reference's ``lax.while_loop``
    as a loop whose updates freeze by ``torch.where`` once a device-side
    ``done`` flag is set; the host reads ``done`` every
    ``_CG_CHECK_EVERY`` iterations only, so a solve costs
    ceil(iters / _CG_CHECK_EVERY) synchronisations, and the returned
    iterate, residual and iteration count are those of the reference's
    loop.

    Float32-safe: tracks the best iterate seen and stops on non-positive
    curvature or preconditioned residual, a non-finite residual, the
    tolerance, or 32 iterations without improving the best residual.
    Returns (best iterate projected to 1^perp, its residual norm, counter
    word: CG_NO_CONVERGE / non-finite flags, DRAWS = realized
    iterations)."""
    dev, dt = w.device, w.dtype
    deg = _ref.edge_degrees(src, dst, w, n)
    dinv = 1.0 / torch.clamp(deg, min=1e-30)

    def proj(v):
        return v - torch.mean(v)

    bb = proj(b)
    x_, r_ = torch.zeros(n, dtype=dt, device=dev), bb
    p_ = proj(dinv * r_)
    rz = torch.dot(r_, p_)
    bnorm = torch.clamp(torch.linalg.norm(bb), min=1e-30)
    bx, br = x_, torch.linalg.norm(r_)
    stall = torch.zeros((), dtype=torch.int64, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(iters):
        if i and i % _CG_CHECK_EVERY == 0 and bool(done):
            break
        ap = laplacian_matvec(src, dst, w, p_, n=n, deg=deg)
        denom = torch.dot(p_, ap)
        ok = (denom > 0.0) & (rz > 0.0)
        alpha = torch.where(ok, rz / torch.clamp(denom, min=1e-30), 0.0)
        x2 = x_ + alpha * p_
        r2 = r_ - alpha * ap
        rn = torch.linalg.norm(r2)
        better = ok & (rn < br)
        z2 = proj(dinv * r2)
        rz2 = torch.dot(r2, z2)
        p2 = z2 + torch.where(ok, rz2 / torch.clamp(rz, min=1e-30), 0.0) * p_
        stall2 = torch.where(better, 0, stall + 1)
        stop = ~ok | (rn < tol * bnorm) | ~torch.isfinite(rn) \
            | (rz2 <= 0.0) | (stall2 >= 32)
        live = ~done
        x_, r_, p_ = (torch.where(live, a, b_) for a, b_ in
                      ((x2, x_), (r2, r_), (p2, p_)))
        rz = torch.where(live, rz2, rz)
        bx = torch.where(live & better, x2, bx)
        br = torch.where(live & better, rn, br)
        stall = torch.where(live, stall2, stall)
        count = count + live.to(torch.int64)
        done = done | stop
    sol = proj(bx)
    st = _g.merge(_g.flag_if(br >= tol * bnorm, _g.CG_NO_CONVERGE),
                  _g.result_status(sol, br))
    word = _c.word(status=st, device=dev)
    word[_c.DRAWS] = count
    return sol, br, word


def signed_endpoint_stat(ends, signs, *, n):
    """``sum_i (sum_j signs_j [ends_j = i])^2`` -- the collision part of
    the CDVV14 l2 statistic on the device: with signs +1 for the u walks
    and -1 for the w walks it is ``sum_i (X_i - Y_i)^2`` over the endpoint
    counts, one scatter-add and one reduction (exact in f32 up to 2^24
    walks, whatever the order of the adds).  Returns ``(statistic,
    counter word)`` -- no kernel evals."""
    c = torch.zeros(n, dtype=signs.dtype, device=signs.device)
    c.index_add_(0, ends, signs)
    stat = torch.sum(c * c)
    return stat, _c.word(status=_g.result_status(stat))


def triangle_edge_scan(x, x_sq, u, v, degs, noise, hstate=None, *, kind,
                       inv_bw, beta, pairwise, block_size, num_blocks, n, s,
                       exact, level1="blocked", num_far=64, precision="f32"):
    """Theorem 6.17's per-edge inner loop with explicit noise ``(l1, u_blk
    (D, m), u_in (D, m))``: degree-ordered orientation of the (u, v)
    pairs, ONE masked level-1 read of the oriented v frontier (noise
    ``l1``; the masked-blocksum kernel on the exact read), then per draw
    i a neighbor w ~ k(v, .)/deg(v) from the cached sums (``u_blk[i]``,
    ``u_in[i]``), the mask ``v < w`` (degree order) and ``w != u``, and
    the accumulated k(u,v) k(u,w), reweighted by deg(v)/D.  Returns
    (oriented u, oriented v, per-edge weight estimates, counter word)."""
    l1, u_blk, u_in = noise
    views = _ref.block_views(x, x_sq, block_size)
    prec = _ref.degree_precedes(degs, u, v)
    uu = torch.where(prec, u, v)
    vv = torch.where(prec, v, u)
    kuv = _ref.kv_pairs(x[uu], x[vv], kind, inv_bw, beta, pairwise)
    bs, st = _masked_sums_any(x, x_sq, vv, l1, hstate, kind=kind,
                              inv_bw=inv_bw, beta=beta, pairwise=pairwise,
                              block_size=block_size, num_blocks=num_blocks,
                              n=n, s=s, exact=exact, level1=level1,
                              num_far=num_far, precision=precision)
    acc = torch.zeros_like(kuv)
    for ub, ui in zip(u_blk, u_in):
        w, _ = _ref.sample_from_sums(x, x_sq, views, vv, bs, ub, ui, kind,
                                     inv_bw, beta, block_size, n, pairwise)
        valid = _ref.degree_precedes(degs, vv, w) & (w != uu)
        kuw = _ref.kv_pairs(x[uu], x[w], kind, inv_bw, beta, pairwise)
        acc = acc + torch.where(valid, kuv * kuw, 0.0)
    num_draws = u_blk.shape[0]
    w_hat = acc * degs[vv] / num_draws
    m = u.shape[0]
    cols, far, ov = _l1_cols(level1, exact, num_blocks, s, n, num_far,
                             hstate)
    # one level-1 read of the m-edge frontier + m k(u,v) pairs + per draw
    # m level-2 rows and m k(u,w) pairs
    cw = _c.word(status=_g.merge(st, _g.result_status(w_hat)),
                 evals=m * cols + m + num_draws * (m * block_size + m),
                 l1_reads=m, draws=num_draws * m, far_samples=m * far,
                 overflow=m * ov)
    return uu, vv, w_hat, cw


# --------------------------------------------------------------------- #
# batched multi-tenant entry points (DESIGN.md §13)
#
# One serving tick aggregates R concurrent requests -- possibly from
# different tenants -- into ONE padded batch: ``tidx`` (R,) indexes the
# stacked tenant arena ``xa`` (T, n, d) / ``xa_sq`` (T, n) (and, for
# hashed level-1 tenants, a ``kde_hash.ops.stack_hash_states`` layout),
# every request carries its OWN noise, stacked along a leading request
# axis (the single-request program's noise for each lane), and every
# program returns a PER-REQUEST counter word.  Each stage is one pass over
# the group's R w rows: the exact level-1 reads are one launch of the
# tenant-axis kernels (the rows ordered by tenant, each tenant's run padded
# to whole tiles), the hashed reads one launch of the weighted-kv kernels
# over the flattened arena, the stratified reads one batched plain sweep;
# level 2 and the draws are torch ops with each row's tenant offset
# gathered (``ref.level2_row``'s ``off``).  Lane r computes what the
# single-request program computes on tenant ``tidx[r]`` with lane r's
# noise: the same level-1 sums (each row's sums never depend on the other
# rows of a launch), indices and draws.
# --------------------------------------------------------------------- #
class _Lanes:
    """The row layout of one batched call: R lanes of w rows, each row's
    tenant, arena offsets and tenant-relative frontier index."""

    def __init__(self, xa, xa_sq, tidx, src, block_size: int):
        self.t, self.n, self.d = xa.shape
        self.r, self.w = src.shape
        dev = xa.device
        self.tidx_host = torch.as_tensor(tidx).to("cpu", torch.int64)
        self.tidx = self.tidx_host.to(dev)
        self.trow = self.tidx.repeat_interleave(self.w)
        self.src = src.reshape(-1).to(dev, torch.int64)
        self.xa, self.xa_sq = xa, xa_sq
        self.x = xa.reshape(-1, self.d)
        self.x_sq = xa_sq.reshape(-1)
        self.views, self.off = self.block_layout(block_size)

    def block_layout(self, block_size: int):
        """Every tenant's ``ref.block_views`` end to end, and each row's
        (arena row offset, view offset)."""
        pad = -self.n % block_size
        xa, xa_sq = self.xa, self.xa_sq
        if pad:                  # whole blocks need no padded copy
            xa = torch.nn.functional.pad(xa, (0, 0, 0, pad))
            xa_sq = torch.nn.functional.pad(xa_sq, (0, pad))
        xb = xa.reshape(-1, block_size, self.d)
        xbs = xa_sq.reshape(-1, block_size)
        per = (self.n + pad) // block_size
        return (xb, xbs), (self.trow * self.n, self.trow * per)

    def rows(self, a):
        """A lane-stacked (R, w, ...) noise tensor as (R w, ...)."""
        return a.reshape((self.r * self.w,) + tuple(a.shape[2:]))

    def queries(self):
        """The frontier rows' coordinates (R w, d)."""
        return self.x[self.off[0] + self.src]


def _lane_status(bs, lanes: int):
    """``guards.sums_status`` of each lane's rows of ``bs``: (lanes,)."""
    b = bs.reshape(lanes, -1, bs.shape[-1])
    nf = ~torch.isfinite(b).reshape(lanes, -1).all(dim=1)
    zero = (b <= 2.0 * FLOOR).all(dim=-1).any(dim=-1)
    return nf.to(torch.int64) * _g.NONFINITE \
        | zero.to(torch.int64) * _g.ZERO_MASS


def _lane_result(lanes: int, *arrays):
    """``guards.result_status`` of each lane's rows: (lanes,)."""
    st = 0
    for a in arrays:
        bad = ~torch.isfinite(a).reshape(lanes, -1).all(dim=1)
        st = st | bad.to(torch.int64) * _g.NONFINITE_RESULT
    return st


def tenant_launch(fn, q, xa, trow_host, *row_args, bm: int, **kw):
    """One tenant-axis launch of a level-1 kernel wrapper ``fn`` (the CUDA
    wrapper or its plain version): the rows ``q`` ordered by tenant
    (``trow_host``, on the host) and padded to whole tiles of ``bm``
    (``kernel.tenant_layout``), the per-row operands ``row_args`` with
    them, then the outputs in the callers' row order."""
    pos, base, inv = _k.tenant_layout(trow_host.numpy(), xa.shape[1], bm)
    dev = q.device
    pos = torch.as_tensor(pos).to(dev)
    inv = torch.as_tensor(inv).to(dev)
    out = fn(q[pos], xa, *[a[pos] for a in row_args], **kw,
             tile_base=torch.as_tensor(base).to(dev))
    return tuple(o[inv] for o in out) if isinstance(out, tuple) \
        else out[inv]


def _lane_kv(q, xr, xr_sq, *, kind, inv_bw, beta, pairwise=None,
             precision="f32"):
    """``ref.kv_matrix`` of each lane's rows ``q`` (R, w, d) against its own
    columns ``xr`` (R, C, d): (R, w, C), one batched sweep."""
    return torch.vmap(lambda a, b, c: _ref.kv_matrix(
        a, b, c, kind, inv_bw, beta, pairwise, precision))(q, xr, xr_sq)


def _lane_stratified(lay, q, u, *, kind, inv_bw, beta, pairwise,
                     block_size, num_blocks, n, s, precision):
    """``stratified_block_sums`` of each lane's query rows ``q`` (R w, d)
    against its own subsample (uniforms ``u`` (R, B, block_size)) of its
    tenant: (R w, B), unfloored."""
    rows, valid, scale = stratified_columns(u, block_size=block_size,
                                            num_blocks=num_blocks, n=n, s=s)
    ti = lay.tidx[:, None]
    kv = _lane_kv(q.reshape(lay.r, -1, lay.d), lay.xa[ti, rows],
                  lay.xa_sq[ti, rows], kind=kind, inv_bw=inv_bw, beta=beta,
                  pairwise=pairwise, precision=precision)
    kv = kv.reshape(lay.r, -1, num_blocks, s) * valid[:, None]
    return (kv.sum(-1) * scale).reshape(-1, num_blocks)


def _lane_exact_custom(lay, q, *, kind, inv_bw, beta, pairwise, block_size,
                       precision):
    """Exact block sums of each lane's query rows ``q`` (R w, d) over its
    whole tenant by the custom kind's ``pairwise`` (``custom_kind``):
    (R w, B), unmasked."""
    ti = lay.tidx
    kv = _lane_kv(q.reshape(lay.r, -1, lay.d), lay.xa[ti], lay.xa_sq[ti],
                  kind=kind, inv_bw=inv_bw, beta=beta, pairwise=pairwise,
                  precision=precision)
    kv = torch.nn.functional.pad(kv, (0, -lay.n % block_size))
    return kv.reshape(q.shape[0], -1, block_size).sum(-1)


def _lane_masked_sums(lay, l1_noise, hstate, *, kind, inv_bw, beta,
                      pairwise, block_size, num_blocks, n, s, exact,
                      level1, num_far, precision):
    """``_masked_sums_any`` of every lane's frontier in one pass: the
    tenant-axis masked-blocksum launch (exact), the hashed read's one
    weighted-kv launch (hash), or the batched stratified sweep.  Returns
    (bs (R w, B), per-lane status (R,))."""
    if level1 == "hash":
        bs, corrupt, trunc = _hops.stacked_hashed_block_sums(
            lay.xa, lay.src, lay.trow, hstate, lay.rows(l1_noise),
            kind=kind, inv_bw=inv_bw, beta=beta, pairwise=pairwise,
            num_far=num_far, block_size=block_size, num_blocks=num_blocks,
            n=n, precision=precision)
        st = (_hops._lane_flag(corrupt, lay.r, _g.STATE_CORRUPT)
              | _hops._lane_flag(trunc, lay.r, _g.BUCKET_OVERFLOW))
        return bs, st | _lane_status(bs, lay.r)
    if exact and custom_kind(pairwise):
        bs = _own_correct(_lane_exact_custom(
            lay, lay.queries(), kind=kind, inv_bw=inv_bw, beta=beta,
            pairwise=pairwise, block_size=block_size, precision=precision),
            lay.src, block_size, num_blocks)
    elif exact:
        q = lay.queries()
        fn = _k.masked_blocksum_cuda if q.is_cuda \
            else _k.masked_blocksum_plain
        bs = tenant_launch(fn, q, lay.xa, lay.tidx_host.repeat_interleave(
            lay.w), lay.src // block_size, kind=kind, inv_bw=inv_bw,
            beta=beta, bn=block_size, precision=precision,
            bm=_k.tile_rows(lay.d, precision=precision))
    else:
        bs = _own_correct(_lane_stratified(
            lay, lay.queries(), l1_noise, kind=kind, inv_bw=inv_bw,
            beta=beta, pairwise=pairwise, block_size=block_size,
            num_blocks=num_blocks, n=n, s=s, precision=precision),
            lay.src, block_size, num_blocks)
    return bs, _lane_status(bs, lay.r)


def _lane_step(lay, noise, hstate, *, kind, inv_bw, beta, pairwise,
               block_size, num_blocks, n, s, exact, level1, num_far,
               precision):
    """``_fused_sample_core`` of every lane in one pass: (neighbors (R w,),
    probs (R w,), level-1 sums (R w, B), per-lane status (R,))."""
    l2 = dict(kind=kind, inv_bw=inv_bw, beta=beta)
    if level1 == "hash" or not exact:
        l1_noise, u_blk, u_in = noise
        bs, st = _lane_masked_sums(
            lay, l1_noise, hstate, pairwise=pairwise, block_size=block_size,
            num_blocks=num_blocks, n=n, s=s, exact=exact, level1=level1,
            num_far=num_far, precision=precision, **l2)
        nb, prob = _ref.sample_from_sums(
            lay.x, lay.x_sq, lay.views, lay.src, bs, lay.rows(u_blk),
            lay.rows(u_in), block_size=block_size, n=n, pairwise=pairwise,
            off=lay.off, **l2)
        return nb, prob, bs, st | _lane_result(lay.r, prob)
    gumbel_noise, u_in = noise
    q = lay.queries()
    if custom_kind(pairwise):
        bs, _ = _lane_masked_sums(
            lay, None, hstate, pairwise=pairwise, block_size=block_size,
            num_blocks=num_blocks, n=n, s=s, exact=exact, level1=level1,
            num_far=num_far, precision=precision, **l2)
        blk, pb, _ = _ref.argmax_draw(bs, lay.rows(gumbel_noise))
    else:
        fn = _k.sample_block_cuda if q.is_cuda else _k.sample_block_plain
        blk, pb, _, bs = tenant_launch(
            fn, q, lay.xa, lay.tidx_host.repeat_interleave(lay.w),
            lay.src // block_size, lay.rows(gumbel_noise), bn=block_size,
            precision=precision, bm=_k.tile_rows(lay.d, precision=precision),
            **l2)
    kv, live, cols_c = _ref.level2_row(lay.x, lay.x_sq, lay.views, lay.src,
                                       blk, block_size=block_size, n=n,
                                       pairwise=pairwise, off=lay.off, **l2)
    nb, pin = _ref.level2_draw(kv, live, cols_c, lay.rows(u_in))
    prob = pb * pin
    return nb, prob, bs, _lane_status(bs, lay.r) | _lane_result(lay.r, prob)


def batched_fused_sample(xa, xa_sq, tidx, src, noise, hstate=None, *, kind,
                         inv_bw, beta, pairwise, block_size, num_blocks,
                         n, s, exact, level1="blocked", num_far=64,
                         precision="f32"):
    """One serving tick's depth-2 draws for R requests across T tenants in
    one pass: ``src`` (R, w) padded frontiers, ``tidx`` (R,) tenant
    indices (read on the host), ``noise`` the lanes' ``draw_sample_noise``
    stacked along a leading request axis.  Returns (neighbors (R, w),
    probs (R, w), level-1 sums (R, w, B), per-request counter words (R,
    obs.WIDTH)).  Lane r is ``fused_sample`` on tenant ``tidx[r]`` with
    lane r's noise."""
    lay = _Lanes(xa, xa_sq, tidx, src, block_size)
    nb, prob, bs, st = _lane_step(
        lay, noise, hstate, kind=kind, inv_bw=inv_bw, beta=beta,
        pairwise=pairwise, block_size=block_size, num_blocks=num_blocks,
        n=n, s=s, exact=exact, level1=level1, num_far=num_far,
        precision=precision)
    w = lay.w
    cols, far, ov = _l1_cols(level1, exact, num_blocks, s, n, num_far,
                             hstate)
    cw = _c.lane_words(st, evals=w * (cols + block_size), l1_reads=w,
                       draws=w, far_samples=w * far, overflow=w * ov)
    return (nb.reshape(lay.r, w), prob.reshape(lay.r, w),
            bs.reshape(lay.r, w, -1), cw)


def _lane_walk_cache(lay, cache_u, *, block_size, num_blocks, n, s):
    """``_walk_level1_cache`` of every lane (its own uniforms ``cache_u``
    (R, B, block_size) over its tenant): (xs (R, B s, d), xs_sq, valid,
    scale (B,))."""
    rows, valid, scale = stratified_columns(cache_u, block_size=block_size,
                                            num_blocks=num_blocks, n=n, s=s)
    flat = rows.reshape(lay.r, num_blocks, s).transpose(1, 2).reshape(
        lay.r, -1)
    ti = lay.tidx[:, None]
    return (lay.xa[ti, flat], lay.xa_sq[ti, flat],
            valid.transpose(1, 2).reshape(lay.r, -1), scale)


def _lane_cached_sums(lay, cache, cur, *, kind, inv_bw, beta, pairwise=None,
                      block_size, num_blocks, s, precision):
    """``_cached_block_sums`` of every lane against its own cache."""
    xs, xs_sq, valid, scale = cache
    q = lay.x[lay.off[0] + cur].reshape(lay.r, lay.w, lay.d)
    kv = _lane_kv(q, xs, xs_sq, kind=kind, inv_bw=inv_bw, beta=beta,
                  pairwise=pairwise, precision=precision) * valid[:, None, :]
    bs = kv.reshape(lay.r, lay.w, s, num_blocks).sum(2) * scale
    return _own_correct(bs.reshape(-1, num_blocks), cur, block_size,
                        num_blocks)


def batched_walk_scan(xa, xa_sq, tidx, starts, noise, hstate=None, *, kind,
                      inv_bw, beta, pairwise, block_size, num_blocks, n,
                      s, exact, rounds, slack, record_path=False,
                      level1="blocked", num_far=64, precision="f32"):
    """R independent walks (``starts`` (R, w)) across stacked tenants, one
    batched step a walk step: ``noise`` is ``(cache_u, steps)`` as
    ``draw_walk_noise`` gives it, every tensor stacked along a leading
    request axis (``cache_u`` None off the walk-resident layout).  Returns
    (endpoints (R, w), path ((R, T, w) or None), counter words (R,
    obs.WIDTH), rejection fallbacks (R,)) -- lane r is ``walk_scan`` on its
    tenant with its own noise."""
    cache_u, steps = noise
    lay = _Lanes(xa, xa_sq, tidx, starts, block_size)
    r, w = lay.r, lay.w
    wbs, w_blocks, s_eff = block_size, num_blocks, s
    cache = None
    views, off = lay.views, lay.off
    if walk_cached(level1, exact):
        wbs, w_blocks, s_eff = walk_layout(n, block_size, num_blocks, s)
        cache = _lane_walk_cache(lay, cache_u, block_size=wbs,
                                 num_blocks=w_blocks, n=n, s=s_eff)
        views, off = lay.block_layout(wbs)
    cols, far, ov = _l1_cols(level1, exact, num_blocks, s, n, num_far,
                             hstate)
    l2 = dict(kind=kind, inv_bw=inv_bw, beta=beta, pairwise=pairwise)
    cfg = dict(block_size=block_size, num_blocks=num_blocks, n=n, s=s,
               exact=exact, level1=level1, num_far=num_far,
               precision=precision, **l2)
    st = torch.zeros(r, dtype=torch.int64, device=xa.device)
    fb = torch.zeros(r, dtype=torch.int64, device=xa.device)
    path = []
    for step in steps:
        if rounds > 0:
            l1, u_blk, u_in, u_acc = step
            if cache is not None:
                bs = _lane_cached_sums(lay, cache, lay.src, block_size=wbs,
                                       num_blocks=w_blocks, s=s_eff,
                                       precision=precision, **l2)
                st1 = _lane_status(bs, r)
            else:
                bs, st1 = _lane_masked_sums(lay, l1, hstate, **cfg)
            cur, st2, fb_k = _sample_exact_core(
                lay.x, lay.x_sq, views, lay.src, bs,
                *(u.transpose(0, 1).reshape(u.shape[1], -1)
                  for u in (u_blk, u_in, u_acc)),
                block_size=wbs, n=n, rounds=rounds, slack=slack, off=off,
                lanes=r, **l2)
            st, fb = st1 | st2 | st, fb + fb_k
        elif cache is not None:
            u_blk, u_in = step
            bs = _lane_cached_sums(lay, cache, lay.src, block_size=wbs,
                                   num_blocks=w_blocks, s=s_eff,
                                   precision=precision, **l2)
            cur, prob = _walk_sample_core(
                lay.x, lay.x_sq, views, lay.src, bs, lay.rows(u_blk),
                lay.rows(u_in), block_size=wbs, n=n, num_blocks=w_blocks,
                off=off, **l2)
            st = _lane_status(bs, r) | _lane_result(r, prob) | st
        else:
            cur, _, _, st_k = _lane_step(lay, step, hstate, **cfg)
            st = st_k | st
        lay.src = cur
        if record_path:
            path.append(cur.reshape(r, w))
    l1_evals = w * w_blocks * s_eff if cache is not None else w * cols
    evals, draws = l1_evals + w * wbs, w
    if rounds > 0:
        evals += rounds * (w * wbs + w)
        draws = (rounds + 1) * w
    if cache is not None:
        far = ov = 0
    word = _c.scale(_c.lane_words(st, evals=evals, l1_reads=w, draws=draws,
                                  far_samples=w * far, overflow=w * ov),
                    len(steps))
    word[:, _c.RETRIES] = fb
    if record_path:
        path = torch.stack(path, dim=1) if path else \
            starts.new_empty((r, 0, w))
    return (lay.src.reshape(r, w), path if record_path else None, word, fb)


def batched_prob_of(xa, xa_sq, tidx, src, dst, noise=None, hstate=None, *,
                    kind, inv_bw, beta, pairwise, block_size,
                    num_blocks, n, s, exact, level1="blocked", num_far=64,
                    precision="f32"):
    """q(dst | src) for R requests (``src`` / ``dst`` (R, w)) in one pass:
    every lane's masked level-1 read of its src frontier (``noise`` the
    lanes' level-1 noise stacked, None on the exact read) then the exact
    level-2 probability.  Returns (probs (R, w), counter words (R,
    obs.WIDTH))."""
    lay = _Lanes(xa, xa_sq, tidx, src, block_size)
    bs, st = _lane_masked_sums(
        lay, noise, hstate, kind=kind, inv_bw=inv_bw, beta=beta,
        pairwise=pairwise, block_size=block_size, num_blocks=num_blocks,
        n=n, s=s, exact=exact, level1=level1, num_far=num_far,
        precision=precision)
    prob = _prob_core(lay.x, lay.x_sq, lay.views, lay.src,
                      dst.reshape(-1).to(xa.device, torch.int64), bs,
                      kind=kind, inv_bw=inv_bw, beta=beta, pairwise=pairwise,
                      block_size=block_size, n=n, off=lay.off)
    wq = lay.w
    cols, far, ov = _l1_cols(level1, exact, num_blocks, s, n, num_far,
                             hstate)
    cw = _c.lane_words(st | _lane_result(lay.r, prob),
                       evals=wq * (cols + block_size), l1_reads=wq,
                       far_samples=wq * far, overflow=wq * ov)
    return prob.reshape(lay.r, wq), cw


def batched_kde_query(xa, xa_sq, tidx, y, noise=None, *, kind, inv_bw, beta,
                      pairwise, block_size, num_blocks, n, s, exact,
                      precision="f32"):
    """Definition 1.1 row-sum estimates for R query requests (``y`` (R, q,
    d) external points) in one pass: one tenant-axis blocksum launch
    (exact) or one batched stratified sweep (``noise`` the lanes' (R, B,
    block_size) subsample uniforms).  Hash tenants are served by
    ``kde_hash.ops.batched_hashed_query``.  Returns (estimates (R, q),
    counter words (R, obs.WIDTH))."""
    r, q, d = y.shape
    lay = _Lanes(xa, xa_sq, tidx, torch.zeros((r, q), dtype=torch.int64),
                 block_size)
    yr = y.reshape(r * q, d)
    if exact and custom_kind(pairwise):
        bs = _lane_exact_custom(lay, yr, kind=kind, inv_bw=inv_bw, beta=beta,
                                pairwise=pairwise, block_size=block_size,
                                precision=precision)
        evals = q * n
    elif exact:
        fn = _rk.blocksum_cuda if yr.is_cuda else _rk.blocksum_plain
        bs = tenant_launch(fn, yr, xa, lay.tidx_host.repeat_interleave(q),
                           kind=kind, inv_bw=inv_bw, beta=beta,
                           bn=block_size, precision=precision,
                           bm=_rk.blocksum_tile_rows(d, precision=precision))
        evals = q * n
    else:
        bs = _lane_stratified(lay, yr, noise, kind=kind, inv_bw=inv_bw,
                              beta=beta, pairwise=pairwise,
                              block_size=block_size, num_blocks=num_blocks,
                              n=n, s=s, precision=precision)
        evals = q * num_blocks * s
    est = bs.sum(-1)
    nf = ~torch.isfinite(bs).reshape(r, -1).all(dim=1)
    st = (nf.to(torch.int64) * _g.NONFINITE | _lane_status(bs, r)
          | _lane_result(r, est))
    return est.reshape(r, q), _c.lane_words(st, evals=evals, l1_reads=q)


# --------------------------------------------------------------------- #
# streaming patches (DESIGN.md §12)
# --------------------------------------------------------------------- #
#: elements of one (m, chunk) value matrix of ``degree_delta`` (128 MiB of
#: f32): the column chunk is this over m, so no call forms the (m, n)
#: matrix of a large dataset
DELTA_BUDGET = 1 << 25


def patch_block_sums(bs, x, src, slots, old_x, new_x, *, kind, inv_bw, beta,
                     pairwise=None, block_size):
    """Incrementally update a cached (w, B) level-1 read after a dataset
    mutation batch: O(w m) kernel evals instead of the O(w n) rebuild
    (``ref.patch_block_sums_ref``, plain torch on every device: the
    reference has no kernel for it).  Frontier rows that mutated must not
    be patched -- the consumer drops the cache instead (``src`` is only
    read for the frontier coordinates).  Returns ``(patched sums, counter
    word)``."""
    out = _ref.patch_block_sums_ref(bs, x[src], slots, old_x, new_x, kind,
                                    inv_bw, beta, block_size, pairwise)
    # old + new kernel values per (frontier row, mutated slot) pair
    return out, _c.word(status=_g.nonfinite_status(out),
                        evals=2 * src.shape[0] * slots.shape[0])


def degree_delta(degs, x, x_sq, slots, old_x, new_x, old_live, new_live, *,
                 kind, inv_bw, beta, pairwise=None):
    """Incremental Algorithm 4.3 degree update after a mutation batch:
    O(n m) evals against the post-mutation padded arrays (column deltas
    for untouched rows, exact recompute for the mutated slots), replacing
    the O(n^2 / estimator-budget) degree rebuild.  The function of
    ``ref.degree_delta_ref``, swept over column chunks of
    ``DELTA_BUDGET // m`` in a fixed order, so it never forms the (m, n)
    value matrix and two calls are bitwise equal (plain torch on every
    device: the reference has no kernel for it).  Returns ``(degrees,
    counter word)``."""
    m, n = slots.shape[0], degs.shape[0]
    old_q = torch.where(old_live[:, None], old_x, 0.0)
    new_q = torch.where(new_live[:, None], new_x, 0.0)
    chunk = max(DELTA_BUDGET // max(m, 1), 1)
    out = torch.empty_like(degs)
    row_new = torch.zeros(m, dtype=degs.dtype, device=degs.device)
    for lo in range(0, n, chunk):
        xc, sc = x[lo:lo + chunk], x_sq[lo:lo + chunk]
        a_new = _ref.kv_matrix(new_q, xc, sc, kind, inv_bw, beta,
                               pairwise) * new_live[:, None]
        a_old = _ref.kv_matrix(old_q, xc, sc, kind, inv_bw, beta,
                               pairwise) * old_live[:, None]
        out[lo:lo + chunk] = degs[lo:lo + chunk] + (a_new - a_old).sum(dim=0)
        row_new += a_new.sum(dim=1)
    row_new = torch.where(new_live, row_new - 1.0, 0.0)
    out.index_copy_(0, slots.long(), row_new)
    # old + new kernel column per mutated slot against all n rows
    return out, _c.word(status=_g.nonfinite_status(out), evals=2 * m * n)
