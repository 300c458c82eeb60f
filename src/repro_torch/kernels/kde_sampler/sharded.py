"""Mesh-resident depth-2 sampling engine on ``torch.distributed`` (DESIGN.md §9).

``ShardedBlocks`` is the multi-device twin of the single-device programs
in ``ops.py``.  The level-1 block structure lives sharded over the
``data_axes`` of a ``torch.distributed.device_mesh.DeviceMesh``: each shard
owns a contiguous run of dataset rows, padded with the far-offset sentinel
so every shard holds the same number of whole blocks.  One depth-2 draw is
a two-stage collective program:

1. every shard computes its *local* masked block sums ``S_b^(p)`` (w, B_p)
   (the masked-blocksum kernel on the exact read, with each query's own
   block shifted to the shard's local index and -1 where another shard owns
   it) and a speculative local candidate -- block by inverse CDF over the
   local sums, the level-2 row from the shard's own ``(B_p, bs, d)`` block
   views, the in-block draw -- all from replicated uniforms;
2. ONE all-reduce of the one-hot payload ``(t_p, S_b * p_in, nb_p)`` makes
   the per-shard totals and candidates replicated, and the owning shard is
   picked by inverse CDF over the totals: ``p(shard) * p(block | shard) *
   p(col | block)``, the flat categorical's law.

The realized probability is ``S_b * p_in / sum_p t_p``, the flat engine's
``(S_b / sum S) * p_in``.  A draw batch realizes exactly one all-reduce
and no exchange; no stage moves dataset rows between shards.

Layout: ``n`` rows are padded to ``P * shard_size`` with ``shard_size =
ceil(n / P)`` rounded up to whole blocks.  Padding sits at the global tail,
so dataset indices are unchanged, global block ``b`` covers rows ``[b bs,
(b + 1) bs)`` exactly as on one device, and the all-sentinel blocks carry
zero mass (pinned to 0, never drawn).  Every rank holds its shard (a view
of the padded copy) and the replicated padded copy that frontier gathers
read.

SPMD: every rank of the mesh calls each entry point with the same
arguments and the same noise, and every rank gets the same replicated
result; ranks along the mesh's other dims compute the same thing as
replicas, each in its own data group.  The noise is explicit, as
everywhere in the port: a rank takes its own shard's slice of the
replicated stratified uniforms (``(P B_p, bs)``; the reference folds the
shard index into its key), and a draw's uniforms are ``(3, w)``: owner
shard, local block, in-block column (the reference's ``split(key, 3)``).

The mesh decides the device: a ``"cuda"`` mesh runs the shard on the
rank's current CUDA device, where the exact, rowsum and weighted sweeps
launch the port's kernels; a ``"cpu"`` mesh runs their plain versions.
A custom kind runs its ``pairwise`` closure on every device
(``ops.custom_kind``).

Collectives go through one wrapper (``all_reduce``, ``all_gather``,
``ring_exchange``; ``repro_torch.distributed.collectives``) that counts each realized call by kind
(``COLLECTIVES``; ``collective_counts(fn, ...)`` reads the difference
over one call) and times it (``COLLECTIVE_SECONDS``).  A gloo group stages
a CUDA tensor through host memory (gloo's send and recv take CPU tensors
only): staging moves bytes, the compute stays on the card, and a staged
call counts once.  A reduction over several data axes is ONE collective
over a flattened group, made once per (mesh, axes).

Every public program returns the reference's ``(WIDTH,)`` counter word
for the same static shapes, built on the host from static shard shapes
plus a status computed from replicated values only, so the words add no
collective.  The ``PSUMS`` slot counts the all-reduces the call realizes.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.device import as_f32
from repro_torch.ft import guards as _g
from repro_torch.kernels.kde_rowsum import kernel as _rk
from repro_torch.kernels.kde_rowsum.ops import _PAD_OFFSET
from repro_torch.kernels.kde_sampler import kernel as _k
from repro_torch.kernels.kde_sampler import ops as _ops
from repro_torch.kernels.kde_sampler import ref as _ref
from repro_torch.obs import counters as _c

# the collective wrapper and the mesh groups live in
# ``repro_torch.distributed.collectives``; the engines' names stay here
from repro_torch.distributed.collectives import (  # noqa: F401
    COLLECTIVE_BYTES, COLLECTIVE_SECONDS, COLLECTIVES, MeshGroup,
    all_gather, all_reduce, collective_counts, mesh_device, mesh_group,
    reset_collectives, ring_exchange)

FLOOR = _ref.BLOCK_SUM_FLOOR


# --------------------------------------------------------------------- #
# shard-local sweeps
# --------------------------------------------------------------------- #
def _kind_args(kernel):
    return dict(kind=kernel.name, inv_bw=1.0 / kernel.bandwidth,
                beta=float(getattr(kernel, "beta", 1.0)),
                pairwise=_ref.static_pairwise(kernel))


def local_rowsum(q, x, *, kind, inv_bw, beta, pairwise=None):
    """sum_j k(q_i, x_j) over a shard: the rowsum kernel on a CUDA tensor,
    its plain version on a CPU one, a custom kind's ``pairwise`` on
    either."""
    if _ops.custom_kind(pairwise):
        return torch.sum(pairwise(q, x), dim=1)
    fn = _rk.rowsum_cuda if q.is_cuda else _rk.rowsum_plain
    return fn(q.contiguous(), x.contiguous(), kind, inv_bw, beta)


def local_blocksums(q, x, own, *, kind, inv_bw, beta, pairwise=None,
                    bn: int):
    """(m, rows / bn) block sums over a shard of whole blocks: with ``own``
    (local block index, -1 none) the masked-blocksum kernel's contract
    (own block less 1, floored at 1e-12), else the blocksum kernel's plain
    sums.  Plain versions on a CPU tensor, ``pairwise`` for a custom
    kind."""
    q = q.contiguous()
    if _ops.custom_kind(pairwise):
        if own is None:
            kv = pairwise(q, x)
            return kv.reshape(q.shape[0], -1, bn).sum(-1)
        return _ref.masked_exact_sums_ref(q, x, None, own, kind, inv_bw,
                                          beta, bn, x.shape[0], pairwise)
    if own is None:
        fn = _rk.blocksum_cuda if q.is_cuda else _rk.blocksum_plain
        return fn(q, x, kind, inv_bw, beta, bn)
    fn = _k.masked_blocksum_cuda if q.is_cuda else _k.masked_blocksum_plain
    return fn(q, x, own, kind, inv_bw, beta, bn)


def _ring_degrees(x_l, kernel, grp: MeshGroup, rows: int):
    """Algorithm 4.3 over the ring: this shard's first ``rows`` (real)
    points summed against every shard's block, the blocks passed i -> i +
    1 in ``P - 1`` exchanges, minus the kernel's actual diagonal (1 for
    the built-in kinds).  Returns the shard's (shard rows,) degrees, 0 on
    the sentinel rows."""
    kw = _kind_args(kernel)
    q = x_l[:rows]
    acc = torch.zeros(x_l.shape[0], dtype=torch.float32, device=x_l.device)
    blk = x_l
    for step in range(grp.size):
        if rows:
            acc[:rows] += local_rowsum(q, blk, **kw)
        if step + 1 < grp.size:
            blk = ring_exchange(blk, grp)
    if kernel.name in _ref.BUILTIN_KINDS:
        diag = 1.0
    else:
        diag = torch.zeros_like(acc)
        diag[:rows] = kernel.pairs(q, q)
    out = acc - diag
    out[rows:] = 0.0
    return out


# --------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------- #
class ShardedBlocks:
    """Sharded level-1 block structure + the collective draw programs.

    Construction pads the dataset once (the replicated padded copy for
    frontier gathers; the rank's shard is a view of it).  Every method
    takes its noise explicitly (see the module note) and returns the
    reference's counter word."""

    def __init__(self, mesh, x, kernel, *, block_size: int,
                 samples_per_block: int = 16, exact: bool = False,
                 data_axes: Sequence[str] = ("data",), device=None):
        self.grp = mesh_group(mesh, data_axes)
        self.device = mesh_device(mesh, device)
        self.mesh = mesh
        self.axes = self.grp.axes
        self.num_shards = self.grp.size
        self.pidx = self.grp.index
        x = as_f32(x, self.device)
        n, d = int(x.shape[0]), int(x.shape[1])
        bs = int(block_size)
        per = -(-n // self.num_shards)                     # ceil(n / P)
        self.n, self.d = n, d
        self.block_size = bs
        self.shard_size = -(-per // bs) * bs
        self.blocks_per_shard = self.shard_size // bs
        self.num_blocks_pad = self.num_shards * self.blocks_per_shard
        self.num_blocks = -(-n // bs)                      # real blocks
        self.samples_per_block = min(int(samples_per_block), bs)
        self.exact = bool(exact)
        self.kernel = kernel
        self._kw = _kind_args(kernel)
        self.n_pad = self.num_shards * self.shard_size
        pad = self.n_pad - n
        if pad:
            sent = torch.full((pad, d), _PAD_OFFSET, dtype=torch.float32,
                              device=self.device) + x[-1:]
            x = torch.cat([x, sent], dim=0)
        self.x_rep = x.contiguous()
        self.x_sq_rep = torch.sum(self.x_rep * self.x_rep, dim=-1)
        lo = self.pidx * self.shard_size
        self._lo = lo
        # the rank's shard: a view, so a patch of the replicated copy
        # patches it too
        self.x_sh = self.x_rep[lo:lo + self.shard_size]
        self.x_sq_sh = self.x_sq_rep[lo:lo + self.shard_size]
        bl = self.blocks_per_shard
        self._views = (self.x_sh.reshape(bl, bs, d),
                       self.x_sq_sh.reshape(bl, bs))
        gbase = lo + torch.arange(bl, device=self.device) * bs
        self._sizes = torch.clamp(n - gbase, 0, bs)        # real rows a block
        self._real = self._sizes > 0

    # ------------------------------------------------------------------ #
    # noise
    # ------------------------------------------------------------------ #
    def draw_level1_noise(self, generator):
        """The replicated noise of one level-1 read: (P B_p, bs) subsample
        uniforms on the stratified read, None on the exact one.  Drawn on
        the generator's device, returned on the engine's."""
        if self.exact:
            return None
        return torch.rand((self.num_blocks_pad, self.block_size),
                          generator=generator,
                          device=generator.device).to(self.device)

    def draw_noise(self, w: int, generator, draws: int = 1):
        """``draws`` draws' uniforms, (draws, 3, w): owner shard, local
        block, in-block column (drawn on the generator's device, returned
        on the engine's)."""
        return torch.rand((draws, 3, w), generator=generator,
                          device=generator.device).to(self.device)

    # ------------------------------------------------------------------ #
    # shard-local building blocks
    # ------------------------------------------------------------------ #
    def _raw_sums(self, q, u):
        """Uncorrected, unfloored stratified local block sums (the raw
        Definition 1.1 read) from this shard's slice of the replicated
        uniforms ``u`` (P B_p, bs)."""
        w = q.shape[0]
        bl, bs, s = self.blocks_per_shard, self.block_size, \
            self.samples_per_block
        u = u[self.pidx * bl:(self.pidx + 1) * bl]
        pos = (torch.arange(bl, device=q.device) * bs)[:, None] \
            + torch.arange(bs, device=q.device)[None, :]
        valid = (self._lo + pos) < self.n
        u = torch.where(valid, u, torch.inf)
        order = torch.topk(-u, s, dim=1).indices
        idx = torch.gather(pos, 1, order)
        sel_valid = torch.gather(valid, 1, order)
        flat = idx.reshape(-1)
        kv = _ref.kv_matrix(q, self.x_sh[flat], self.x_sq_sh[flat],
                            self._kw["kind"], self._kw["inv_bw"],
                            self._kw["beta"], self._kw["pairwise"])
        kv = kv.reshape(w, bl, s) * sel_valid[None]
        sizes_f = self._sizes.to(torch.float32)
        s_b = torch.clamp(sizes_f, max=float(s))
        return kv.sum(-1) * (sizes_f / torch.clamp(s_b, min=1.0))[None, :]

    def _local_sums(self, q, own, l1_noise):
        """Masked §2-contract level-1 sums of the local shard: (w, B_p),
        the self kernel k(x, x) = 1 subtracted from each query's own
        block, real blocks floored at 1e-12, all-sentinel blocks pinned to
        0.  The exact read is one masked-blocksum launch on the card."""
        bl = self.blocks_per_shard
        own_l = own - self.pidx * bl
        own_l = torch.where((own_l >= 0) & (own_l < bl), own_l,
                            torch.full_like(own_l, -1))
        if self.exact:
            sums = local_blocksums(q, self.x_sh, own_l, bn=self.block_size,
                                   **self._kw)
        else:
            sums = self._raw_sums(q, l1_noise)
            corr = torch.arange(bl, device=q.device)[None, :] \
                == own_l[:, None]
            sums = torch.clamp(torch.where(corr, sums - 1.0, sums),
                               min=FLOOR)
        return torch.where(self._real[None, :], sums, 0.0)

    def _local_draw(self, src, q, qsq, sums_l, u):
        """One two-stage collective draw with uniforms ``u`` (3, w) --
        exactly one all-reduce.  Returns (nb, prob, T, status) replicated,
        T = the global degree estimate sum_p t_p; the status comes from
        the reduced values only."""
        u_shard, u_blk, u_in = u[0], u[1], u[2]
        w = src.shape[0]
        bl, bs, P = self.blocks_per_shard, self.block_size, self.num_shards
        t_l = sums_l.sum(dim=1)
        c = torch.cumsum(sums_l, dim=1)
        blk_l = torch.sum((u_blk * t_l)[:, None] > c, dim=1).clamp(0, bl - 1)
        s_b = torch.gather(sums_l, 1, blk_l[:, None])[:, 0]
        kv = _ref.kv_rows(q, self._views[0][blk_l], qsq,
                          self._views[1][blk_l], self._kw["kind"],
                          self._kw["inv_bw"], self._kw["beta"],
                          self._kw["pairwise"])
        gcols = (self._lo + blk_l[:, None] * bs
                 + torch.arange(bs, device=q.device)[None, :])
        live = (gcols < self.n) & (gcols != src[:, None])
        kv = torch.where(live, kv, 0.0)
        nb_l, pin = _ref.level2_draw(kv, live,
                                     torch.clamp(gcols, max=self.n - 1),
                                     u_in)
        # the one-hot payload, one f64 tensor: each slot has exactly one
        # nonzero contributor, so the sum is exact in any order
        pay = torch.zeros((w, 3, P), dtype=torch.float64, device=q.device)
        pay[:, 0, self.pidx] = t_l.double()
        pay[:, 1, self.pidx] = (s_b * pin).double()
        pay[:, 2, self.pidx] = nb_l.double()
        pay = all_reduce(pay, self.grp)
        t_all = pay[:, 0].float()
        q_all = pay[:, 1].float()
        nb_all = pay[:, 2].to(torch.int64)
        ct = torch.cumsum(t_all, dim=1)
        tot = ct[:, -1]
        owner = torch.sum((u_shard * tot)[:, None] > ct, dim=1).clamp(0,
                                                                       P - 1)
        nb = torch.gather(nb_all, 1, owner[:, None])[:, 0]
        prob = torch.gather(q_all, 1, owner[:, None])[:, 0] \
            / torch.clamp(tot, min=1e-30)
        st = _g.merge(_g.totals_status(tot, self.num_blocks, FLOOR),
                      _g.result_status(prob))
        return nb, prob, tot, st

    def _local_sample_exact(self, src, q, qsq, sums_l, u_draws, u_acc,
                            rounds: int, slack: float):
        """Theorem 4.12 rejection rounds on the sharded draw: draw 0 is
        the round-0 proposal, draw r + 1 and ``u_acc[r]`` round r's; the
        degree estimate is each draw's reduced total.  Returns (cur,
        status, fallback count); the acceptance is computed from
        replicated values, so it needs no collective."""
        cur, _, zs, st = self._local_draw(src, q, qsq, sums_l, u_draws[0])
        accepted = torch.zeros(src.shape[0], dtype=torch.bool,
                               device=src.device)
        for r in range(rounds):
            cand, qd, _, st_r = self._local_draw(src, q, qsq, sums_l,
                                                 u_draws[r + 1])
            st = st | st_r
            kuv = _ref.kv_pairs(q, self.x_rep[cand], self._kw["kind"],
                                self._kw["inv_bw"], self._kw["beta"],
                                self._kw["pairwise"])
            ratio = kuv / torch.clamp(slack * qd * zs, min=1e-30)
            acc = ~accepted & (u_acc[r] < torch.clamp(ratio, max=1.0))
            cur = torch.where(acc, cand, cur)
            accepted |= acc
        fallbacks = torch.sum(~accepted)
        st = st | _g.flag_if(fallbacks > 0, _g.REJECT_EXHAUSTED)
        return cur, st, fallbacks

    def _l1_evals(self, w: int) -> int:
        """Global realized level-1 kernel evals of one frontier sweep:
        every shard sweeps its whole padded slice (exact) or its ``B_p s``
        stratified subsample."""
        if self.exact:
            return w * self.n_pad
        return w * self.num_blocks_pad * self.samples_per_block

    def _idx(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, torch.int64)

    # ------------------------------------------------------------------ #
    # public programs
    # ------------------------------------------------------------------ #
    def patch_rows(self, slots, rows):
        """Scatter a mutation batch into the replicated padded copy (the
        rank's shard is a view of it, so it follows): zero collectives.
        Derived level-1 caches are the caller's to patch or drop.  Returns
        a zero-eval counter word."""
        slots = self._idx(slots)
        rows = as_f32(rows, self.device)
        self.x_rep.index_copy_(0, slots, rows)
        self.x_sq_rep.index_copy_(0, slots, torch.sum(rows * rows, dim=-1))
        return _c.word()

    def masked_block_sums(self, src, l1_noise=None):
        """§2-contract level-1 sums of a frontier: ``(sums, word)`` with
        ``sums`` this shard's (w, B_p) columns; no collective.  The word
        carries no status: a non-finite local sum shows in the reduced
        totals of the draw or ``prob_of`` that reads it (a local check
        would differ from rank to rank)."""
        src = self._idx(src)
        sums = self._local_sums(self.x_rep[src], src // self.block_size,
                                l1_noise)
        w = src.shape[0]
        return sums, _c.word(evals=self._l1_evals(w), l1_reads=w)

    def fused_sample(self, src, l1_noise, u):
        """One depth-2 collective draw: (nb, prob, local level-1 sums,
        word), one all-reduce (PSUMS slot 1).  ``u`` is (3, w) (or (1, 3,
        w))."""
        src = self._idx(src)
        q, qsq = self.x_rep[src], self.x_sq_rep[src]
        sums = self._local_sums(q, src // self.block_size, l1_noise)
        nb, prob, _, st = self._local_draw(src, q, qsq, sums,
                                           u.reshape(3, -1))
        w = src.shape[0]
        cw = _c.word(status=st, evals=self._l1_evals(w)
                     + w * self.block_size * self.num_shards,
                     l1_reads=w, draws=w, psums=1)
        return nb, prob, sums, cw

    def sample_from_block_sums(self, src, sums, u):
        """The depth-2 collective draw from cached local sums (the §4
        caching contract: no re-sweep): (nb, prob, word), one all-reduce,
        no level-1 evals."""
        src = self._idx(src)
        nb, prob, _, st = self._local_draw(src, self.x_rep[src],
                                           self.x_sq_rep[src], sums,
                                           u.reshape(3, -1))
        w = src.shape[0]
        cw = _c.word(status=st, evals=w * self.block_size * self.num_shards,
                     draws=w, psums=1)
        return nb, prob, cw

    def prob_of_from_block_sums(self, src, dst, sums):
        """q(dst | src) from cached local sums: the owner shard's block sum
        and the local total, reduced in ONE all-reduce, times the in-block
        probability of the exact level-2 row (replicated: every rank reads
        the padded copy).  Returns ``(probs, word)``."""
        src, dst = self._idx(src), self._idx(dst)
        bl, bs = self.blocks_per_shard, self.block_size
        blk = dst // bs
        loc = blk - self.pidx * bl
        mine = (loc >= 0) & (loc < bl)
        s_dst = torch.gather(sums, 1, torch.clamp(loc, 0, bl - 1)[:, None])
        pay = torch.stack([sums.sum(dim=1).double(),
                           torch.where(mine, s_dst[:, 0], 0.0).double()])
        pay = all_reduce(pay, self.grp).float()
        pb = pay[1] / pay[0]
        views = _ref.block_views(self.x_rep, self.x_sq_rep, bs)
        kv, live, _ = _ref.level2_row(self.x_rep, self.x_sq_rep, views, src,
                                      blk, self._kw["kind"],
                                      self._kw["inv_bw"], self._kw["beta"],
                                      bs, self.n, self._kw["pairwise"])
        col = (dst - blk * bs)[:, None]
        kd = torch.gather(kv, 1, col)[:, 0]
        rowsum = kv.sum(dim=1)
        live_d = torch.gather(live, 1, col)[:, 0].to(kv.dtype)
        pin_fb = live_d / torch.clamp(live.sum(dim=1).to(kv.dtype), min=1.0)
        pin = torch.where(rowsum > 0.0, kd / torch.clamp(rowsum, min=1e-30),
                          pin_fb)
        prob = pb * pin
        st = _g.merge(_g.totals_status(pay[0], self.num_blocks, FLOOR),
                      _g.result_status(prob))
        return prob, _c.word(status=st, evals=src.shape[0] * bs, psums=1)

    def sample_exact(self, src, sums, u_draws, u_acc, *, rounds: int,
                     slack: float):
        """Theorem 4.12 rejection-exact draw from cached local sums, with
        ``u_draws`` (rounds + 1, 3, w) and ``u_acc`` (rounds, w).  Returns
        (cur, word, fallback count): ``rounds + 1`` all-reduces."""
        src = self._idx(src)
        cur, st, fb = self._local_sample_exact(
            src, self.x_rep[src], self.x_sq_rep[src], sums, u_draws, u_acc,
            rounds, slack)
        w = src.shape[0]
        cw = _c.word(status=st, evals=(rounds + 1) * w * self.block_size
                     * self.num_shards + rounds * w * self.num_shards,
                     draws=(rounds + 1) * w, psums=rounds + 1)
        cw[_c.RETRIES] = fb
        return cur, cw, fb

    def walk_scan(self, starts, noise, *, rounds: int = 0,
                  slack: float = 2.0, record_path: bool = False):
        """Walk steps as a device loop: the frontier stays replicated and
        every step is one level-1 read and one two-stage draw (one
        all-reduce; ``rounds + 1`` on the rejection-exact path).
        ``noise`` yields one ``(l1_noise, u_draws (rounds + 1, 3, w),
        u_acc (rounds, w) or None)`` a step.  Returns (end, path, word,
        fallbacks)."""
        cur = self._idx(starts)
        st = torch.zeros((), dtype=torch.int64, device=self.device)
        fb = torch.zeros((), dtype=torch.int64, device=self.device)
        path = []
        steps = 0
        for l1, u_draws, u_acc in noise:
            q, qsq = self.x_rep[cur], self.x_sq_rep[cur]
            sums = self._local_sums(q, cur // self.block_size, l1)
            if rounds > 0:
                cur, st_k, fb_k = self._local_sample_exact(
                    cur, q, qsq, sums, u_draws, u_acc, rounds, slack)
                fb = fb + fb_k
            else:
                cur, _, _, st_k = self._local_draw(cur, q, qsq, sums,
                                                   u_draws[0])
            st = st | st_k
            steps += 1
            if record_path:
                path.append(cur)
        w = cur.shape[0]
        draws_per = rounds + 1 if rounds > 0 else 1
        per_step = (self._l1_evals(w)
                    + draws_per * w * self.block_size * self.num_shards
                    + rounds * w * self.num_shards)
        cw = _c.word(status=st, evals=steps * per_step, l1_reads=steps * w,
                     draws=steps * draws_per * w, psums=steps * draws_per)
        cw[_c.RETRIES] = fb
        out_path = torch.stack(path) if record_path and path else None
        return cur, out_path, cw, fb

    def edge_batch_scan(self, cdf, degs, inv_total, inv_t, noise, *,
                        batch: int):
        """All Algorithm 5.1 edge batches as a device loop: u by
        replicated inverse CDF over the degree prefix, v | u by the
        two-stage draw (one all-reduce a batch), the collapsed reverse
        probability and the reweighting replicated.  ``noise`` yields one
        ``(u_vert (batch,), l1_noise, u (3, batch))`` a batch.  Returns
        ((T, batch) u, v, wgt, q_uv, q_vu, word)."""
        kw = self._kw
        cdf, degs = cdf.to(self.device), degs.to(self.device)
        outs = [[] for _ in range(5)]
        st = torch.zeros((), dtype=torch.int64, device=self.device)
        steps = 0
        for u_vert, l1, u in noise:
            u_idx = _ref.inverse_cdf_index(cdf, u_vert)
            q, qsq = self.x_rep[u_idx], self.x_sq_rep[u_idx]
            sums = self._local_sums(q, u_idx // self.block_size, l1)
            v, q_uv, _, st_b = self._local_draw(u_idx, q, qsq, sums,
                                                u.reshape(3, -1))
            kuv = _ref.kv_pairs(q, self.x_rep[v], kw["kind"], kw["inv_bw"],
                                kw["beta"], kw["pairwise"])
            q_vu = kuv / torch.clamp(degs[v], min=FLOOR)
            q_edge = inv_total * (degs[u_idx] * q_uv + kuv)
            wgt = kuv * inv_t / torch.clamp(q_edge, min=1e-30)
            st = st | st_b | _g.result_status(wgt, q_vu)
            for o, r in zip(outs, (u_idx, v, wgt, q_uv, q_vu)):
                o.append(r)
            steps += 1
        # per batch: one level-1 sweep + the speculative level-2 rows on
        # every shard + the replicated k(u, v) pair on every shard
        per_batch = (self._l1_evals(batch)
                     + batch * self.block_size * self.num_shards
                     + batch * self.num_shards)
        cw = _c.word(status=st, evals=steps * per_batch,
                     l1_reads=steps * batch, draws=steps * batch,
                     psums=steps)
        return tuple(torch.stack(o) for o in outs) + (cw,)

    def triangle_edge_scan(self, u, v, degs, l1_noise, u_draws):
        """Theorem 6.17's per-edge inner loop sharded: orientation
        replicated, ONE local level-1 read of the oriented v frontier
        shared by every draw, then ``len(u_draws)`` two-stage draws (one
        all-reduce each, uniforms (3, m) each) with the ordering mask and
        the reweighting.  Returns (u', v', W_e, word)."""
        kw = self._kw
        u, v = self._idx(u), self._idx(v)
        degs = degs.to(self.device)
        prec = _ref.degree_precedes(degs, u, v)
        uu = torch.where(prec, u, v)
        vv = torch.where(prec, v, u)
        q, qsq = self.x_rep[vv], self.x_sq_rep[vv]
        xu = self.x_rep[uu]
        kuv = _ref.kv_pairs(xu, q, kw["kind"], kw["inv_bw"], kw["beta"],
                            kw["pairwise"])
        sums = self._local_sums(q, vv // self.block_size, l1_noise)
        acc = torch.zeros_like(kuv)
        st = torch.zeros((), dtype=torch.int64, device=self.device)
        num_draws = len(u_draws)
        for ud in u_draws:
            w, _, _, st_k = self._local_draw(vv, q, qsq, sums,
                                             ud.reshape(3, -1))
            valid = _ref.degree_precedes(degs, vv, w) & (w != uu)
            kuw = _ref.kv_pairs(xu, self.x_rep[w], kw["kind"], kw["inv_bw"],
                                kw["beta"], kw["pairwise"])
            acc = acc + torch.where(valid, kuv * kuw, 0.0)
            st = st | st_k
        w_hat = acc * degs[vv] / num_draws
        st = _g.merge(st, _g.result_status(w_hat))
        m = u.shape[0]
        cw = _c.word(status=st, evals=self._l1_evals(m) + m * self.num_shards
                     + num_draws * (m * self.block_size * self.num_shards
                                    + m * self.num_shards),
                     l1_reads=m, draws=num_draws * m, psums=num_draws)
        return uu, vv, w_hat, cw

    # ------------------------------------------------------------------ #
    # KDE-structure reads (the Definition 1.1 surface)
    # ------------------------------------------------------------------ #
    def kde_query(self, y, l1_noise=None):
        """Row-sum estimates of replicated queries: ``((m,), word)`` -- the
        local sweep (one rowsum launch on the card) or the local
        stratified block sums, then one all-reduce."""
        y = as_f32(y, self.device)
        if self.exact:
            part = local_rowsum(y, self.x_sh, **self._kw)
        else:
            part = self._raw_sums(y, l1_noise).sum(dim=1)
        est = all_reduce(part, self.grp)
        m = y.shape[0]
        return est, _c.word(status=_g.nonfinite_status(est),
                            evals=self._l1_evals(m), l1_reads=m, psums=1)

    def kernel_rows(self, q):
        """Exact (m, n) kernel rows against the sharded dataset: the local
        column block, then one all-gather of the column shards.  Evals
        count the padded sweep every shard realizes."""
        q = as_f32(q, self.device)
        kw = self._kw
        part = _ref.kv_matrix(q, self.x_sh, self.x_sq_sh, kw["kind"],
                              kw["inv_bw"], kw["beta"], kw["pairwise"])
        out = all_gather(part, self.grp, dim=1)[:, :self.n]
        return out, _c.word(status=_g.nonfinite_status(out),
                            evals=q.shape[0] * self.n_pad)

    def degrees_ring(self, kernel):
        """Algorithm 4.3 over the sharded dataset: the ring accumulation
        (O(n^2 / P) work a shard, one rowsum launch a step on the card)
        minus the kernel's actual diagonal, then one all-gather.  Returns
        the replicated ((n,) degrees, word); no all-reduce."""
        rows = max(0, min(self.n - self._lo, self.shard_size))
        deg_l = _ring_degrees(self.x_sh, kernel, self.grp, rows)
        deg = all_gather(deg_l, self.grp)[:self.n]
        return deg, _c.word(status=_g.nonfinite_status(deg),
                            evals=self.n_pad * self.n_pad)


# --------------------------------------------------------------------- #
# builders for caller-sharded datasets (the ``core.kde.distributed`` API)
# --------------------------------------------------------------------- #
def make_kde_query(mesh, kernel, data_axes: Sequence[str] = ("data",)):
    """Definition 1.1 over a caller-sharded dataset: f(y replicated, x_l
    this rank's shard) -> (m,) replicated row sums, the local sweep (the
    rowsum kernel on the card) and one all-reduce."""
    grp = mesh_group(mesh, data_axes)
    kw = _kind_args(kernel)

    def f(y, x_l):
        y = as_f32(y, grp.device)
        return all_reduce(local_rowsum(y, as_f32(x_l, grp.device), **kw),
                          grp)
    return f


def make_block_sums(mesh, kernel, num_blocks_per_shard: int,
                    data_axes: Sequence[str] = ("data",)):
    """Level-1 block sums over a caller-sharded dataset, ragged-safe: a
    shard whose row count the block count does not divide is padded with
    far-offset sentinel rows (kernel values exactly 0), so tail blocks sum
    only their real rows.  Returns f(y, x_l[, own]) -> (m, P B) replicated
    (the local sums, then one all-gather of the shards' columns).  With
    ``own`` (each query's global block index, or -1) the §2 contract
    applies: k(y, y) = 1 subtracted from the own block and every real
    block floored at 1e-12 (the masked-blocksum kernel on the card)."""
    grp = mesh_group(mesh, data_axes)
    kw = _kind_args(kernel)
    nb = int(num_blocks_per_shard)

    def f(y, x_l, own=None):
        y = as_f32(y, grp.device)
        x_l = as_f32(x_l, grp.device)
        ns = x_l.shape[0]
        bs_l = -(-ns // nb)
        pad = nb * bs_l - ns
        if pad:
            sent = torch.full((pad, x_l.shape[1]), _PAD_OFFSET,
                              dtype=torch.float32, device=x_l.device) \
                + x_l[-1:]
            x_l = torch.cat([x_l, sent], dim=0)
        if own is None:
            sums = local_blocksums(y, x_l, None, bn=bs_l, **kw)
        else:
            own = torch.as_tensor(own).to(grp.device, torch.int64)
            own_l = own - grp.index * nb
            own_l = torch.where((own_l >= 0) & (own_l < nb), own_l,
                                torch.full_like(own_l, -1))
            sums = local_blocksums(y, x_l, own_l, bn=bs_l, **kw)
            base = torch.arange(nb, device=y.device) * bs_l
            real = torch.clamp(ns - base, 0, bs_l) > 0
            sums = torch.where(real[None, :], sums, 0.0)
        return all_gather(sums, grp, dim=1)
    return f


def make_degree_ring(mesh, kernel, data_axes: Sequence[str] = ("data",)):
    """Algorithm 4.3 over a caller-sharded dataset (equal shards): f(x_l)
    -> the replicated (n,) degrees, by the flattened ring with the
    actual-diagonal correction, then one all-gather."""
    grp = mesh_group(mesh, data_axes)

    def f(x_l):
        x_l = as_f32(x_l, grp.device)
        deg_l = _ring_degrees(x_l, kernel, grp, x_l.shape[0])
        return all_gather(deg_l, grp)
    return f


# --------------------------------------------------------------------- #
# standalone sharded programs
# --------------------------------------------------------------------- #
def sharded_noisy_power(mesh, ksub, v0, us, *, num_samples: int,
                        data_axes: Sequence[str] = ("data",)):
    """BIMW21 noisy power method with the t x t submatrix sharded over
    columns: the importance draw (uniforms ``us`` (iters, num_samples),
    replicated) and the renormalization are replicated, the sampled
    matvec is a local masked gather + a partial matvec + ONE all-reduce an
    iteration, and the Rayleigh quotient one more.  The same math and
    noise as ``ops.noisy_power_scan`` (the partial sums reorder the
    accumulation: floats agree to f32 tolerance).  Returns ``(lam, v,
    word)``: DRAWS the importance draws, PSUMS ``iters + 1``."""
    grp = mesh_group(mesh, data_axes)
    dev = grp.device
    P = grp.size
    ksub = as_f32(ksub, dev)
    t = int(ksub.shape[0])
    cols = -(-t // P)
    t_pad = cols * P
    if t_pad != t:
        ksub = torch.nn.functional.pad(ksub, (0, t_pad - t))
    off = grp.index * cols
    ksub_l = ksub[:, off:off + cols]
    v = as_f32(v0, dev)
    us = us.to(dev)
    st = torch.zeros((), dtype=torch.int64, device=dev)
    for u in us:
        absv = torch.abs(v)
        z = torch.sum(absv)
        cdf = torch.cumsum(absv, dim=0)
        uu = u * torch.clamp(z, min=1e-30)
        idx = torch.clamp(torch.searchsorted(cdf, uu, right=True), 0, t - 1)
        sel = (idx >= off) & (idx < off + cols)
        lidx = torch.clamp(idx - off, 0, cols - 1)
        contrib = torch.sign(v[idx]) * z / num_samples * sel
        w = all_reduce(ksub_l[:, lidx] @ contrib, grp)
        nw = torch.linalg.norm(w)
        ok = (nw > 0.0) & (z > 0.0)
        st = st | _g.flag_if(~ok, _g.ZERO_MASS) | _g.nonfinite_status(w)
        v = torch.where(ok, w / torch.clamp(nw, min=1e-30), v)
    vp = torch.nn.functional.pad(v, (0, t_pad - t))
    av = all_reduce(ksub_l @ vp[off:off + cols], grp)
    lam = v @ av
    st = _g.merge(st, _g.result_status(lam, v))
    iters = int(us.shape[0])
    return lam, v, _c.word(status=st, draws=iters * int(num_samples),
                           psums=iters + 1)
