"""Weighted neighbor / edge sampling -- Algorithms 4.11 and 4.13.

Given a vertex u, sample a neighbor v with Pr[v] ~= k(u, v) / deg(u)
(Definition 4.10) through the depth-2 block factorization of DESIGN.md §2:
level-1 block sums and a block draw, then the exact level-2 row and the
in-block draw.  Three level-1 reads are ported (``mode="blocked"``):

* ``exact_blocks=False`` (the reference's default) -- stratified block
  estimates from ``samples_per_block`` uniformly subsampled rows a block
  at O(B s) evals per frontier row, then an inverse-CDF block draw;
* ``exact_blocks=True`` -- exact masked block sums and a Gumbel-max block
  draw in one sample-block kernel call;
* ``level1="hash"`` -- block masses estimated by the ``kde_hash``
  padded-bucket estimator (exact NEAR members + HT FAR samples scattered
  into their blocks, through the weighted-kv kernel) at O(max_bucket +
  B far_per_block) evals per frontier row, then an inverse-CDF block
  draw (DESIGN.md §10).

``precision="bf16"`` (DESIGN.md §14) runs every level-1 read of the
sampler in the bf16 policy (the bf16 kernel instances on the card, as the
shared block structure's own sums); level-2 rows, draws and probabilities
stay f32.

``sample`` returns the *realized* sampling probability of each drawn
neighbor, and ``prob_of`` evaluates the probability the sampler assigns to
an arbitrary (u, v) -- both are required by the sparsifier (Alg 5.1 steps
(c)-(d)).  ``sample_exact`` corrects the estimated law to the exact one by
Theorem 4.12's rejection rounds.  ``walk`` runs Algorithm 4.16's random
walks and ``triangle_batches`` Theorem 6.17's per-edge loop, each as one
device loop over the sampler's level-1 read.

Level-1 caching contract (DESIGN.md §4): the masked block sums of the most
recent frontier stay on the device; ``sample`` / ``prob_of`` /
``sample_exact`` on the *same* frontier reuse them instead of re-sweeping
the dataset, which makes ``prob_of`` exactly consistent with the
(random, on the stratified and hashed reads) estimates ``sample``
realized.

``mode="tree"`` is the paper's literal dyadic descent over a
``MultiLevelKDE`` (``tree=``): two child-segment queries a level (one
rowsum kernel call each with ``ExactKDE`` nodes on the card), then the
exact leaf row, all on the host, drawing from a numpy generator seeded by
``seed`` in the reference's order.

With ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``; blocked mode,
``level1="blocked"``, f32 only) the level-1 block structure lives sharded
over the mesh's ``data_axes`` inside a ``ShardedKDE`` and every draw is the
two-stage collective program of DESIGN.md §9 (one all-reduce a draw batch,
``kde_sampler.sharded``): the same law as the flat draw, the same §4
caching contract and the same eval counters.  Every rank of the mesh calls
each entry point with the same arguments (SPMD); the noise comes from the
sampler's generator, in step on every rank.

With ``dataset=`` (a ``DynamicDataset``, DESIGN.md §12) the blocked
engine builds over the padded capacity and every public entry brings it
to the dataset's current epoch: the cached level-1 sums are patched by
the mutation delta (``ops.patch_block_sums``) or dropped when a frontier
row itself mutated, a hashed level-1 patches its bucket layout, and a
journal gap rebuilds the block structure.  A caller's frontier holding a
dead slot raises ``EPOCH_STALE``.

Randomness comes from one ``torch.Generator`` on the sampler's device,
seeded from ``seed``.  Every program's counter word folds into
``device_counters`` and ``status``; under ``REPRO_CHECKS=1`` fatal flags
raise ``EstimationError``.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dataset import attach_device
from repro_torch.core.kde.base import (ExactBlockKDE, StratifiedKDE,
                                       make_estimator)
from repro_torch.core.kde.distributed import ShardedKDE
from repro_torch.core.kernels_fn import Kernel
from repro_torch.device import as_f32, no_switch, resolve_device
from repro_torch.ft import guards as _g
from repro_torch.kernels.kde_sampler import ops as _ops
from repro_torch.kernels.kde_sampler import ref as _ref
from repro_torch.kernels.kde_sampler.sharded import mesh_device
from repro_torch.kernels.kde_sampler.ref import (check_precision,
                                                 static_pairwise)
from repro_torch.obs import counters as _c

# Flags a healthy pipeline may legitimately raise (accuracy, not validity).
_BENIGN = _g.BUCKET_OVERFLOW | _g.HT_HEAVY | _g.REJECT_EXHAUSTED


class NeighborSampler:
    """Algorithm 4.11 / Theorem 4.12: sample v ~ k(u, v)/deg(u) given u.

    Cost per sample: one level-1 read (w*B*s stratified, w*n exact,
    w*(max_bucket + B far_per_block) hashed kernel evals for a
    w-frontier) plus w exact level-2 rows of ``block_size`` columns.

    >>> nbr = NeighborSampler(x, gaussian(1.0))
    >>> v, q = nbr.sample(np.array([0, 1, 2]))
    """

    def __init__(self, x, kernel: Kernel, mode: str = "blocked",
                 block_size: Optional[int] = None, samples_per_block: int = 16,
                 exact_blocks: bool = False, tree=None, seed: int = 0,
                 use_pallas: Optional[bool] = None,
                 interpret: Optional[bool] = None, mesh=None,
                 data_axes=("data",), level1: str = "blocked",
                 hash_opts: Optional[dict] = None, dataset=None,
                 precision: str = "f32", device=None):
        no_switch("use_pallas", use_pallas)
        no_switch("interpret", interpret)
        if mode not in ("blocked", "tree"):
            raise ValueError(mode)
        if level1 not in ("blocked", "hash"):
            raise ValueError(f"unknown level1 {level1!r}")
        if level1 == "hash" and exact_blocks:
            raise ValueError("level1='hash' replaces the level-1 read with "
                             "hashed estimates; exact_blocks=True (the "
                             "reproducible exact read) cannot be honored "
                             "-- pick one")
        if mesh is not None:
            if mode != "blocked":
                raise ValueError("mesh= needs the blocked engine")
            if level1 == "hash":
                raise ValueError("level1='hash' is single-device for now; "
                                 "the sharded hash table covers queries "
                                 "(kde_hash.sharded), not draws")
            if precision != "f32":
                raise ValueError(
                    "precision='bf16' is single-device for now: the "
                    "sharded one-all-reduce schedule is pinned f32 (see "
                    "DESIGN.md §14)")
        self._mesh = mesh
        self._axes = tuple(data_axes)
        self._engine = None
        # streaming attach (DESIGN.md §12): engines build over the padded
        # capacity; every public entry epoch-checks and patches or rebuilds
        self._dataset = dataset
        self._ds_epoch = int(dataset.epoch) if dataset is not None else 0
        if dataset is not None:
            if mode != "blocked":
                raise ValueError("dataset= needs the blocked engine")
            device = attach_device(dataset, device)
            x = dataset.x_pad
        # the level-1 sweep's dtype policy (DESIGN.md §14), checked against
        # the kernel kind before anything is built
        check_precision(precision, kernel.name, static_pairwise(kernel))
        self.device = (mesh_device(mesh, device) if mesh is not None
                       else resolve_device(device))
        self.kernel = kernel
        self.mode = mode
        self.level1 = level1
        self.precision = precision
        self._seed0 = seed
        self._spb0 = samples_per_block
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.status = 0
        self.flag_counts: Counter = Counter()
        self.device_counters = _c.HostTotals()
        self._extra_evals = 0
        self.exact_draws = 0
        self.exact_fallbacks = 0
        self._hash = None
        self._hstate = None
        if mode == "tree":
            if tree is None:
                raise ValueError("tree mode needs a MultiLevelKDE")
            self.x = as_f32(x, self.device)
            self.x_sq = torch.sum(self.x * self.x, dim=-1)
            self.n = int(self.x.shape[0])
            self._tree = tree
            return
        n = int(x.shape[0])
        bs = block_size or max(int(np.sqrt(n)), 16)
        self.exact_blocks = exact_blocks
        # ONE device dataset + one precomputed-norms sweep, shared with the
        # block KDE structure (and, through ``blocks``, with any degree
        # sampler built on top of it -- DESIGN.md §6).
        self._build_blocks(x, bs)
        self._far_per_block = 1
        if level1 == "hash":
            # Hashed level-1 (DESIGN.md §10), with the reference's defaults:
            # ``far_per_block`` stratified FAR slots per block, buckets of
            # at most 128 stored members, layout seed ``seed + 7919``.
            from repro_torch.core.kde.hashed import HashedKDE
            hopts = dict(hash_opts or {})
            self._far_per_block = int(hopts.pop("far_per_block", 2))
            hopts.setdefault("max_bucket", 128)
            self._hash = HashedKDE(self.x, kernel, seed=seed + 7919,
                                   precision=precision, device=self.device,
                                   dataset=dataset, **hopts)
            self._hstate = self._hash.state
        self._cfg = dict(kind=kernel.name, inv_bw=1.0 / kernel.bandwidth,
                         beta=getattr(kernel, "beta", 1.0),
                         pairwise=static_pairwise(kernel),
                         block_size=self.block_size,
                         num_blocks=self.num_blocks, n=self.n,
                         s=self._blocks.samples_per_block,
                         exact=exact_blocks, level1=level1,
                         num_far=self._far_per_block, precision=precision)
        self._l2_cfg = {k: self._cfg[k] for k in
                        ("kind", "inv_bw", "beta", "pairwise", "block_size",
                         "n")}
        self._noise_cfg = {k: self._cfg[k] for k in
                           ("level1", "exact", "num_far", "block_size")}
        # (digest, block sums, frontier indices) of the cached frontier;
        # the indices let the streaming sync decide patch-vs-drop
        self._l1_cache: Optional[
            Tuple[bytes, torch.Tensor, np.ndarray]] = None

    def _build_blocks(self, x, bs: int) -> None:
        """The level-1 block structure over ``x`` (also the streaming
        rebuild: the block size is kept, the block count follows the
        capacity) and the dataset views every read shares; on a mesh the
        ``ShardedKDE`` whose engine every draw runs on."""
        if self._mesh is not None:
            self._blocks = ShardedKDE(
                self._mesh, x, self.kernel, block_size=bs,
                samples_per_block=self._spb0, exact=self.exact_blocks,
                data_axes=self._axes, seed=self._seed0, device=self.device)
            self._engine = self._blocks.engine
            self.x = self._blocks.x
            self.x_sq = self._blocks.x_sq
            self.n = self._blocks.n
            self.block_size = self._blocks.block_size
            self.num_blocks = self._blocks.num_blocks
            self._views = None
            return
        if self.exact_blocks:
            self._blocks = ExactBlockKDE(x, self.kernel, block_size=bs,
                                         precision=self.precision,
                                         device=self.device)
        else:
            self._blocks = StratifiedKDE(x, self.kernel, block_size=bs,
                                         samples_per_block=self._spb0,
                                         seed=self._seed0,
                                         precision=self.precision,
                                         device=self.device)
        if self._dataset is not None:
            # the dataset's tensors themselves: mutations scatter into them
            self._blocks.x_sq = self._dataset.x_sq_pad
        self.x = self._blocks.x
        self.x_sq = self._blocks.x_sq
        self.n = self._blocks.n
        self.block_size = self._blocks.block_size
        self.num_blocks = self._blocks.num_blocks
        self._views = _ref.block_views(self.x, self.x_sq, self.block_size)

    # ------------------------------------------------------------------ #
    @property
    def blocks(self):
        """The level-1 KDE structure (blocked mode), shared with the
        sparsifier's degree preprocessing."""
        self._blocked("blocks")
        return self._blocks

    @property
    def hash_estimator(self):
        """The shared hashed-KDE estimator behind ``level1="hash"`` --
        exposed so Algorithm 4.3 degree preprocessing reuses the one
        bucket layout instead of hashing the dataset twice."""
        if self._hash is None:
            raise ValueError("hash_estimator needs a level1='hash' sampler")
        return self._hash

    @property
    def evals(self) -> int:
        """Total kernel evaluations across the level-1 structure (the tree
        in tree mode) and every sampling call -- the paper's Section 7
        cost metric."""
        base = self._tree if self.mode == "tree" else self._blocks
        return base.evals + self._extra_evals

    def _count(self, k: int) -> None:
        self._extra_evals += int(k)

    def _blocked(self, what: str) -> None:
        if self.mode != "blocked":
            raise ValueError(f"{what} needs the blocked engine")

    def _level1_evals(self, w: int) -> int:
        """Kernel evals of one level-1 read of a w-frontier: the bucket
        width plus ``far_per_block`` FAR slots per block when hashed, n
        per row when exact, B * s per row when stratified -- the shapes
        the counter words are built from."""
        return w * _ops._l1_cols(self.level1, self.exact_blocks,
                                 self.num_blocks, self._cfg["s"], self.n,
                                 self._far_per_block, self._hstate)[0]

    def _noise(self, w: int):
        """The noise of one depth-2 step on this sampler's level-1 read."""
        return _ops.draw_sample_noise(w, self.num_blocks, self._gen,
                                      self.device, **self._noise_cfg)

    def _note(self, word, context: str) -> int:
        """Fold one program's counter word into the counters, then apply
        the ``REPRO_CHECKS`` policy (fatal flags raise, benign ones pass)."""
        s = self.device_counters.note(word)
        self.status |= s
        _g.count_flags(self.flag_counts, s)
        _g.raise_on_status(s, context=context, allow=_BENIGN)
        return s

    def _flag(self, status: int, context: str) -> None:
        """Fold a host-raised status bit (no program word) into the
        counters and apply the ``REPRO_CHECKS`` policy."""
        self.status |= status
        _g.count_flags(self.flag_counts, status)
        _g.raise_on_status(status, context=context, allow=_BENIGN)

    # ------------------------------------------------------------------ #
    # streaming contract (DESIGN.md §12)
    def _rebuild(self) -> None:
        """Full level-1 rebuild over the dataset's current padded tensor --
        the journal-gap / capacity-growth path of the streaming contract.
        Block size and precision are kept; the block count follows the new
        capacity."""
        self._build_blocks(self._dataset.x_pad, self.block_size)
        self._cfg.update(n=self.n, num_blocks=self.num_blocks)
        self._l2_cfg["n"] = self.n
        self._l1_cache = None

    def _sync(self) -> None:
        """Epoch check at every public entry: refresh the dataset views,
        patch the cached level-1 read by the coalesced mutation delta
        (O(w m) evals; dropped instead when a cached frontier row itself
        mutated), and let a hashed level-1 run its own patch-or-rebuild.
        A journal gap falls back to ``_rebuild``.  The mutations scattered
        into the dataset's tensors in place, so only the block views (a
        padded copy) and the norms binding need refreshing."""
        ds = self._dataset
        if ds is None or self._ds_epoch == int(ds.epoch):
            return
        from repro_torch.core.dataset import coalesce_mutations
        batches = ds.mutations_since(self._ds_epoch)
        if batches is None:
            self._rebuild()
        elif self._engine is not None:
            # mesh path: patch the engine's copies (zero collectives); the
            # cached level-1 sums are sharded, so they are dropped
            slots, _, new_x, _, _ = coalesce_mutations(batches)
            self._blocks.patch_rows(slots, new_x)
            self._l1_cache = None
        else:
            slots, old_x, new_x, _, _ = coalesce_mutations(batches)
            self.x = self._blocks.x = ds.x_pad
            self.x_sq = self._blocks.x_sq = ds.x_sq_pad
            self._views = _ref.block_views(self.x, self.x_sq,
                                           self.block_size)
            if self._l1_cache is not None:
                dig, bs, src32 = self._l1_cache
                if np.intersect1d(src32, np.asarray(slots, np.int64)).size:
                    self._l1_cache = None   # frontier row itself mutated
                else:
                    dev = self.device
                    bs, cw = _ops.patch_block_sums(
                        bs, self.x,
                        torch.as_tensor(src32.astype(np.int64)).to(dev),
                        torch.as_tensor(slots.astype(np.int64)).to(dev),
                        torch.as_tensor(old_x).to(dev),
                        torch.as_tensor(new_x).to(dev),
                        kind=self._cfg["kind"], inv_bw=self._cfg["inv_bw"],
                        beta=self._cfg["beta"], pairwise=self._cfg["pairwise"],
                        block_size=self.block_size)
                    self._count(2 * len(src32) * len(slots))
                    self._note(cw, "NeighborSampler.sync")
                    self._l1_cache = (dig, bs, src32)
        if self._hash is not None:
            self._hash._sync()
            self._hstate = self._hash.state
        self._ds_epoch = int(ds.epoch)

    def _check_frontier(self, src, context: str) -> None:
        """Liveness gate for caller-supplied frontiers: referencing a
        deleted slot folds ``EPOCH_STALE`` into the status (an
        ``EstimationError`` under ``REPRO_CHECKS=1`` -- the flag is not
        benign)."""
        ds = self._dataset
        if ds is not None and not ds.is_live(np.asarray(src)):
            self._flag(_g.EPOCH_STALE, context)

    def _enter(self, context: str, *frontiers) -> None:
        """A blocked public entry: sync to the dataset's epoch, then check
        the caller's frontiers are live."""
        self._blocked(context)
        self._sync()
        if frontiers:
            self._check_frontier(np.concatenate(
                [np.asarray(f).reshape(-1) for f in frontiers]), context)

    @staticmethod
    def _digest(src32: np.ndarray) -> bytes:
        """Cache key for a frontier: dtype-normalized indices + length."""
        return src32.shape[0].to_bytes(8, "little") + src32.tobytes()

    def _frontier(self, src):
        src32 = np.ascontiguousarray(np.asarray(src), np.int32)
        return src32, torch.as_tensor(src32.astype(np.int64)).to(self.device)

    def _level1(self, src32: np.ndarray, src_dev: torch.Tensor):
        """Masked level-1 block sums for a frontier, cached per frontier."""
        dig = self._digest(src32)
        if self._l1_cache is not None and self._l1_cache[0] == dig:
            return self._l1_cache[1]
        if self._engine is not None:
            bs, cw = self._engine.masked_block_sums(
                src_dev, self._engine.draw_level1_noise(self._gen))
        else:
            l1_noise = _ops._level1_noise(len(src32), self.num_blocks,
                                          self._gen, self.device,
                                          **self._noise_cfg)
            bs, cw = _ops.masked_block_sums(self.x, self.x_sq, src_dev,
                                            l1_noise, self._hstate,
                                            **self._cfg)
        self._count(self._level1_evals(len(src32)))
        self._note(cw, "NeighborSampler.level1")
        self._l1_cache = (dig, bs, src32)
        return bs

    def sample(self, src: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Sample one neighbor per source.  Returns (neighbors, probs)."""
        if self.mode == "tree":
            return self._sample_tree(np.asarray(src))
        self._enter("NeighborSampler.sample", src)
        src32, src_dev = self._frontier(src)
        w = len(src32)
        dig = self._digest(src32)
        eng = self._engine
        if eng is not None and self._l1_cache is not None \
                and self._l1_cache[0] == dig:
            nb, prob, st = eng.sample_from_block_sums(
                src_dev, self._l1_cache[1], eng.draw_noise(w, self._gen))
        elif eng is not None:
            nb, prob, bs, st = eng.fused_sample(
                src_dev, eng.draw_level1_noise(self._gen),
                eng.draw_noise(w, self._gen))
            self._count(self._level1_evals(w))
            self._l1_cache = (dig, bs, src32)
        elif self._l1_cache is not None and self._l1_cache[0] == dig:
            u_blk = torch.rand(w, generator=self._gen, device=self.device)
            u_in = torch.rand(w, generator=self._gen, device=self.device)
            nb, prob, st = _ops.sample_from_block_sums(
                self.x, self.x_sq, src_dev, self._l1_cache[1], u_blk, u_in,
                self._views, **self._l2_cfg)
        else:
            nb, prob, bs, st = _ops.fused_sample(
                self.x, self.x_sq, src_dev, *self._noise(w),
                views=self._views, hstate=self._hstate, **self._cfg)
            self._count(self._level1_evals(w))
            self._l1_cache = (dig, bs, src32)
        self._count(w * self.block_size)
        self._note(st, "NeighborSampler.sample")
        return nb.cpu().numpy(), prob.cpu().numpy()

    def prob_of(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Probability the sampler assigns to edge (src -> dst)."""
        if self.mode == "tree":
            return self._prob_of_tree(np.asarray(src), np.asarray(dst))
        self._enter("NeighborSampler.prob_of", src, dst)
        src32, src_dev = self._frontier(src)
        bs = self._level1(src32, src_dev)
        dst_dev = torch.as_tensor(np.asarray(dst, np.int64)).to(self.device)
        if self._engine is not None:
            out, cw = self._engine.prob_of_from_block_sums(src_dev, dst_dev,
                                                           bs)
        else:
            out, cw = _ops.prob_of_from_block_sums(
                self.x, self.x_sq, src_dev, dst_dev, bs, self._views,
                **self._l2_cfg)
        self._count(len(src32) * self.block_size)
        self._note(cw, "NeighborSampler.prob_of")
        return out.cpu().numpy()

    def sample_exact(self, src: np.ndarray, rounds: int = 8,
                     slack: float = 2.0) -> np.ndarray:
        """Theorem 4.12 exactness: rejection-sample against exact weights.

        Proposal = this sampler; target ~ k(u, v).  Accept v with
        probability k(u,v) / (c * q(v) * Z_hat), where Z_hat estimates
        deg(u) from the level-1 sums and c = ``slack`` covers the
        estimator distortion.  Fixed-round vectorized accept/reject; a row
        whose rounds all reject keeps its round-0 proposal (probability
        (1-1/c)^rounds), counted in ``exact_fallbacks``.  The level-1 read
        happens once (cached per frontier); every round and Z_hat share
        it.  Tree mode runs the same rounds on the host over its own
        draws."""
        if self.mode == "tree":
            return self._sample_exact_host(np.asarray(src), rounds, slack)
        self._enter("NeighborSampler.sample_exact", src)
        src32, src_dev = self._frontier(src)
        w = len(src32)
        bs = self._level1(src32, src_dev)
        if self._engine is not None:
            eng = self._engine
            cur, cw, fb = eng.sample_exact(
                src_dev, bs, eng.draw_noise(w, self._gen, rounds + 1),
                torch.rand((rounds, w), generator=self._gen,
                           device=self.device), rounds=rounds, slack=slack)
        else:
            noise = _ops.draw_exact_noise(w, rounds, self._gen, self.device)
            cur, cw, fb = _ops.fused_sample_exact(
                self.x, self.x_sq, src_dev, bs, *noise, self._views,
                rounds=rounds, slack=slack, **self._l2_cfg)
        self._count((rounds + 1) * w * self.block_size + rounds * w)
        self._note(cw, "NeighborSampler.sample_exact")
        self.exact_draws += w
        self.exact_fallbacks += int(fb)
        _g.warn_fallback_rate(self.exact_fallbacks, self.exact_draws,
                              rounds, slack,
                              context="NeighborSampler.sample_exact")
        return cur.cpu().numpy()

    def _sample_exact_host(self, src: np.ndarray, rounds: int,
                           slack: float) -> np.ndarray:
        cur, _ = self.sample(src)
        xs = self.x[torch.as_tensor(src.astype(np.int64)).to(self.device)]
        zs = np.maximum(self._tree.segment_query(xs, 0, self._tree.n)
                        .cpu().numpy() - 1.0, 1e-12)
        accepted = np.zeros(len(src), bool)
        for _ in range(rounds):
            cand, q = self.sample(src)
            xc = self.x[torch.as_tensor(cand).to(self.device)]
            kuv = self.kernel.pairs(xs, xc).cpu().numpy()
            self._count(len(src))
            ratio = kuv / np.maximum(slack * q * zs, 1e-30)
            acc = (~accepted) & (self._rng.uniform(size=len(src))
                                 < np.minimum(ratio, 1.0))
            cur = np.where(acc, cand, cur)
            accepted |= acc
        return cur

    # ------------------------------------------------------------------ #
    # tree mode (faithful Algorithm 4.11)
    def _descend(self, s: int, q: torch.Tensor, target=None):
        """Walk the tree from the root for source ``s``: at each internal
        node the two child-segment estimates (own segment corrected by
        k(x, x) = 1) split the mass; the branch is drawn from ``_rng``, or
        forced towards ``target``.  Returns the leaf and the probability
        of reaching it."""
        tree = self._tree
        lo, hi, p = 0, tree.n, 1.0
        while not tree.is_leaf(lo, hi):
            (l0, l1), (r0, r1) = tree.children(lo, hi)
            a = float(tree.segment_query(q, l0, l1)[0])
            b = float(tree.segment_query(q, r0, r1)[0])
            if l0 <= s < l1:
                a = max(a - 1.0, 1e-12)
            if r0 <= s < r1:
                b = max(b - 1.0, 1e-12)
            pa = a / max(a + b, 1e-30)
            left = (self._rng.uniform() <= pa) if target is None \
                else (l0 <= target < l1)
            if left:
                lo, hi, p = l0, l1, p * pa
            else:
                lo, hi, p = r0, r1, p * (1.0 - pa)
        return lo, hi, p

    def _leaf_row(self, s: int, q: torch.Tensor, lo: int, hi: int):
        """Exact kernel row of the source over its leaf, self edge at 0."""
        kv = self.kernel.pairwise(q, self.x[lo:hi])[0].cpu().numpy() \
            .astype(np.float32)
        self._count(hi - lo)
        kv[np.arange(lo, hi) == s] = 0.0
        return kv

    def _sample_tree(self, src: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        out = np.zeros(len(src), np.int64)
        probs = np.ones(len(src), np.float64)
        for i, s in enumerate(src):
            s = int(s)
            q = self.x[s][None, :]
            lo, hi, p = self._descend(s, q)
            kv = self._leaf_row(s, q, lo, hi)
            pin = kv / max(kv.sum(), 1e-30)
            j = self._rng.choice(len(pin), p=pin / pin.sum())
            out[i] = lo + j
            probs[i] = p * pin[j]
        return out, probs

    def _prob_of_tree(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        out = np.zeros(len(src), np.float64)
        for i, (s, t) in enumerate(zip(src, dst)):
            s, t = int(s), int(t)
            q = self.x[s][None, :]
            lo, hi, p = self._descend(s, q, target=t)
            kv = self._leaf_row(s, q, lo, hi)
            out[i] = p * kv[t - lo] / max(kv.sum(), 1e-30)
        return out

    # ------------------------------------------------------------------ #
    def edge_batches(self, cdf_device: torch.Tensor,
                     degs_device: torch.Tensor, total_degree: float, t: int,
                     batch: int = 1024,
                     generator: Optional[torch.Generator] = None):
        """Algorithm 5.1 edge sampling: ``ceil(t / batch)`` iid edge
        batches as one device loop -- u ~ degrees via the device prefix
        CDF, v | u via the depth-2 engine, the collapsed reverse
        probability q_vu = k(u,v)/deg(v), and the importance weight
        ``k(u,v) / (t q_e)`` -- returning the first t edges as (u, v,
        weight, q_uv, q_vu) numpy arrays.  Extra draws of the final
        partial batch are discarded (edges are iid)."""
        self._enter("NeighborSampler.edge_batches")
        t = int(t)
        num_batches = max((t + batch - 1) // batch, 1)
        gen = self._gen if generator is None else generator
        if self._engine is not None:
            eng = self._engine
            noise = ((torch.rand(batch, generator=gen, device=self.device),
                      eng.draw_level1_noise(gen), eng.draw_noise(batch, gen))
                     for _ in range(num_batches))
            *data, word = eng.edge_batch_scan(
                cdf_device, degs_device, 1.0 / float(total_degree), 1.0 / t,
                noise, batch=int(batch))
        else:
            *data, word = _ops.edge_batch_scan(
                self.x, self.x_sq, cdf_device.to(self.device),
                degs_device.to(self.device), 1.0 / float(total_degree),
                1.0 / t, gen, num_batches, self._hstate, batch=int(batch),
                **self._cfg)
        drawn = num_batches * batch
        # per edge: one level-1 read of the u frontier, one exact level-2
        # row, and one aligned k(u, v) pair
        self._count(self._level1_evals(drawn) + drawn * self.block_size
                    + drawn)
        self._l1_cache = None  # frontier moved; cached sums are stale
        self._note(word, "NeighborSampler.edge_batches")
        return tuple(a.reshape(-1)[:t].cpu().numpy() for a in data)

    # ------------------------------------------------------------------ #
    def triangle_batches(self, u: np.ndarray, v: np.ndarray,
                         degs_device: torch.Tensor, num_draws: int,
                         generator: Optional[torch.Generator] = None):
        """Theorem 6.17's inner loop on the device: orient the (u, v)
        vertex pairs by the degree-then-index order, read the oriented v
        frontier's level-1 sums ONCE (one masked-blocksum launch on the
        exact read), draw ``num_draws`` neighbors w ~ k(v, .)/deg(v) from
        them, and reweight; one transfer of (u', v', W_e) to the host.

        Cost: one level-1 read of the m-edge frontier plus, per draw, m
        exact level-2 rows and m aligned k(u, w) pairs -- ``m*(B*s + 1) +
        num_draws*m*(bs + 1)`` kernel evals for stratified reads
        (``m*(n + 1) + ...`` exact)."""
        self._enter("NeighborSampler.triangle_batches", u, v)
        m = len(np.asarray(u))
        gen = self._gen if generator is None else generator
        if self._engine is not None:
            eng = self._engine
            uu, vv, w_hat, cw = eng.triangle_edge_scan(
                self._frontier(u)[1], self._frontier(v)[1], degs_device,
                eng.draw_level1_noise(gen),
                eng.draw_noise(m, gen, int(num_draws)))
        else:
            l1 = _ops._level1_noise(m, self.num_blocks, gen, self.device,
                                    **self._noise_cfg)
            u_blk, u_in = (torch.rand((int(num_draws), m), generator=gen,
                                      device=self.device) for _ in range(2))
            uu, vv, w_hat, cw = _ops.triangle_edge_scan(
                self.x, self.x_sq, self._frontier(u)[1],
                self._frontier(v)[1], degs_device.to(self.device),
                (l1, u_blk, u_in), self._hstate, **self._cfg)
        self._count(self._level1_evals(m) + m
                    + int(num_draws) * (m * self.block_size + m))
        self._l1_cache = None  # frontier moved; cached sums are stale
        self._note(cw, "NeighborSampler.triangle_batches")
        return uu.cpu().numpy(), vv.cpu().numpy(), w_hat.cpu().numpy()

    # ------------------------------------------------------------------ #
    def walk(self, starts: np.ndarray, length: int, exact: bool = False,
             rounds: int = 8, slack: float = 2.0,
             generator: Optional[torch.Generator] = None,
             record_path: bool = False):
        """Run |starts| walks of ``length`` steps on the device: the
        frontier never leaves it, and each step is one depth-2 draw
        (``exact=True``: one level-1 read and Theorem 4.12's ``rounds``
        rejection rounds).  A stratified sampler's walks read level 1 from
        the walk-resident cache (``ops.walk_layout``).  Returns
        (endpoints, (length, w) path) as numpy arrays; with
        ``record_path=False`` (default) the path is not kept and None is
        returned in its place -- the endpoints are the same either way
        (same noise)."""
        self._enter("NeighborSampler.walk", starts)
        w = len(np.asarray(starts))
        gen = self._gen if generator is None else generator
        rounds_k = rounds if exact else 0
        if self._engine is not None:
            eng = self._engine
            noise = ((eng.draw_level1_noise(gen),
                      eng.draw_noise(w, gen, rounds_k + 1),
                      torch.rand((rounds_k, w), generator=gen,
                                 device=self.device))
                     for _ in range(int(length)))
            end, path, word, fb = eng.walk_scan(
                self._frontier(starts)[1], noise, rounds=rounds_k,
                slack=slack, record_path=bool(record_path))
        else:
            noise = _ops.draw_walk_noise(
                int(length), w, self.num_blocks, gen, self.device,
                n=self.n, s=self._cfg["s"], rounds=rounds_k,
                **self._noise_cfg)
            end, path, word, fb = _ops.walk_scan(
                self.x, self.x_sq, self._frontier(starts)[1], noise,
                self._hstate, rounds=rounds_k, slack=slack,
                record_path=bool(record_path), **self._cfg)
        if self._engine is None and _ops.walk_cached(self.level1,
                                                     self.exact_blocks):
            # the walk-resident cache: B * s_eff cached columns a row and
            # level-2 rows (and rejection rows) wbs wide
            wbs, w_blocks, s_eff = _ops.walk_layout(
                self.n, self.block_size, self.num_blocks, self._cfg["s"])
            per_step = w * w_blocks * s_eff + w * wbs
        else:
            wbs = self.block_size
            per_step = self._level1_evals(w) + w * wbs
        if exact:
            per_step += rounds * (w * wbs + w)
        self._count(int(length) * per_step)
        self._l1_cache = None  # frontier moved; cached sums are stale
        self._note(word, "NeighborSampler.walk")
        if exact:
            self.exact_draws += w * int(length)
            self.exact_fallbacks += int(fb)
            _g.warn_fallback_rate(self.exact_fallbacks, self.exact_draws,
                                  rounds, slack,
                                  context="NeighborSampler.walk")
        return end.cpu().numpy(), (path.cpu().numpy() if record_path
                                   else None)


def shared_level1_estimator(nbr: NeighborSampler, estimator: str,
                            seed: int = 0):
    """Reuse ``nbr``'s level-1 structure as the degree estimator whenever
    it implements the requested one (DESIGN.md §6/§7): one device dataset,
    one ``x_sq`` sweep, one eval counter for the whole pipeline -- the
    stratified or exact block structure of a blocked sampler, the hashed
    bucket layout of a ``level1="hash"`` one.  ``robust`` builds its own
    staged chain; ``rs``, ``grid_hbe`` and the mismatched pairings (exact
    on a stratified sampler, stratified on an exact one, hash on a blocked
    one) get a standalone ``make_estimator`` over the sampler's device
    dataset, seeded by ``seed``."""
    if estimator == "robust":
        # the staged-fallback wrapper builds its own hash -> stratified ->
        # exact chain; sharing nbr's level-1 would tie its degradation
        # policy to the sampler's cache, so it gets a standalone build
        return make_estimator("robust", nbr.x, nbr.kernel, seed=seed,
                              device=nbr.device)
    if estimator == "hash":
        if nbr.level1 == "hash":
            return nbr.hash_estimator
        return make_estimator("hash", nbr.x, nbr.kernel, seed=seed,
                              device=nbr.device)
    wants_exact = estimator in ("exact", "exact_block")
    if wants_exact == nbr.exact_blocks and estimator not in ("rs",
                                                             "grid_hbe"):
        return nbr.blocks
    return make_estimator("exact" if estimator == "exact_block"
                          else estimator, nbr.x, nbr.kernel, seed=seed,
                          device=nbr.device)


class EdgeSampler:
    """Algorithm 4.13: vertex by degree, then neighbor by weight."""

    def __init__(self, degree_sampler, neighbor_sampler: NeighborSampler):
        self.deg = degree_sampler
        self.nbr = neighbor_sampler

    def sample(self, size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (u, v, p) with p the realized directional probability
        p_hat(u) * q_hat(v | u)."""
        u = self.deg.sample(size)
        v, q = self.nbr.sample(u)
        return u, v, self.deg.prob(u) * q
