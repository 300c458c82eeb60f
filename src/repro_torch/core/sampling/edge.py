"""Weighted neighbor / edge sampling -- Algorithms 4.11 and 4.13.

Given a vertex u, sample a neighbor v with Pr[v] ~= k(u, v) / deg(u)
(Definition 4.10) through the depth-2 block factorization of DESIGN.md §2:
level-1 block sums and a block draw, then the exact level-2 row and the
in-block draw.  Two level-1 reads are ported (``mode="blocked"``):

* ``exact_blocks=True`` -- exact masked block sums and a Gumbel-max block
  draw in one sample-block kernel call;
* ``level1="hash"`` -- block masses estimated by the ``kde_hash``
  padded-bucket estimator (exact NEAR members + HT FAR samples scattered
  into their blocks, through the weighted-kv kernel) at O(max_bucket +
  B far_per_block) evals per frontier row, then an inverse-CDF block
  draw (DESIGN.md §10).

``sample`` returns the *realized* sampling probability of each drawn
neighbor, and ``prob_of`` evaluates the probability the sampler assigns to
an arbitrary (u, v) -- both are required by the sparsifier (Alg 5.1 steps
(c)-(d)).

Level-1 caching contract (DESIGN.md §4): the masked block sums of the most
recent frontier stay on the device; ``sample`` / ``prob_of`` on the *same*
frontier reuse them instead of re-sweeping the dataset, which makes
``prob_of`` exactly consistent with the estimates ``sample`` realized.

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

from repro_torch.core.kde.base import ExactBlockKDE, StratifiedKDE
from repro_torch.core.kernels_fn import Kernel
from repro_torch.device import not_in_slice, resolve_device
from repro_torch.ft import guards as _g
from repro_torch.kernels.kde_sampler import ops as _ops
from repro_torch.kernels.kde_sampler import ref as _ref
from repro_torch.obs import counters as _c

# Flags a healthy pipeline may legitimately raise (accuracy, not validity).
_BENIGN = _g.BUCKET_OVERFLOW | _g.HT_HEAVY | _g.REJECT_EXHAUSTED


class NeighborSampler:
    """Algorithm 4.11 / Theorem 4.12: sample v ~ k(u, v)/deg(u) given u.

    Cost per sample: one level-1 read (w*n exact kernel evals for a
    w-frontier, w*(max_bucket + B far_per_block) hashed) plus w exact
    level-2 rows of ``block_size`` columns.

    >>> nbr = NeighborSampler(x, gaussian(1.0), exact_blocks=True)
    >>> v, q = nbr.sample(np.array([0, 1, 2]))
    """

    def __init__(self, x, kernel: Kernel, mode: str = "blocked",
                 block_size: Optional[int] = None, exact_blocks: bool = False,
                 seed: int = 0, mesh=None, level1: str = "blocked",
                 hash_opts: Optional[dict] = None, dataset=None,
                 precision: str = "f32", device=None):
        if mode != "blocked":
            raise not_in_slice(f"mode={mode!r}", "queue 1, item 5")
        if level1 not in ("blocked", "hash"):
            raise ValueError(f"unknown level1 {level1!r}")
        if level1 == "hash" and exact_blocks:
            raise ValueError("level1='hash' replaces the level-1 read with "
                             "hashed estimates; exact_blocks=True (the "
                             "reproducible exact read) cannot be honored "
                             "-- pick one")
        if level1 == "blocked" and not exact_blocks:
            raise not_in_slice("exact_blocks=False (stratified level-1 "
                               "reads)", "queue 1, item 2")
        if mesh is not None:
            raise not_in_slice("mesh=", "queue 1, item 9")
        if dataset is not None:
            raise not_in_slice("dataset=", "queue 1, item 7")
        self.device = resolve_device(device)
        self.kernel = kernel
        self.mode = mode
        self.level1 = level1
        self.precision = precision
        n = int(x.shape[0])
        bs = block_size or max(int(np.sqrt(n)), 16)
        # ONE device dataset + one precomputed-norms sweep, shared with the
        # block KDE structure (and, through ``blocks``, with any degree
        # sampler built on top of it -- DESIGN.md §6).
        if exact_blocks:
            self._blocks = ExactBlockKDE(x, kernel, block_size=bs,
                                         precision=precision,
                                         device=self.device)
        else:
            self._blocks = StratifiedKDE(x, kernel, block_size=bs,
                                         seed=seed, precision=precision,
                                         device=self.device)
        self.x = self._blocks.x
        self.x_sq = self._blocks.x_sq
        self.n = self._blocks.n
        self.block_size = self._blocks.block_size
        self.num_blocks = self._blocks.num_blocks
        self.exact_blocks = exact_blocks
        self._far_per_block = 1
        self._hash = None
        self._hstate = None
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
                                   **hopts)
            self._hstate = self._hash.state
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.status = 0
        self.flag_counts: Counter = Counter()
        self.device_counters = _c.HostTotals()
        self._extra_evals = 0
        self._cfg = dict(kind=kernel.name, inv_bw=1.0 / kernel.bandwidth,
                         beta=getattr(kernel, "beta", 1.0),
                         block_size=self.block_size,
                         num_blocks=self.num_blocks, n=self.n,
                         level1=level1, num_far=self._far_per_block)
        self._l2_cfg = {k: self._cfg[k] for k in
                        ("kind", "inv_bw", "beta", "block_size", "n")}
        self._views = _ref.block_views(self.x, self.x_sq, self.block_size)
        # (digest, block sums, frontier indices) of the cached frontier
        self._l1_cache: Optional[
            Tuple[bytes, torch.Tensor, np.ndarray]] = None

    # ------------------------------------------------------------------ #
    @property
    def blocks(self):
        """The level-1 KDE structure, shared with the sparsifier's degree
        preprocessing."""
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
        """Total kernel evaluations across the level-1 structure and every
        sampling call -- the paper's Section 7 cost metric."""
        return self._blocks.evals + self._extra_evals

    def _count(self, k: int) -> None:
        self._extra_evals += int(k)

    def _level1_evals(self, w: int) -> int:
        """Kernel evals of one level-1 read of a w-frontier: the bucket
        width plus ``far_per_block`` FAR slots per block when hashed, n
        per row when exact -- the shapes the counter words are built
        from."""
        return w * _ops._l1_cols(self.level1, self.num_blocks, self.n,
                                 self._far_per_block, self._hstate)[0]

    def _noise(self, w: int):
        """The noise of one depth-2 step on this sampler's level-1 read."""
        return _ops.draw_sample_noise(
            w, self.num_blocks, self._gen, self.device, level1=self.level1,
            num_far=self._far_per_block, block_size=self.block_size)

    def _note(self, word, context: str) -> int:
        """Fold one program's counter word into the counters, then apply
        the ``REPRO_CHECKS`` policy (fatal flags raise, benign ones pass)."""
        s = self.device_counters.note(word)
        self.status |= s
        _g.count_flags(self.flag_counts, s)
        _g.raise_on_status(s, context=context, allow=_BENIGN)
        return s

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
        off = (self._noise(len(src32))[0] if self.level1 == "hash"
               else None)
        bs, cw = _ops.masked_block_sums(self.x, self.x_sq, src_dev, off,
                                        self._hstate, **self._cfg)
        self._count(self._level1_evals(len(src32)))
        self._note(cw, "NeighborSampler.level1")
        self._l1_cache = (dig, bs, src32)
        return bs

    def sample(self, src: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Sample one neighbor per source.  Returns (neighbors, probs)."""
        src32, src_dev = self._frontier(src)
        w = len(src32)
        dig = self._digest(src32)
        if self._l1_cache is not None and self._l1_cache[0] == dig:
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
        src32, src_dev = self._frontier(src)
        bs = self._level1(src32, src_dev)
        dst_dev = torch.as_tensor(np.asarray(dst, np.int64)).to(self.device)
        out, cw = _ops.prob_of_from_block_sums(self.x, self.x_sq, src_dev,
                                               dst_dev, bs, self._views,
                                               **self._l2_cfg)
        self._count(len(src32) * self.block_size)
        self._note(cw, "NeighborSampler.prob_of")
        return out.cpu().numpy()

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
        t = int(t)
        num_batches = max((t + batch - 1) // batch, 1)
        gen = self._gen if generator is None else generator
        *data, word = _ops.edge_batch_scan(
            self.x, self.x_sq, cdf_device.to(self.device),
            degs_device.to(self.device), 1.0 / float(total_degree), 1.0 / t,
            gen, num_batches, self._hstate, batch=int(batch), **self._cfg)
        drawn = num_batches * batch
        # per edge: one level-1 read of the u frontier, one exact level-2
        # row, and one aligned k(u, v) pair
        self._count(self._level1_evals(drawn) + drawn * self.block_size
                    + drawn)
        self._l1_cache = None  # frontier moved; cached sums are stale
        self._note(word, "NeighborSampler.edge_batches")
        return tuple(a.reshape(-1)[:t].cpu().numpy() for a in data)


def shared_level1_estimator(nbr: NeighborSampler, estimator: str):
    """Reuse ``nbr``'s level-1 structure as the degree estimator
    (DESIGN.md §6/§7): one device dataset, one ``x_sq`` sweep, one eval
    counter for the whole pipeline -- the exact block structure of an
    ``exact_blocks=True`` sampler, the hashed bucket layout of a
    ``level1="hash"`` one.  Other pairings are not ported yet."""
    if estimator == "hash" and nbr.level1 == "hash":
        return nbr.hash_estimator
    if estimator in ("exact", "exact_block") and nbr.exact_blocks:
        return nbr.blocks
    raise not_in_slice(f"shared_level1_estimator(estimator={estimator!r})",
                       "queue 1, items 1-2")


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
