"""Weighted neighbor / edge sampling -- Algorithms 4.11 and 4.13.

Given a vertex u, sample a neighbor v with Pr[v] = k(u, v) / deg(u)
(Definition 4.10) through the depth-2 block factorization of DESIGN.md §2:
exact masked level-1 block sums and a Gumbel-max block draw (one CUDA
kernel call), then the exact level-2 row and the in-block draw.  This slice
ports ``mode="blocked"`` with ``exact_blocks=True``.

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

from repro_torch.core.kde.base import ExactBlockKDE
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
    w-frontier) plus w exact level-2 rows of ``block_size`` columns.

    >>> nbr = NeighborSampler(x, gaussian(1.0), exact_blocks=True)
    >>> v, q = nbr.sample(np.array([0, 1, 2]))
    """

    def __init__(self, x, kernel: Kernel, mode: str = "blocked",
                 block_size: Optional[int] = None, exact_blocks: bool = False,
                 seed: int = 0, mesh=None, level1: str = "blocked",
                 dataset=None, precision: str = "f32", device=None):
        if mode != "blocked":
            raise not_in_slice(f"mode={mode!r}", "queue 1, item 5")
        if not exact_blocks:
            raise not_in_slice("exact_blocks=False (stratified level-1 "
                               "reads)", "queue 1, item 2")
        if mesh is not None:
            raise not_in_slice("mesh=", "queue 1, item 9")
        if level1 != "blocked":
            raise not_in_slice(f"level1={level1!r}", "queue 1, item 6")
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
        self._blocks = ExactBlockKDE(x, kernel, block_size=bs,
                                     precision=precision, device=self.device)
        self.x = self._blocks.x
        self.x_sq = self._blocks.x_sq
        self.n = self._blocks.n
        self.block_size = self._blocks.block_size
        self.num_blocks = self._blocks.num_blocks
        self.exact_blocks = True
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.status = 0
        self.flag_counts: Counter = Counter()
        self.device_counters = _c.HostTotals()
        self._extra_evals = 0
        self._cfg = self._blocks._static_cfg()
        self._l2_cfg = {k: self._cfg[k] for k in
                        ("kind", "inv_bw", "beta", "block_size", "n")}
        self._views = _ref.block_views(self.x, self.x_sq, self.block_size)
        # (digest, block sums, frontier indices) of the cached frontier
        self._l1_cache: Optional[
            Tuple[bytes, torch.Tensor, np.ndarray]] = None

    # ------------------------------------------------------------------ #
    @property
    def blocks(self) -> ExactBlockKDE:
        """The level-1 KDE structure, shared with the sparsifier's degree
        preprocessing."""
        return self._blocks

    @property
    def evals(self) -> int:
        """Total kernel evaluations across the level-1 structure and every
        sampling call -- the paper's Section 7 cost metric."""
        return self._blocks.evals + self._extra_evals

    def _count(self, k: int) -> None:
        self._extra_evals += int(k)

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
        bs, cw = _ops.masked_block_sums(self.x, self.x_sq, src_dev,
                                        **self._cfg)
        self._count(len(src32) * self.n)
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
            g, u_in = _ops.draw_sample_noise(w, self.num_blocks, self._gen,
                                             self.device)
            nb, prob, bs, st = _ops.fused_sample(self.x, self.x_sq, src_dev,
                                                 g, u_in, self._views,
                                                 **self._cfg)
            self._count(w * self.n)
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
            gen, num_batches, batch=int(batch), **self._cfg)
        drawn = num_batches * batch
        # per edge: one level-1 read of the u frontier, one exact level-2
        # row, and one aligned k(u, v) pair
        self._count(drawn * self.n + drawn * self.block_size + drawn)
        self._l1_cache = None  # frontier moved; cached sums are stale
        self._note(word, "NeighborSampler.edge_batches")
        return tuple(a.reshape(-1)[:t].cpu().numpy() for a in data)


def shared_level1_estimator(nbr: NeighborSampler, estimator: str,
                            seed: int = 0):
    """Reuse ``nbr``'s exact level-1 structure as the degree estimator
    (DESIGN.md §6/§7): one device dataset, one ``x_sq`` sweep, one eval
    counter for the whole pipeline."""
    if estimator in ("exact", "exact_block"):
        return nbr.blocks
    if estimator in ("rs", "stratified"):
        raise not_in_slice(f"estimator={estimator!r}", "queue 1, item 1")
    raise not_in_slice(f"estimator={estimator!r}", "queue 1, item 6")


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
