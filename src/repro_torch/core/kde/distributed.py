"""Distributed KDE structures -- thin wrappers over the sharded engine.

The dataset X is sharded over the mesh's ``data_axes`` (each rank holds
n / P rows); Section 3 KDE queries, Algorithm 4.3 degree preprocessing and
the level-1 block-sum reads of the depth-2 sampler run as the collective
programs of ``repro_torch.kernels.kde_sampler.sharded``, on
``torch.distributed`` process groups.  Every entry point is SPMD: each rank
of the mesh calls it with the same arguments and gets the same replicated
result.

``ShardedKDE`` adapts the engine to the Definition 1.1 estimator
interface: a drop-in ``KDEBase`` for ``NeighborSampler`` /
``DegreeSampler`` / ``RowNormSampler`` whose ``query`` is one collective
program and whose ``engine`` carries the mesh-resident level-1 block
structure every pipeline shares.

The functional API (``sharded_kde_query`` / ``sharded_block_sums`` /
``degree_preprocessing`` / ``make_sharded_dataset``) serves callers that
hold their own shard of X: one all-reduce a query batch, one all-gather of
the shards' block columns, and the degree ring's ``P - 1`` exchanges of
shard-sized blocks then one all-gather of the degrees.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.device import as_f32
from repro_torch.kernels.kde_sampler import sharded as _sh
from repro_torch.kernels.kde_sampler.ref import BUILTIN_KINDS
from repro_torch.obs import counters as _c


def sharded_kde_query(mesh, kernel: Kernel,
                      data_axes: Sequence[str] = ("data",)):
    """Returns f(y: (m, d) replicated, x_l: this rank's shard) -> (m,)
    replicated row sums (Section 3 query; one all-reduce)."""
    return _sh.make_kde_query(mesh, kernel, data_axes)


def sharded_block_sums(mesh, kernel: Kernel, num_blocks_per_shard: int,
                       data_axes: Sequence[str] = ("data",)):
    """Level-1 read of the depth-2 sampler, distributed: every shard sums
    its own ``num_blocks_per_shard`` blocks, and the (m, P B) block-sum
    matrix is their concatenation in shard order (one all-gather).

    f(y: (m, d), x_l: (n / P, d)[, own: (m,)]) -> (m, P B) block sums.
    Ragged shards (a shard size the block count does not divide) are
    padded with the far-offset sentinel rows, so tail blocks sum only
    their real rows.  ``own`` (each query's global block index) applies
    the §2 sampling contract: self-block correction and the 1e-12 floor,
    the single-device ``ops.masked_block_sums`` on aligned layouts."""
    return _sh.make_block_sums(mesh, kernel, num_blocks_per_shard, data_axes)


def degree_preprocessing(mesh, kernel: Kernel,
                         data_axes: Sequence[str] = ("data",)):
    """Algorithm 4.3 distributed: every shard queries its own points
    against the whole (sharded) dataset through a ring of block exchanges
    -- O(n^2 / P) work a rank -- and returns the replicated (n,) degrees.

    The ring runs over the *flattened* index of all ``data_axes``
    (row-major), and the self kernel is removed by subtracting the
    kernel's *actual* per-point diagonal k(x_i, x_i)."""
    return _sh.make_degree_ring(mesh, kernel, data_axes)


def make_sharded_dataset(mesh, x, data_axes: Sequence[str] = ("data",)):
    """This rank's shard of the dataset over ``data_axes``: rows ``[p n /
    P, (p + 1) n / P)`` on the mesh's device (Section 3 queries never move
    X again).  n must be a multiple of the number of shards."""
    grp = _sh.mesh_group(mesh, data_axes)
    n = int(x.shape[0])
    if n % grp.size:
        raise ValueError(f"{n} rows do not split into {grp.size} equal "
                         f"shards")
    per = n // grp.size
    return as_f32(x[grp.index * per:(grp.index + 1) * per], grp.device)


class ShardedKDE:
    """Definition 1.1 estimator over a mesh-sharded dataset.

    A drop-in for ``StratifiedKDE`` / ``ExactBlockKDE`` in every pipeline:
    the same attributes (``x``, ``x_sq``, ``block_size``, ``num_blocks``,
    ``samples_per_block``, ``evals``, ``device``) and ``query`` semantics,
    with the level-1 state sharded on ``mesh`` inside ``self.engine`` (a
    ``kde_sampler.sharded.ShardedBlocks``), which ``NeighborSampler``'s mesh
    path shares for its collective draws (DESIGN.md §9).

    ``evals`` counts the single-device-equivalent cost (m n exact, m B s
    stratified a query batch), so counter audits agree with the flat
    engine exactly; ``device_counters`` holds the engine's padded
    realized work.  The stratified reads' uniforms come from a
    ``torch.Generator`` seeded with ``seed``, in step on every rank.

    >>> est = ShardedKDE(mesh, x, gaussian(1.0), exact=True)
    """

    def __init__(self, mesh, x, kernel: Kernel,
                 block_size: Optional[int] = None,
                 samples_per_block: int = 16, exact: bool = False,
                 data_axes: Sequence[str] = ("data",), seed: int = 0,
                 device=None):
        n = int(x.shape[0])
        bs = block_size or max(int(np.sqrt(n)), 16)
        self.engine = _sh.ShardedBlocks(
            mesh, x, kernel, block_size=bs,
            samples_per_block=samples_per_block, exact=exact,
            data_axes=data_axes, device=device)
        self.device = self.engine.device
        self.kernel = kernel
        self.n = n
        self.d = self.engine.d
        self.precision = "f32"
        # replicated views of the real rows (frontier gathers, queries)
        self.x = self.engine.x_rep[:n]
        self.x_sq = self.engine.x_sq_rep[:n]
        self.block_size = self.engine.block_size
        self.num_blocks = self.engine.num_blocks
        self.samples_per_block = self.engine.samples_per_block
        self.exact = bool(exact)
        self.evals = 0
        self.device_counters = _c.HostTotals()
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def patch_rows(self, slots, rows) -> None:
        """Streaming mutation passthrough (DESIGN.md §12): scatter the
        mutated rows into the engine's copies (zero collectives).  The
        replicated views consumers hold are views of them, so they
        follow."""
        self.engine.patch_rows(slots, rows)

    def _query_evals(self, m: int) -> int:
        if self.exact:
            return m * self.n
        return m * self.num_blocks * self.samples_per_block

    def query(self, y) -> torch.Tensor:
        """(m, d) replicated queries -> (m,) row-sum estimates; one local
        sweep + one all-reduce (Section 3)."""
        y = as_f32(y, self.device)
        self.evals += self._query_evals(y.shape[0])
        est, cw = self.engine.kde_query(
            y, self.engine.draw_level1_noise(self._gen))
        self.device_counters.note(cw)
        return est

    def query1(self, y) -> float:
        """Single-point convenience wrapper around ``query``."""
        return float(self.query(y[None, :])[0])

    def degrees(self, batch: int = 1024) -> np.ndarray:
        """Algorithm 4.3 on the mesh: an exact estimator runs the ring (one
        rowsum launch a step on the card, O(shard^2) live memory); a
        stratified one runs batched collective queries of ``batch`` rows.
        Both subtract the kernel's actual diagonal."""
        if self.exact:
            self.evals += self.n * self.n
            deg, cw = self.engine.degrees_ring(self.kernel)
            self.device_counters.note(cw)
            return deg.cpu().numpy().astype(np.float64)
        total = np.zeros(self.n, np.float64)
        for lo in range(0, self.n, batch):
            hi = min(lo + batch, self.n)
            total[lo:hi] = self.query(self.x[lo:hi]).cpu().numpy()
        if self.kernel.name in BUILTIN_KINDS:
            return total - 1.0
        return total - self.kernel.pairs(self.x, self.x).cpu().numpy() \
            .astype(np.float64)
