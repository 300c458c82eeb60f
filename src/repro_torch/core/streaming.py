"""Streaming kernel-graph engine -- the online face of the paper's toolkit.

Glues :class:`repro_torch.core.dataset.DynamicDataset` to the Table-1
sampling stack (DESIGN.md §12): ONE mutable versioned dataset feeds a
``NeighborSampler`` (depth-2 draws, Algorithm 4.11), a ``DegreeSampler``
(Algorithm 4.6 inverse-CDF over patched degrees) and -- with
``level1="hash"`` -- a ``HashedKDE`` (Section 3.1 bucket estimator with the
overflow region).  Mutations are O(m) journal appends plus in-place device
scatters; every consumer patches its derived state lazily at its next
query, so a burst of inserts costs one coalesced patch, not one rebuild
per batch.

Cost model per mutation batch of m rows over w-frontier consumers:
O(m d) device scatter + O(w m) level-1 patch + O(n m) degree patch +
O(m log) hash splices, against the frozen engines' O(w n + n^2 / budget +
n) rebuild.

>>> g = StreamingKernelGraph(x0, gaussian(1.0))
>>> g.insert(new_points); g.delete(dead_slots)
>>> u = g.sample_vertices(256); v, q = g.sample_neighbors(u)
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.dataset import DynamicDataset
from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.sampling.edge import NeighborSampler
from repro_torch.core.sampling.vertex import DegreeSampler
from repro_torch.ft import guards as _g
from repro_torch.kernels.kde_sampler.sharded import mesh_device


class StreamingKernelGraph:
    """Versioned mutable kernel graph with patch-on-read consumers.

    All sampling entry points answer at the dataset's CURRENT epoch -- the
    samplers sync themselves through the ``(dataset_id, epoch)`` cache
    contract, so interleaving mutations and queries is safe by
    construction (a stale externally-held frontier raises
    ``guards.EPOCH_STALE`` under ``REPRO_CHECKS=1`` instead of sampling
    from dead slots).  ``device=None`` places the dataset on the CUDA
    card; with ``mesh=`` (a ``DeviceMesh``) on the mesh's device, and the
    neighbor sampler's level-1 structure lives sharded over its
    ``data_axes`` (every rank calls each entry point).
    """

    def __init__(self, x, kernel: Kernel, capacity: Optional[int] = None,
                 level1: str = "blocked", seed: int = 0,
                 block_size: Optional[int] = None,
                 samples_per_block: int = 16,
                 hash_opts: Optional[dict] = None, mesh=None,
                 data_axes=("data",), device=None):
        if mesh is not None:
            device = mesh_device(mesh, device)
        self.dataset = DynamicDataset(x, capacity=capacity, device=device)
        self.kernel = kernel
        self.nbr = NeighborSampler(
            self.dataset.x_pad, kernel, mode="blocked",
            block_size=block_size, samples_per_block=samples_per_block,
            seed=seed, level1=level1, hash_opts=hash_opts, mesh=mesh,
            data_axes=data_axes, dataset=self.dataset)
        est = (self.nbr.hash_estimator if level1 == "hash"
               else self.nbr.blocks)
        self.deg = DegreeSampler(est, seed=seed + 1, dataset=self.dataset)
        self.mutation_batches = 0
        self.rows_mutated = 0

    # ------------------------------------------------------- mutations
    def insert(self, rows) -> np.ndarray:
        """Append points; returns their slot ids.  O(m) -- consumers
        patch lazily at their next query."""
        slots = self.dataset.insert_rows(rows)
        self.mutation_batches += 1
        self.rows_mutated += len(slots)
        return slots

    def delete(self, slots) -> None:
        """Mask slots out of the graph (sentinel coordinates: exactly
        zero kernel mass; the slot ids are retired until ``compact``)."""
        self.dataset.delete_rows(slots)
        self.mutation_batches += 1
        self.rows_mutated += len(np.unique(np.asarray(slots)))

    def update(self, slots, rows) -> None:
        """Move live points to new coordinates in place."""
        self.dataset.update_rows(slots, rows)
        self.mutation_batches += 1
        self.rows_mutated += len(np.asarray(slots))

    # --------------------------------------------------------- queries
    @property
    def num_live(self) -> int:
        """Live point count (capacity minus retired slots)."""
        return self.dataset.num_live

    @property
    def epoch(self) -> int:
        """The dataset's monotone version counter."""
        return int(self.dataset.epoch)

    def degrees(self) -> np.ndarray:
        """Current approximate degree vector (dead slots exactly 0);
        patched by ``ops.degree_delta`` since the last read."""
        self.deg._sync()
        return self.deg.degrees

    def sample_vertices(self, size: int) -> np.ndarray:
        """u ~ deg(u) / sum deg at the current epoch (Algorithm 4.6)."""
        return self.deg.sample(size)

    def sample_neighbors(self, src: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """v ~ k(u, v)/deg(u) per source (Algorithm 4.11); the frontier
        must be live at the current epoch (else ``EPOCH_STALE``)."""
        return self.nbr.sample(src)

    def sample_edges(self, t: int, batch: int = 1024):
        """Algorithm 5.1 iid edge batches against the patched degree CDF
        -- (u, v, weight, q_uv, q_vu) numpy arrays of length ``t``."""
        self.deg._sync()
        return self.nbr.edge_batches(self.deg.cdf_device,
                                     self.deg.degrees_device,
                                     self.deg.total, t, batch=batch)

    def walk(self, starts: np.ndarray, length: int, **kw):
        """Algorithm 4.16 device walks from a live frontier."""
        return self.nbr.walk(starts, length, **kw)

    def status_report(self) -> dict:
        """Or-folded status flags + rebuild / patch counters for
        dashboards (names via ``guards.decode_status``)."""
        st = self.nbr.status
        hashed = self.nbr._hash
        if hashed is not None:
            st |= hashed.status
        return dict(epoch=self.epoch, num_live=self.num_live,
                    mutation_batches=self.mutation_batches,
                    rows_mutated=self.rows_mutated,
                    flags=_g.decode_status(st),
                    degree_rebuilds=self.deg.rebuilds,
                    hash_rebuilds=(hashed.rebuilds if hashed is not None
                                   else 0))
