"""Spectral sparsification of the kernel graph -- Algorithm 5.1 / Theorem 5.3.

Length-squared sampling of the edge-vertex incidence matrix H: sample
u ~ p_hat (degrees), v ~ q_hat(.|u) (neighbor sampler), and reweight each
drawn edge by 1 / (t * (p_u q_uv + p_v q_vu)), with the exact probabilities
the samplers used.  One device dataset and one level-1 structure serve the
degree preprocessing and every edge batch whenever the sampler's read
implements the requested estimator:

* ``estimator="stratified"`` (the default, with ``exact_blocks=False``) --
  ``samples_per_block`` subsampled rows a level-1 block: degrees and every
  edge batch's level-1 read at O(B s) evals a row, plain torch ops;
* ``estimator="exact", exact_blocks=True`` -- exact level-1 reads: degrees
  through the blocksum kernel, edge batches through the sample-block
  kernel;
* ``estimator="hash"`` -- the sub-linear hashed estimator of Section 3.1:
  the dataset is hashed once, degrees through the weighted-kv-sum kernel,
  every edge batch's level-1 read through the weighted-kv kernel.

The mixed pairings (``exact`` or ``rs`` degrees on a stratified sampler,
``stratified`` degrees on an exact one) build a standalone estimator for
the degrees, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.sampling.edge import (NeighborSampler,
                                            shared_level1_estimator)
from repro_torch.core.sampling.vertex import DegreeSampler
from repro_torch.device import as_f32, resolve_device


@dataclasses.dataclass
class SparseGraph:
    """Fixed-size COO edge list (undirected; i < j not enforced)."""
    n: int
    src: np.ndarray       # (m,) int64
    dst: np.ndarray       # (m,) int64
    weight: np.ndarray    # (m,) float64
    kde_queries: int = 0
    kernel_evals: int = 0
    # or-fold of the status bits of every program the pipeline ran (not
    # in the reference's SparseGraph; ``ft.guards.decode_status`` reads it)
    status: int = 0
    # (n,) the degrees the edge sources were drawn from (not in the
    # reference's SparseGraph either); None after ``resparsify``
    degrees: Optional[np.ndarray] = None

    @property
    def num_edges(self) -> int:
        """Number of (possibly repeated) sampled edges."""
        return len(self.src)

    def adjacency_dense(self) -> np.ndarray:
        """Dense symmetric adjacency (evaluation only)."""
        a = np.zeros((self.n, self.n))
        np.add.at(a, (self.src, self.dst), self.weight)
        np.add.at(a, (self.dst, self.src), self.weight)
        return a

    def laplacian_dense(self) -> np.ndarray:
        """Dense Laplacian (evaluation only)."""
        a = self.adjacency_dense()
        return np.diag(a.sum(axis=1)) - a

    def matvec(self, v: np.ndarray) -> np.ndarray:
        """L v without materializing L."""
        av = np.zeros_like(v)
        np.add.at(av, self.src, self.weight * v[self.dst])
        np.add.at(av, self.dst, self.weight * v[self.src])
        deg = np.zeros_like(v)
        np.add.at(deg, self.src, self.weight)
        np.add.at(deg, self.dst, self.weight)
        return deg * v - av


def spectral_sparsify(x, kernel: Kernel, num_edges: int,
                      estimator: str = "stratified", seed: int = 0,
                      batch: int = 1024, exact_blocks: bool = False,
                      samples_per_block: int = 16, mesh=None,
                      device=None) -> SparseGraph:
    """Algorithm 5.1 with edge budget ``num_edges`` (= t).

    ONE device dataset + level-1 structure is shared between the degree
    preprocessing and the neighbor sampler; the degree CDF lives on the
    device (float64-accumulated prefix, rounded to f32), and all edge
    batches -- steps (a)-(d) including the reverse probability and the
    reweighting -- run as one device loop with a single transfer of the
    edge list to the host.  With ``estimator="hash"`` both the degree
    preprocessing and the per-edge level-1 reads run on the hashed
    estimator (one shared bucket layout): total kernel evals drop from
    O((n + t) B s) to O((n + t)(max_bucket + num_far)).  With ``mesh=`` (a
    ``DeviceMesh``, every rank calling) the same program runs sharded
    (DESIGN.md §9): the level-1 state is mesh-resident and each edge batch
    performs one all-reduce; there the hashed estimator covers the degrees
    only (the draws stay on the blocked engine).
    """
    n = int(x.shape[0])
    t = int(num_edges)
    nbr = NeighborSampler(x, kernel, mode="blocked", seed=seed + 2,
                          exact_blocks=exact_blocks,
                          samples_per_block=samples_per_block, mesh=mesh,
                          level1="hash" if estimator == "hash"
                          and mesh is None else "blocked",
                          device=device)
    # Degree preprocessing (Algorithm 4.3) against the sampler's own
    # level-1 structure whenever it implements the requested estimator.
    est = shared_level1_estimator(nbr, estimator, seed=seed)
    deg = DegreeSampler(est, seed=seed + 1,
                        mesh=mesh if est is nbr.blocks else None)
    u, v, w, _, _ = nbr.edge_batches(deg.cdf_device, deg.degrees_device,
                                     deg.total, t, batch=batch)
    g = SparseGraph(n, u.astype(np.int64), v.astype(np.int64),
                    w.astype(np.float64))
    g.kernel_evals = nbr.evals + (0 if est is nbr.blocks else est.evals)
    g.status = nbr.status | est.device_counters.status
    g.degrees = deg.degrees
    # degree preprocessing + one forward level-1 read per drawn edge (the
    # reverse probability collapses onto the preprocessed degrees)
    drawn = ((t + batch - 1) // batch) * batch
    g.kde_queries = n + drawn
    return g


def resparsify(g: SparseGraph, num_edges: int, seed: int = 0) -> SparseGraph:
    """Second-stage size reduction: length-squared resampling of the
    explicit graph (no KDE queries)."""
    rng = np.random.default_rng(seed)
    p = g.weight / g.weight.sum()
    idx = rng.choice(g.num_edges, size=num_edges, p=p, replace=True)
    w = g.weight[idx] / (num_edges * p[idx])
    return SparseGraph(g.n, g.src[idx], g.dst[idx], w,
                       kde_queries=g.kde_queries, kernel_evals=g.kernel_evals,
                       status=g.status)


def incidence_row_norms(kernel: Kernel, x, device=None) -> np.ndarray:
    """||H_{uv}||^2 = 2 k(u, v) over the pairs u < v (row-major upper
    triangle) -- test helper for Lemma 5.6 invariants.  The kernel matrix
    is built on ``device`` (the card unless ``device="cpu"``)."""
    k = kernel.matrix(as_f32(x, resolve_device(device))).cpu().numpy()
    iu = np.triu_indices(k.shape[0], 1)
    return 2.0 * k[iu]
