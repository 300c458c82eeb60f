"""Total weighted-triangle estimation -- Theorem 6.17 (ELRS17 adapted).

Weight of a triangle = product of its three edge weights (Definition 6.16).
Estimator: sample a uniform set R of (vertex-pair) edges; for each e = (u, v)
with u < v in the degree ordering, estimate the weight W_e of triangles
*assigned* to e (third vertex w with u < v < w) by sampling neighbors
w ~ k(v, .)/deg(v) (the Section 4.3 primitive) and averaging
deg(v) * 1{v < w} * k(u,v) k(u,w); scale by #pairs / |R|.

The whole per-edge inner loop -- orientation, ONE level-1 read of the v
frontier shared by every draw, the neighbor draws, the ordering mask and
the reweighting -- runs on the device
(``NeighborSampler.triangle_batches``).  The degree estimates come from
the sampler's own level-1 structure (one KDE build for the whole
pipeline; exact degrees through the blocksum kernel on the card).

Oracle: w_T = (1/6) sum_{i != j != l} K_ij K_jl K_il via one dense matmul.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.sampling.edge import (NeighborSampler,
                                            shared_level1_estimator)
from repro_torch.core.sampling.vertex import approximate_degrees
from repro_torch.device import as_f32, resolve_device


@dataclasses.dataclass
class TriangleResult:
    """Theorem 6.17 output: the estimate and its sampling/eval budget."""

    total_weight: float
    kernel_evals: int
    num_edges_sampled: int
    neighbor_samples: int


def estimate_triangle_weight(x, kernel: Kernel, num_edges: int,
                             neighbor_samples: int,
                             estimator: str = "stratified", seed: int = 0,
                             mesh=None, device=None) -> TriangleResult:
    """Theorem 6.17: (1 +- eps) total triangle weight from ``num_edges``
    uniform vertex pairs and ``neighbor_samples`` weighted neighbor draws
    per pair -- query budget independent of n.  The pairs come from
    ``np.random.default_rng(seed)``, as the reference draws them.

    Cost (stratified level-1, m = num_edges, ns = neighbor_samples):
    ``n*B*s`` degree preprocessing + ``m*(B*s + 1)`` frontier read and
    k(u,v) pairs + ``ns*m*(bs + 1)`` draw/reweight evals.

    With ``mesh=`` the draws run on the sharded engine (one all-reduce a
    draw batch); the hashed estimator then covers the degrees only.

    >>> res = estimate_triangle_weight(x, gaussian(1.0), 400, 24)
    """
    n = int(x.shape[0])
    rng = np.random.default_rng(seed)
    nbr = NeighborSampler(x, kernel, mode="blocked", seed=seed + 1,
                          exact_blocks=(estimator in ("exact",
                                                      "exact_block")),
                          mesh=mesh,
                          level1="hash" if estimator == "hash"
                          and mesh is None else "blocked", device=device)
    est = shared_level1_estimator(nbr, estimator, seed=seed)
    deg = approximate_degrees(est)

    # R: uniform vertex pairs (every pair is an edge of the kernel graph);
    # orientation to u < v in the degree order happens on the device.
    u = rng.integers(0, n, size=num_edges)
    v = rng.integers(0, n - 1, size=num_edges)
    v = np.where(v >= u, v + 1, v)

    _, _, w_hat = nbr.triangle_batches(
        u, v, torch.as_tensor(deg, dtype=torch.float32), neighbor_samples)

    pairs = n * (n - 1) / 2.0
    total = float(w_hat.mean() * pairs)
    evals = nbr.evals + (0 if est is nbr.blocks else est.evals)
    return TriangleResult(total_weight=total, kernel_evals=evals,
                          num_edges_sampled=num_edges,
                          neighbor_samples=neighbor_samples)


def exact_triangle_weight(kernel: Kernel, x, device=None) -> float:
    """Oracle: (1/6) sum over ordered distinct triples of K_ij K_jl K_il
    (n^2 evals + one dense f32 matmul on ``device``, summed in float64)."""
    k = kernel.matrix(as_f32(x, resolve_device(device)))
    k.fill_diagonal_(0.0)
    # sum_{i,j} K_ij (K^2)_ij counts each unordered triangle 6 times.
    k2 = k @ k
    return float((k.double() * k2.double()).sum() / 6.0)
