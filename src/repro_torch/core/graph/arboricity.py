"""Arboricity (densest-subgraph density) estimation -- Alg 6.14 / Thm 6.15.

Sample m = O(n Delta log n / eps^2) edges with probability proportional to
(an upper bound on) their weight, add each with weight w_e / (m p_e), and
return the densest-subgraph density of the sample (the Theorem-6.15
proof's unbiased estimator).

The edge-sampling loop IS the sparsifier's Algorithm 5.1 pipeline --
``NeighborSampler.edge_batches`` draws every (u, v, w_e/(m p_e)) tuple in
one device loop over a shared device degree CDF, with the reverse
probability collapsed to k(u,v)/deg(v) (DESIGN.md §6).

Offline solver: Charikar's greedy peel (a 2-approximation, on the host),
applied identically to the sampled graph and the exact oracle, so the
sampling claim (density preserved under subsampling) is evaluated apples
to apples (DESIGN.md §7).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.sampling.edge import (NeighborSampler,
                                            shared_level1_estimator)
from repro_torch.core.sampling.vertex import DegreeSampler
from repro_torch.core.sparsify import SparseGraph
from repro_torch.device import as_f32, resolve_device


def greedy_densest_subgraph(n: int, src: np.ndarray, dst: np.ndarray,
                            weight: np.ndarray) -> float:
    """Charikar peel: repeatedly remove the min-weighted-degree vertex;
    return the max density w(E(U))/|U| seen (2-approximation, O(n^2 + m);
    the offline solver of Alg 6.14 -- no kernel evals)."""
    deg = np.zeros(n)
    np.add.at(deg, src, weight)
    np.add.at(deg, dst, weight)
    total = float(weight.sum())
    active = np.ones(n, bool)
    best = total / n
    alive = n
    # simple O(n^2 + m) peel: argmin over active degrees each round
    dd = deg.copy()
    incident_by_src = {}
    for e in range(len(src)):
        incident_by_src.setdefault(int(src[e]), []).append(e)
        incident_by_src.setdefault(int(dst[e]), []).append(e)
    edge_alive = np.ones(len(src), bool)
    w_alive = total
    for _ in range(n - 1):
        u = int(np.where(active, dd, np.inf).argmin())
        active[u] = False
        alive -= 1
        for e in incident_by_src.get(u, ()):  # remove incident edges
            if edge_alive[e]:
                edge_alive[e] = False
                w_alive -= float(weight[e])
                other = int(dst[e]) if int(src[e]) == u else int(src[e])
                dd[other] -= float(weight[e])
        if alive > 0:
            best = max(best, w_alive / alive)
    return best


@dataclasses.dataclass
class ArboricityResult:
    """Alg 6.14 output: the greedy density of the sampled graph, the
    sample itself, and the kernel-eval budget spent drawing it."""

    density: float
    graph: SparseGraph
    kernel_evals: int


def estimate_arboricity(x, kernel: Kernel, num_edges: int,
                        estimator: str = "stratified",
                        seed: int = 0, batch: int = 512,
                        mesh=None, device=None) -> ArboricityResult:
    """Algorithm 6.14 / Theorem 6.15 with the weighted edge sampler of
    Section 4.3: all ``num_edges`` draws and their importance weights come
    from one device edge-batch loop (sharded over ``mesh`` when given: one
    all-reduce a batch, DESIGN.md §9).

    Cost (stratified, m = num_edges rounded up to a batch multiple):
    ``n*B*s`` degree preprocessing + ``m*(B*s + bs + 1)`` edge draws.

    >>> res = estimate_arboricity(x, gaussian(1.0), num_edges=8 * len(x))
    """
    n = int(x.shape[0])
    m = int(num_edges)
    nbr = NeighborSampler(x, kernel, mode="blocked", seed=seed + 2,
                          exact_blocks=(estimator in ("exact",
                                                      "exact_block")),
                          mesh=mesh,
                          level1="hash" if estimator == "hash"
                          and mesh is None else "blocked", device=device)
    est = shared_level1_estimator(nbr, estimator, seed=seed)
    deg = DegreeSampler(est, seed=seed + 1,
                        mesh=mesh if est is nbr.blocks else None)
    # edge_batches reweights by k(u,v) / (m (p_u q_uv + p_v q_vu)) -- the
    # Theorem-6.15 estimator X_i = w_e / (p_e m) with the Section 4.3 law.
    u, v, w, _, _ = nbr.edge_batches(deg.cdf_device, deg.degrees_device,
                                     deg.total, m, batch=batch)
    g = SparseGraph(n, np.asarray(u, np.int64), np.asarray(v, np.int64),
                    np.asarray(w, np.float64))
    g.status = nbr.status | est.device_counters.status
    g.degrees = deg.degrees
    dens = greedy_densest_subgraph(n, g.src, g.dst, g.weight)
    evals = nbr.evals + (0 if est is nbr.blocks else est.evals)
    return ArboricityResult(density=dens, graph=g, kernel_evals=evals)


def exact_arboricity(kernel: Kernel, x, device=None) -> float:
    """Oracle: greedy peel on the full kernel graph (n^2 evals on
    ``device``, the peel on the host in float64)."""
    k = kernel.matrix(as_f32(x, resolve_device(device))).cpu().numpy()
    k = k.astype(np.float64)
    n = k.shape[0]
    iu, ju = np.triu_indices(n, 1)
    return greedy_densest_subgraph(n, iu, ju, k[iu, ju])
