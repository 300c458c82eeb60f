"""Local clustering -- Algorithm 6.1 / Theorem 6.9.

Same-cluster test for vertices (u, w) of a (k, phi_in, phi_out)-clusterable
kernel graph: compare the endpoint distributions of length-t random walks
with the CDVV14 l2 distribution tester.  Same cluster => ||p_u - p_w||_2^2
<= 1/(8n) (Lemma 6.7); different clusters => >= 2/n (Lemma 6.8).  The
unbiased collision statistic is thresholded at 1/n.

Both endpoints' Poissonized walk ensembles run as one device walk, and the
collision part of the statistic -- sum_i (X_i - Y_i)^2 over endpoint
counts -- is one scatter-add on the device (``ops.signed_endpoint_stat``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sampling.edge import NeighborSampler
from repro_torch.kernels.kde_sampler import ops as _ops


def l2_distance_statistic(counts_p: np.ndarray, counts_q: np.ndarray,
                          r_p: int, r_q: int) -> float:
    """Unbiased ||p - q||_2^2 estimator from Poissonized sample counts
    (CDVV14): E[(X_i - Y_i)^2 - X_i - Y_i] = r^2 (p_i - q_i)^2 for
    X_i ~ Poi(r p_i), Y_i ~ Poi(r q_i) with equal rates r."""
    r = float((r_p + r_q) / 2)
    z = np.sum((counts_p - counts_q) ** 2 - counts_p - counts_q)
    return float(z / (r * r))


@dataclasses.dataclass
class LocalClusterResult:
    """Algorithm 6.1 output: the thresholded CDVV14 decision plus the raw
    statistic, the walk budget spent, and the kernel-eval cost."""

    same_cluster: bool
    statistic: float
    threshold: float
    num_walks: int
    walk_length: int
    kernel_evals: int


def same_cluster_test(x, kernel, u: int, w: int, walk_length: int,
                      num_walks: int, seed: int = 0,
                      sampler: NeighborSampler | None = None,
                      threshold: float | None = None,
                      mesh=None, device=None) -> LocalClusterResult:
    """Algorithm 6.1 / Theorem 6.9: decide whether u and w share a cluster
    with num_walks ~ O(sqrt(n k / eps) log(1/eps)) walks of length t per
    endpoint.  Both endpoints' walks are one device walk and the collision
    statistic is computed on the device.  The Poissonized walk counts come
    from ``np.random.default_rng(seed)``, as the reference draws them.

    Cost: (r_u + r_w) * walk_length walk steps; per step one level-1 read
    (w*n exact / w*B*s stratified) plus w exact level-2 rows.  With
    ``mesh=`` the walks run on the sharded engine (one all-reduce a step).

    >>> res = same_cluster_test(x, gaussian(1.0), 0, 5, walk_length=6,
    ...                         num_walks=400)
    """
    n = int(x.shape[0])
    rng = np.random.default_rng(seed)
    if sampler is None:
        sampler = NeighborSampler(x, kernel, mode="blocked", seed=seed,
                                  exact_blocks=True, mesh=mesh,
                                  device=device)
    # Poissonize the sample sizes so the collision statistic is unbiased.
    r_u = max(int(rng.poisson(num_walks)), 1)
    r_w = max(int(rng.poisson(num_walks)), 1)
    starts = np.concatenate([np.full(r_u, u, np.int64),
                             np.full(r_w, w, np.int64)])
    ends, _ = sampler.walk(starts, walk_length)
    dev = sampler.device
    signs = torch.cat([torch.ones(r_u, device=dev),
                       -torch.ones(r_w, device=dev)])
    sq_dev, cw = _ops.signed_endpoint_stat(
        torch.as_tensor(ends, dtype=torch.int64).to(dev), signs, n=n)
    sampler._note(cw, "same_cluster_test")
    # CDVV14: z = sum (X_i - Y_i)^2 - X_i - Y_i; sum X_i = r_u etc.
    stat = (float(sq_dev) - r_u - r_w) / float(num_walks) ** 2
    thr = threshold if threshold is not None else 1.0 / n
    return LocalClusterResult(same_cluster=bool(stat <= thr), statistic=stat,
                              threshold=thr, num_walks=num_walks,
                              walk_length=walk_length,
                              kernel_evals=sampler.evals)
