"""Random walks on the kernel graph -- Algorithm 4.16 / Theorem 4.15.

T steps = T neighbor-sampling calls; total variation error O(T * eps), or
the true walk distribution with the rejection-sampling exactness step.
Walks are vectorized over the frontier, and the whole T-step walk is one
device loop (``NeighborSampler.walk``): the frontier stays on the device
between steps, with one transfer in (starts) and one out (endpoints and
path).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.sampling.edge import NeighborSampler


def random_walks(sampler: NeighborSampler, starts: np.ndarray, length: int,
                 exact: bool = False, record_path: bool = False):
    """Algorithm 4.16: run |starts| = w walks of ``length`` steps.  Returns
    endpoints (and the full (length+1, w) path if requested).

    Cost: ``length`` steps, each one level-1 read (w*B*s stratified / w*n
    exact kernel evals) plus w exact level-2 rows; ``exact=True`` adds the
    Theorem 4.12 rejection rounds per step.

    >>> ends = random_walks(nbr, np.zeros(64, np.int64), length=8)
    """
    starts = np.asarray(starts)
    if length <= 0:
        cur = starts.copy()
        return (cur, starts[None].copy()) if record_path else cur
    end, path = sampler.walk(starts, length, exact=exact,
                             record_path=record_path)
    if record_path:
        return end, np.concatenate([starts[None], path])
    return end


def endpoint_counts(sampler: NeighborSampler, start: int, length: int,
                    num_walks: int, n: int, exact: bool = False) -> np.ndarray:
    """Empirical endpoint distribution p_u^t from ``num_walks`` walks
    (the Theorem 6.9 ingredient; cost = one ``random_walks`` call)."""
    ends = random_walks(sampler, np.full(num_walks, start, np.int64), length,
                        exact=exact)
    return np.bincount(ends, minlength=n).astype(np.float64)
