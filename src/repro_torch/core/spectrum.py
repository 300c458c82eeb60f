"""Spectrum approximation in EMD -- Theorem 5.17 (CKSV18 on kernel graphs).

ApproxSpectralMoment: sample uniform vertices, run random walks of length
<= L from each, and record the empirical return probabilities
p^l_{uu} ~ E_u[(M^l)_{uu}] = tr(M^l)/n = sum_i mu_i^l / n, where
M = D^{-1} A is the walk matrix and mu_i = 1 - lambda_i are the eigenvalues
of M <-> normalized-Laplacian eigenvalues lambda_i.

Moment inversion: fit a distribution q on a grid over [-1, 1] with simplex-
projected least squares against the estimated moments, then read the
eigenvalue vector off the quantiles of q (host numpy).  EMD between
spectra (Def 5.16) in 1D is the L1 distance of sorted values / n.

The number of walks/length is independent of n.  The walks are the
Section 4.4 primitive, one device walk for all sources.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.laplacian import normalized_laplacian_dense
from repro_torch.core.sampling.edge import NeighborSampler


@dataclasses.dataclass
class SpectrumResult:
    """Theorem 5.17 output: the EMD-approximated spectrum, the walk-return
    moments it was inverted from, and the kernel-eval budget."""

    eigenvalues: np.ndarray      # (n,) approximated normalized-Laplacian spectrum
    moments: np.ndarray          # estimated walk-return moments
    kernel_evals: int


def estimate_return_moments(sampler: NeighborSampler, n: int, length: int,
                            num_sources: int, walks_per_source: int,
                            seed: int = 0) -> np.ndarray:
    """m_l = E_u[p^l_{uu}] for l = 1..length (m_0 = 1 implicitly).

    ALL sources' walk ensembles run as one device walk with
    ``record_path=True``; the (length, S*w) path comes back in one
    transfer and the return-hit averages are read off it.  Cost:
    S*w*length walk steps (one level-1 read + w level-2 rows each)."""
    rng = np.random.default_rng(seed)
    sources = rng.integers(0, n, size=num_sources)
    starts = np.repeat(sources, walks_per_source)
    _, path = sampler.walk(starts, length, record_path=True)
    return (path == starts[None, :]).mean(axis=1)


def invert_moments(moments: np.ndarray, n: int, grid: int = 201,
                   iters: int = 4000, lr: float = 0.5) -> np.ndarray:
    """Simplex-projected least squares: find q >= 0, sum q = 1 on a mu-grid
    matching the moments; return the n sorted eigenvalues 1 - mu."""
    ls = np.arange(1, len(moments) + 1)
    mu = np.linspace(-1.0, 1.0, grid)
    vand = mu[None, :] ** ls[:, None]              # (L, G)
    # include the 0th moment (= 1) as a constraint row for scale stability
    v = np.concatenate([np.ones((1, grid)), vand], axis=0)
    m = np.concatenate([[1.0], moments])
    q = np.full(grid, 1.0 / grid)
    step = lr / (np.linalg.norm(v, 2) ** 2 + 1e-12)
    for _ in range(iters):
        grad = v.T @ (v @ q - m)
        q = _project_simplex(q - step * grad)
    # quantile read-out -> n eigenvalues
    cdf = np.cumsum(q)
    targets = (np.arange(n) + 0.5) / n
    pos = np.searchsorted(cdf, targets).clip(0, grid - 1)
    lams = 1.0 - mu[pos]
    return np.sort(lams)


def _project_simplex(v: np.ndarray) -> np.ndarray:
    u = np.sort(v)[::-1]
    css = np.cumsum(u)
    rho = np.nonzero(u * np.arange(1, len(v) + 1) > (css - 1.0))[0]
    rho = rho[-1] if len(rho) else 0
    theta = (css[rho] - 1.0) / (rho + 1.0)
    return np.maximum(v - theta, 0.0)


def approximate_spectrum(x, kernel: Kernel, length: int = 10,
                         num_sources: int = 32, walks_per_source: int = 64,
                         seed: int = 0,
                         sampler: Optional[NeighborSampler] = None,
                         mesh=None, device=None) -> SpectrumResult:
    """Theorem 5.17 (ApproxSpectralMoment): the normalized-Laplacian
    spectrum in EMD from walk-return moments -- walk budget independent of
    n.  Cost: ``num_sources * walks_per_source * length`` walk steps (each
    one level-1 read plus exact level-2 rows); with ``mesh=`` the walks run
    on the sharded engine, one all-reduce a step.

    >>> sp = approximate_spectrum(x, gaussian(1.0), length=8)
    """
    n = int(x.shape[0])
    if sampler is None:
        sampler = NeighborSampler(x, kernel, mode="blocked", seed=seed,
                                  exact_blocks=True, mesh=mesh,
                                  device=device)
    moments = estimate_return_moments(sampler, n, length, num_sources,
                                      walks_per_source, seed=seed + 1)
    lams = invert_moments(moments, n)
    return SpectrumResult(eigenvalues=lams, moments=moments,
                          kernel_evals=sampler.evals)


def exact_spectrum(kernel: Kernel, x, device=None) -> np.ndarray:
    """Oracle: eigenvalues of the normalized Laplacian, ascending."""
    nl = normalized_laplacian_dense(kernel, x, device=device)
    return np.sort(np.linalg.eigvalsh(nl))


def emd_1d(a: np.ndarray, b: np.ndarray) -> float:
    """Definition 5.16 for scalar multisets: EMD = mean |sorted a - sorted b|
    (the per-point matching cost, matching the Thm 5.17 normalization)."""
    return float(np.mean(np.abs(np.sort(a) - np.sort(b))))
