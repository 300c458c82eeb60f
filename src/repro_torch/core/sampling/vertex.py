"""Weighted vertex (degree) sampling -- Algorithms 4.3, 4.5, 4.6.

Preprocessing: n KDE queries give the weighted degrees p_i.  Sampling from
{p_i} is then the dense inverse-CDF form of the Algorithm 4.5 tree descent
(Lemma 4.8).  ``PrefixCDF`` accumulates prefix sums in float64 on the host
and draws with ``np.random.default_rng(seed)`` exactly as the reference
does, so the same weights and seed give the same indices; the normalized
CDF is exported once as a float32 device tensor for the fused edge-batch
program (per-entry rounding of an exactly-accumulated CDF is unbiased).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.kde.base import KDEBase
from repro_torch.device import not_in_slice, resolve_device


class PrefixCDF:
    """Inverse-CDF sampler over a positive weight array.

    Host path: float64 prefix sums + ``np.searchsorted``.  Device path:
    ``cdf_device`` / ``weights_device`` are float32 tensors on
    ``device``, rounded from the float64 accumulation and exported once.
    """

    def __init__(self, weights: np.ndarray, seed: int = 0, device=None):
        w = np.asarray(weights, np.float64)
        self.weights = w
        self._prefix = np.cumsum(w)           # float64 accumulation
        self.total = float(self._prefix[-1])
        self._rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self._cdf_dev: Optional[torch.Tensor] = None
        self._weights_dev: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return len(self.weights)

    def sample(self, size: int) -> np.ndarray:
        """Draw ``size`` iid indices i ~ w_i / sum w."""
        u = self._rng.uniform(0.0, self.total, size=size)
        return np.searchsorted(self._prefix, u, side="right").clip(
            0, len(self.weights) - 1)

    def prob(self, idx) -> np.ndarray:
        """Probability this sampler assigns to index idx (w_i / sum w)."""
        return self.weights[np.asarray(idx)] / self.total

    def _export(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a.astype(np.float32)).to(self.device)

    @property
    def cdf_device(self) -> torch.Tensor:
        """Normalized float32 prefix array for device inverse-CDF draws."""
        if self._cdf_dev is None:
            self._cdf_dev = self._export(self._prefix / self.total)
        return self._cdf_dev

    @property
    def weights_device(self) -> torch.Tensor:
        """Raw float32 weight array on the device."""
        if self._weights_dev is None:
            self._weights_dev = self._export(self.weights)
        return self._weights_dev


def host_degree_loop(estimator: KDEBase, batch: int = 1024) -> np.ndarray:
    """Algorithm 4.3 as batched estimator queries of the dataset against
    itself, minus the kernel's per-point diagonal (1.0 for the Table-1
    kinds)."""
    from repro_torch.kernels.kde_sampler.ref import BUILTIN_KINDS
    n = estimator.n
    out = np.zeros(n, np.float64)
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        out[lo:hi] = estimator.query(estimator.x[lo:hi]).cpu().numpy()
    if estimator.kernel.name in BUILTIN_KINDS:
        return out - 1.0         # k(x, x) = 1 exactly for Table-1 kernels
    return out - estimator.kernel.pairs(
        estimator.x, estimator.x).cpu().numpy().astype(np.float64)


def approximate_degrees(estimator: KDEBase, batch: int = 1024) -> np.ndarray:
    """Algorithm 4.3: p_i = KDE_X(x_i) - k(x_i, x_i), clamped positive.
    Estimators exposing a ``degrees()`` method (the hashed ``HashedKDE``)
    are dispatched to it instead of the host batch loop, at the
    estimator's own batch size (so its counter words match the
    reference's, whose dispatch passes no batch either)."""
    if hasattr(estimator, "degrees"):
        return np.maximum(np.asarray(estimator.degrees(), np.float64),
                          1e-12)
    return np.maximum(host_degree_loop(estimator, batch), 1e-12)


class DegreeSampler:
    """Algorithm 4.6: sample vertices proportional to (approximate) degree.
    The degree CDF lives on the estimator's device."""

    def __init__(self, estimator: KDEBase, seed: int = 0, mesh=None,
                 dataset=None):
        if mesh is not None:
            raise not_in_slice("DegreeSampler(mesh=)", 10)
        if dataset is not None:
            raise not_in_slice("DegreeSampler(dataset=)", 8)
        self._estimator = estimator
        self.degrees = approximate_degrees(estimator)
        self._cdf = PrefixCDF(self.degrees, seed=seed,
                              device=estimator.device)
        self.total = self._cdf.total

    def sample(self, size: int) -> np.ndarray:
        """Draw ``size`` vertices u ~ deg(u) / sum deg (Algorithm 4.6)."""
        return self._cdf.sample(size)

    def prob(self, idx) -> np.ndarray:
        """Probability this sampler assigns to vertex idx."""
        return self._cdf.prob(idx)

    @property
    def cdf_device(self) -> torch.Tensor:
        """Normalized float32 prefix array for the fused edge-batch op."""
        return self._cdf.cdf_device

    @property
    def degrees_device(self) -> torch.Tensor:
        """Raw float32 degree array for the fused edge-batch op."""
        return self._cdf.weights_device
