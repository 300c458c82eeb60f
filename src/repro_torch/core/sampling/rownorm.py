"""Row-norm^2 (length-squared) sampling of the kernel matrix -- Section 5.2.

For kernels with k(x,y)^2 = k(cx, cy) the squared row norms of K are the
row sums of the kernel matrix of the *scaled* dataset cX, so n KDE queries
against cX give the FKV sampling distribution: exact (the rowsum CUDA
kernel on the card) or by any estimator ``make_estimator`` builds -- ``rs``
(a uniform subsample a query, reduced by the same rowsum kernel, the
paper's sub-linear setting), ``stratified``, ``exact_block`` or ``hash``.
Prefix sums accumulate in float64 through the shared ``PrefixCDF``; the
sketch rows ``K_{idx,*} / sqrt(s p_i)`` are one device program
(``kde_sampler.ops.kernel_rows``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kde.base import KDEBase, make_estimator
from repro_torch.core.kernels_fn import Kernel, squared_kernel_dataset
from repro_torch.core.sampling.vertex import PrefixCDF
from repro_torch.device import as_f32, not_in_slice, resolve_device


class RowNormSampler:
    """Section 5.2: sample row indices i ~ ||K_i,*||_2^2 / ||K||_F^2 via n
    KDE queries (by ``estimator``) against the scaled dataset cX.  Cost: n
    KDE queries of preprocessing + ``len(idx) * n`` evals per ``rows``
    call.

    >>> s = RowNormSampler(x, laplacian(1.0)); idx = s.sample(150)
    """

    def __init__(self, x, kernel: Kernel, estimator: str = "exact",
                 seed: int = 0, mesh=None, data_axes=("data",),
                 dataset=None, device=None, **est_kw):
        if tuple(data_axes) != ("data",):
            raise not_in_slice(f"RowNormSampler(data_axes={data_axes!r})", 10)
        if mesh is not None:
            raise not_in_slice("RowNormSampler(mesh=)", 10)
        if dataset is not None:
            raise not_in_slice("RowNormSampler(dataset=)", 8)
        self.device = resolve_device(device)
        self.x = as_f32(x, self.device)        # shared device dataset
        self.x_sq = torch.sum(self.x * self.x, dim=-1)
        self.kernel = kernel
        xs = squared_kernel_dataset(kernel, self.x)
        self._est: KDEBase = make_estimator(estimator, xs, kernel, seed=seed,
                                            device=self.device, **est_kw)
        self.n = int(xs.shape[0])
        self.row_norms_sq = self._init_probs(xs)
        self._cdf = PrefixCDF(self.row_norms_sq, seed=seed,
                              device=self.device)
        self.total = self._cdf.total          # ~= ||K||_F^2
        self._row_evals = 0
        self._row_cfg = dict(kind=kernel.name, inv_bw=1.0 / kernel.bandwidth,
                             beta=getattr(kernel, "beta", 1.0))

    def _init_probs(self, xs: torch.Tensor) -> np.ndarray:
        """n KDE queries against cX -> squared row norms, diagonal
        included (k(x,x)^2 = 1); no self-subtraction."""
        probs = np.zeros(self.n, np.float64)
        batch = 1024
        for lo in range(0, self.n, batch):
            hi = min(lo + batch, self.n)
            probs[lo:hi] = self._est.query(xs[lo:hi]).cpu().numpy()
        return np.maximum(probs, 1e-12)

    @property
    def evals(self) -> int:
        """Kernel evaluations spent on preprocessing + row reads."""
        return self._est.evals + self._row_evals

    def sample(self, size: int) -> np.ndarray:
        """Draw ``size`` iid row indices i ~ ||K_i,*||^2 (Section 5.2)."""
        return self._cdf.sample(size)

    def prob(self, idx) -> np.ndarray:
        """Probability this sampler assigns to row idx."""
        return self._cdf.prob(idx)

    def rows_device(self, idx: np.ndarray) -> torch.Tensor:
        """Exact kernel rows K_{idx,*} as one device program (f32 tensor
        on the sampler's device)."""
        from repro_torch.kernels.kde_sampler import ops as sampler_ops
        sel = torch.as_tensor(np.asarray(idx, np.int64)).to(self.device)
        self._row_evals += len(idx) * self.n
        out, cw = sampler_ops.kernel_rows(self.x[sel], self.x, self.x_sq,
                                          **self._row_cfg)
        self._est.device_counters.note(cw)
        return out

    def rows(self, idx: np.ndarray) -> np.ndarray:
        """Exact kernel rows K_{idx,*} as a numpy array."""
        return self.rows_device(idx).cpu().numpy()

    def sketch_rows_device(self, idx: np.ndarray) -> torch.Tensor:
        """The FKV sketch S as a float64 device tensor: rows K_{idx,*}
        rescaled by 1/sqrt(s p_i)."""
        scale = 1.0 / np.sqrt(np.maximum(len(idx) * self.prob(idx), 1e-30))
        scale = torch.as_tensor(scale, dtype=torch.float64).to(self.device)
        return self.rows_device(idx).double() * scale[:, None]

    def sketch_rows(self, idx: np.ndarray) -> np.ndarray:
        """The FKV sketch S: rows K_{idx,*} rescaled by 1/sqrt(s p_i)."""
        return self.sketch_rows_device(idx).cpu().numpy()
