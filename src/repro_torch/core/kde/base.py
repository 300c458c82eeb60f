"""KDE data structures (Definition 1.1).

A KDE structure over a fixed dataset ``X`` answers queries
``KDE_X(y) ~= sum_{x in X} k(x, y)``.  Ported backends of
``repro.core.kde.base``:

* ``ExactKDE``      -- brute-force row sums: the rowsum CUDA kernel on a
                       CUDA dataset, the plain torch sweep on the CPU.
* ``RSKDE``         -- uniform random sampling, the ``p = 1`` estimator of
                       Section 3.1, reduced by the same rowsum kernel.
* ``StratifiedKDE`` -- per-block uniform subsamples (plain torch on every
                       device, as in the reference); also the block holder
                       of the ``level1="hash"`` neighbor sampler.
* ``ExactBlockKDE`` -- exact per-block sums (the level-1 read of the
                       depth-2 sampler): the blocksum CUDA kernel on a CUDA
                       dataset.
* ``GridHBE``       -- (``hbe.py``) the host-loop hashed estimator of
                       Section 3.1, the oracle of
* ``HashedKDE``     -- (``hashed.py``) the sub-linear hashed estimator of
                       Section 3.1.

``make_estimator("robust")`` wraps them in ``ft.guards.RobustEstimator``'s
staged hash -> stratified -> exact chain (DESIGN.md §11).

All estimators count kernel evaluations (``.evals``) -- the paper's
headline cost metric in Section 7 -- and fold the counter words of the
programs they run into ``device_counters``.

``precision`` (DESIGN.md §14) selects the dtype policy of the level-1
dataset sweeps: ``"f32"`` (the default) or ``"bf16"`` (operands rounded to
bf16, f32 accumulation, the bf16 exp table; the L2 kinds only, checked at
construction).  On the CPU the bf16 ``ExactKDE`` / ``RSKDE`` answers are
``rowsum_plain(precision="bf16")``, the plain version of the bf16 rowsum
kernel, where the reference's CPU path runs ``_bf16_rowsum`` (the block
sums of ``kv_block_sums_bf16``, summed): the same function up to the
order of the sums.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.device import as_f32, no_switch, resolve_device, tile_size
from repro_torch.kernels.kde_sampler.ref import (check_precision,
                                                 static_pairwise)
from repro_torch.obs import counters as _c


class KDEBase:
    """Common interface: query(y: (m, d)) -> (m,) estimated row sums.

    ``device=None`` places the dataset on the CUDA card; tests pass
    ``device="cpu"`` to run the plain versions.
    """

    def __init__(self, x, kernel: Kernel, precision: str = "f32",
                 device=None):
        check_precision(precision, kernel.name, static_pairwise(kernel))
        self.device = resolve_device(device)
        self.x = as_f32(x, self.device)
        # ||x_j||^2, computed once and reused by every L2-kernel read
        self.x_sq = torch.sum(self.x * self.x, dim=-1)
        self.kernel = kernel
        self.n = int(self.x.shape[0])
        self.d = int(self.x.shape[1])
        self.evals = 0  # number of kernel evaluations performed (analytic)
        self.device_counters = _c.HostTotals()
        self.precision = precision

    def query(self, y: torch.Tensor) -> torch.Tensor:
        """(m, d) queries -> (m,) estimated row sums sum_j k(y_i, x_j)."""
        raise NotImplementedError

    def query1(self, y: torch.Tensor) -> float:
        """Single-point convenience wrapper around ``query``."""
        return float(self.query(y[None, :])[0])


class ExactKDE(KDEBase):
    """Brute-force oracle: the rowsum CUDA kernel on the card.

    ``chunk`` is the reference's query chunk: checked to be a positive int
    and otherwise ignored (the kernel's plan sizes its own tiles), so the
    answers are the same whatever its value.  ``use_pallas`` must be None:
    the dataset's device chooses the kernel or its plain version."""

    def __init__(self, x, kernel: Kernel, chunk: int = 8192,
                 use_pallas: bool | None = None, precision: str = "f32",
                 device=None):
        tile_size("chunk", chunk)
        no_switch("use_pallas", use_pallas)
        super().__init__(x, kernel, precision=precision, device=device)

    def query(self, y: torch.Tensor) -> torch.Tensor:
        """Exact row sums; m*n kernel evals per call."""
        from repro_torch.kernels.kde_rowsum import ops as rs_ops
        y = as_f32(y, self.device)
        self.evals += y.shape[0] * self.n
        return rs_ops.kde_rowsum(y, self.x, self.kernel,
                                 precision=self.precision)


class RSKDE(KDEBase):
    """Random-sampling estimator (p = 1): n/|R| * sum_{x in R} k(x, y).

    ``num_samples = O(1/(tau * eps^2))`` per Section 3.1.  Each query draws
    its |R| indices with replacement on the host, from a numpy generator
    seeded by ``seed`` exactly as the reference draws them, and reduces
    through ``kde_rowsum`` (the rowsum CUDA kernel on the card).
    """

    def __init__(self, x, kernel: Kernel, num_samples: int, seed: int = 0,
                 precision: str = "f32", device=None):
        super().__init__(x, kernel, precision=precision, device=device)
        self.num_samples = min(int(num_samples), self.n)
        self._rng = np.random.default_rng(seed)

    def query(self, y: torch.Tensor) -> torch.Tensor:
        """(1 +- eps) row-sum estimates; m*num_samples evals per call."""
        from repro_torch.kernels.kde_rowsum import ops as rs_ops
        y = as_f32(y, self.device)
        idx = self._rng.integers(0, self.n, size=self.num_samples)
        self.evals += y.shape[0] * self.num_samples
        sub = self.x[torch.as_tensor(idx).to(self.device)]
        return rs_ops.kde_rowsum(y, sub, self.kernel,
                                 precision=self.precision) \
            * (self.n / self.num_samples)


class StratifiedKDE(KDEBase):
    """Blocked stratified sampling: per-block uniform subsamples.

    Unbiased: each block contributes |block| * mean(sampled kernel values),
    the tail block scaled by its *realized* sample count.  Variance is the
    within-block variance only.  ``block_sums`` draws its (B, block_size)
    uniforms from a ``torch.Generator`` seeded by ``seed`` and runs one
    device program.
    """

    def __init__(self, x, kernel: Kernel, block_size: int = 256,
                 samples_per_block: int = 16, seed: int = 0,
                 precision: str = "f32", device=None):
        super().__init__(x, kernel, precision=precision, device=device)
        self.block_size = int(block_size)
        self.num_blocks = (self.n + self.block_size - 1) // self.block_size
        self.samples_per_block = min(int(samples_per_block), self.block_size)
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def _static_cfg(self) -> dict:
        return dict(kind=self.kernel.name, inv_bw=1.0 / self.kernel.bandwidth,
                    beta=getattr(self.kernel, "beta", 1.0),
                    pairwise=static_pairwise(self.kernel),
                    block_size=self.block_size, num_blocks=self.num_blocks,
                    n=self.n, precision=self.precision)

    def block_sums(self, y: torch.Tensor) -> torch.Tensor:
        """(m, B) estimated per-block kernel sums; m*B*s evals per call."""
        from repro_torch.kernels.kde_sampler import ops as sampler_ops
        y = as_f32(y, self.device)
        self.evals += y.shape[0] * self.num_blocks * self.samples_per_block
        u = torch.rand((self.num_blocks, self.block_size),
                       generator=self._gen, device=self.device)
        bs, cw = sampler_ops.stratified_block_sums(
            y, self.x, self.x_sq, u, s=self.samples_per_block,
            **self._static_cfg())
        self.device_counters.note(cw)
        return bs

    def query(self, y: torch.Tensor) -> torch.Tensor:
        """Stratified row-sum estimates; m*B*s evals per call."""
        return torch.sum(self.block_sums(y), dim=-1)


class ExactBlockKDE(KDEBase):
    """Exact per-block sums (one sweep); deterministic ``block_sums``.

    Used where the sparsifier needs *reproducible* sampling probabilities
    (Algorithm 5.1 computes the probability q_uv with which the sampler
    picks an edge; a deterministic level-1 read makes q exactly
    recomputable).  On a CUDA dataset the sweep is the blocksum kernel.
    ``use_pallas`` must be None (the dataset's device chooses).
    """

    def __init__(self, x, kernel: Kernel, block_size: int = 256,
                 use_pallas: bool | None = None, precision: str = "f32",
                 device=None):
        no_switch("use_pallas", use_pallas)
        super().__init__(x, kernel, precision=precision, device=device)
        self.block_size = int(block_size)
        self.num_blocks = (self.n + self.block_size - 1) // self.block_size
        # every row of a block is read, as the reference's subclass of
        # StratifiedKDE records it
        self.samples_per_block = self.block_size

    def _static_cfg(self) -> dict:
        return dict(kind=self.kernel.name, inv_bw=1.0 / self.kernel.bandwidth,
                    beta=getattr(self.kernel, "beta", 1.0),
                    block_size=self.block_size, num_blocks=self.num_blocks,
                    n=self.n, precision=self.precision)

    def block_sums(self, y: torch.Tensor) -> torch.Tensor:
        """Exact (m, B) per-block sums; m*n evals per call."""
        from repro_torch.kernels.kde_sampler import ops as sampler_ops
        y = as_f32(y, self.device)
        self.evals += y.shape[0] * self.n
        bs, cw = sampler_ops.exact_block_sums(y, self.x, self.x_sq,
                                              **self._static_cfg())
        self.device_counters.note(cw)
        return bs

    def query(self, y: torch.Tensor) -> torch.Tensor:
        """Exact row sums through the block sums; m*n evals per call."""
        return torch.sum(self.block_sums(y), dim=-1)


def make_estimator(name: str, x, kernel: Kernel, seed: int = 0,
                   tau: float = 0.05, eps: float = 0.5, **kw) -> KDEBase:
    """Factory over the estimators (``exact``, ``rs``, ``stratified``,
    ``exact_block``, ``grid_hbe``, ``hash``, ``robust``).  The ``rs``
    budget defaults to ceil(1/(tau eps^2)); ``device=`` and ``precision=``
    are forwarded through ``kw``."""
    if name == "exact":
        return ExactKDE(x, kernel, **kw)
    if name == "rs":
        ns = kw.pop("num_samples", int(np.ceil(1.0 / (tau * eps * eps))))
        return RSKDE(x, kernel, num_samples=ns, seed=seed, **kw)
    if name == "stratified":
        return StratifiedKDE(x, kernel, seed=seed, **kw)
    if name == "exact_block":
        return ExactBlockKDE(x, kernel, **kw)
    if name == "grid_hbe":
        from repro_torch.core.kde.hbe import GridHBE
        return GridHBE(x, kernel, seed=seed, **kw)
    if name == "hash":
        from repro_torch.core.kde.hashed import HashedKDE
        return HashedKDE(x, kernel, seed=seed, **kw)
    if name == "robust":
        from repro_torch.ft.guards import RobustEstimator
        return RobustEstimator(x, kernel, seed=seed, **kw)
    raise ValueError(f"unknown estimator {name!r}")
