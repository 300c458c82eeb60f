"""Kernel functions (Table 1 of the paper) and their algebraic properties.

Every kernel maps to [0, 1] with k(x, x) = 1.  The low-rank reduction
(Section 5.2) needs the *squaring constant* ``c`` with
``k(x, y)^2 == k(c*x, c*y)``: 2 for the laplacian and exponential kernels,
sqrt(2) for the gaussian (see ``repro.core.kernels_fn`` for the
derivation); the rational quadratic kernel has none.

``pairwise`` closures work on torch tensors of any device; the built-in
kinds are evaluated by name on the hot paths (``kernels/kde_sampler/
ref.py`` and the CUDA kernels), so the closures serve evaluation and the
custom-kernel fallback only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.kernels.kde_sampler.ref import BUILTIN_KINDS, kv_pairs, \
    l1_dists


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A kernel function with the metadata the paper's reductions need."""

    name: str
    # pairwise(x: (m, d), y: (n, d)) -> (m, n) kernel matrix block
    pairwise: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    # Constant c with k(x,y)^2 = k(cx, cy); None if no such constant exists.
    squaring_constant: Optional[float]
    # Exponent p of tau in the state-of-the-art KDE query time (Table 1).
    kde_exponent: float
    bandwidth: float = 1.0
    # Shape parameter (rational quadratic only); 1.0 elsewhere.
    beta: float = 1.0

    def matrix(self, x: torch.Tensor) -> torch.Tensor:
        """Full kernel matrix K (for oracles / evaluation only)."""
        return self.pairwise(x, x)

    def pairs(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Elementwise k(x_i, y_i) for aligned (w, d) batches -- O(w d)."""
        if self.name in BUILTIN_KINDS:
            return kv_pairs(x, y, self.name, 1.0 / self.bandwidth, self.beta)
        return torch.stack([self.pairwise(a[None, :], b[None, :])[0, 0]
                            for a, b in zip(x, y)])

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.pairwise(x, y)


def _sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # ||x - y||^2 = ||x||^2 + ||y||^2 - 2 x.y ; clamp for numerical safety.
    xx = torch.sum(x * x, dim=-1)[:, None]
    yy = torch.sum(y * y, dim=-1)[None, :]
    return torch.clamp(xx + yy - 2.0 * (x @ y.T), min=0.0)


def gaussian(bandwidth: float = 1.0) -> Kernel:
    """exp(-||x-y||_2^2 / sigma^2) (Table 1; squaring constant sqrt(2))."""
    inv = 1.0 / (bandwidth * bandwidth)

    def pw(x, y):
        return torch.exp(-_sq_dists(x, y) * inv)

    return Kernel("gaussian", pw, squaring_constant=math.sqrt(2.0),
                  kde_exponent=0.173, bandwidth=bandwidth)


def exponential(bandwidth: float = 1.0) -> Kernel:
    """exp(-||x-y||_2 / sigma) (Table 1; squaring constant 2)."""
    inv = 1.0 / bandwidth

    def pw(x, y):
        return torch.exp(-torch.sqrt(_sq_dists(x, y)) * inv)

    return Kernel("exponential", pw, squaring_constant=2.0,
                  kde_exponent=0.1, bandwidth=bandwidth)


def laplacian(bandwidth: float = 1.0) -> Kernel:
    """exp(-||x-y||_1 / sigma): the kernel used in the paper's experiments."""
    inv = 1.0 / bandwidth

    def pw(x, y):
        return torch.exp(-l1_dists(x, y) * inv)

    return Kernel("laplacian", pw, squaring_constant=2.0,
                  kde_exponent=0.5, bandwidth=bandwidth)


def rational_quadratic(beta: float = 1.0, bandwidth: float = 1.0) -> Kernel:
    """(1 + ||x-y||_2^2/sigma^2)^(-beta) (Table 1; no squaring constant,
    so the Section 5.2 low-rank reduction does not apply to it)."""
    inv = 1.0 / (bandwidth * bandwidth)

    def pw(x, y):
        return (1.0 + _sq_dists(x, y) * inv) ** (-beta)

    return Kernel("rational_quadratic", pw, squaring_constant=None,
                  kde_exponent=0.0, bandwidth=bandwidth, beta=beta)


_REGISTRY = {
    "gaussian": gaussian,
    "exponential": exponential,
    "laplacian": laplacian,
    "rational_quadratic": rational_quadratic,
}


def make_kernel(name: str, bandwidth: float = 1.0, **kw) -> Kernel:
    """Factory over the Table-1 kernels by name.

    >>> ker = make_kernel("laplacian", bandwidth=2.0)
    """
    return _REGISTRY[name](bandwidth=bandwidth, **kw)


def squared_kernel_dataset(kernel: Kernel, x: torch.Tensor) -> torch.Tensor:
    """Transform dataset X -> cX so that row sums of K' give ||K_i,*||_2^2
    (Section 5.2: k(x,y)^2 = k(cx, cy))."""
    c = kernel.squaring_constant
    if c is None:
        raise ValueError(f"kernel {kernel.name} admits no squaring constant")
    return x * c


def median_bandwidth(x: torch.Tensor, ord: int = 2, sample: int = 2048,
                     seed: int = 0) -> float:
    """The 'median rule' (Section 3.1): bandwidth = median pairwise
    distance over a subsample drawn with a seeded torch generator (the
    reference draws it with ``jax.random``, so the two pick different
    subsamples above ``sample`` points; tests pass explicit bandwidths)."""
    n = x.shape[0]
    if n > sample:
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        idx = torch.randperm(n, generator=gen)[:sample].to(x.device)
        x = x[idx]
    if ord == 2:
        d = torch.sqrt(_sq_dists(x, x))
    else:
        d = l1_dists(x, x)
    iu = torch.triu_indices(x.shape[0], x.shape[0], offset=1,
                            device=x.device)
    off = d[iu[0], iu[1]]
    # jnp.median averages the two middle values; torch.median takes the
    # lower one, so sort and average explicitly
    s = torch.sort(off).values
    k = s.numel()
    return float((s[(k - 1) // 2] + s[k // 2]) / 2.0)
