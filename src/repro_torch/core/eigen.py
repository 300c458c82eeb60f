"""Top eigenvalue/eigenvector approximation -- Algorithm 5.18 / Theorem 5.22.

Step 1 (BMR21, Lemma 5.21): a random t x t principal submatrix K_S, scaled
by n/t, preserves eigenvalues to +- n/sqrt(t); with lambda_1 >= n tau
(Lemma 5.19) choosing t = O(1/(eps^2 tau^2)) keeps a (1 - eps) factor.

Step 2: top eigenvalue of K_S via either the standard gap-independent
power method (MM15, on the host) or the BIMW21 kernel *noisy* power
method, whose matvec is estimated from sampled kernel entries only
(importance-sample indices j ~ |v_j|, read k(x_i, x_j) on the sample --
an unbiased estimate of (K v)_i).  The noisy iteration runs on the device
(``kde_sampler.ops.noisy_power_scan``): the inverse-CDF draw, the
sampled-column matvec and the renormalization never leave it.

The returned eigenvector is sparse: supported only on S.

Cost accounting: the t x t submatrix is materialized ONCE, so
``kernel_evals = t^2`` regardless of iteration count; the per-iteration
sampled matvec touches only materialized entries and is reported
separately as ``matvec_sampled_evals`` (iters * t * num_samples).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.device import as_f32, resolve_device
from repro_torch.ft import guards as _g
from repro_torch.kernels.kde_sampler import ops as _ops
from repro_torch.kernels.kde_sampler.sharded import (mesh_device,
                                                     sharded_noisy_power)


@dataclasses.dataclass
class EigenResult:
    """Algorithm 5.18 output.

    ``kernel_evals`` counts actual kernel evaluations (the one-time t x t
    submatrix materialization); ``matvec_sampled_evals`` counts the
    (i, j) pair lookups of the sampled noisy matvecs, reported separately
    so eval comparisons against dense baselines are not inflated."""

    eigenvalue: float
    eigenvector: np.ndarray      # (n,) sparse: nonzero only on sampled set
    support: np.ndarray
    kernel_evals: int
    matvec_sampled_evals: int = 0


def power_method(ksub: np.ndarray, iters: int, rng) -> Tuple[float, np.ndarray]:
    """Gap-independent power method (MM15) on the materialized submatrix;
    returns (Rayleigh quotient, unit vector).  Costs no kernel evals
    beyond the submatrix the caller already materialized."""
    v = rng.standard_normal(ksub.shape[0])
    v /= np.linalg.norm(v)
    for _ in range(iters):
        w = ksub @ v
        nw = np.linalg.norm(w)
        if nw <= 0:
            break
        v = w / nw
    lam = float(v @ (ksub @ v))
    return lam, v


def noisy_power_method(ksub: torch.Tensor, iters: int, num_samples: int,
                       generator: torch.Generator,
                       mesh=None) -> Tuple[float, np.ndarray, int]:
    """BIMW21 Algorithm 1 (noisy power method) on the submatrix, on its
    device: the start vector and every iteration's uniforms come from
    ``generator`` (on ksub's device), then ``ops.noisy_power_scan``.
    Returns (eigenvalue, vector, matvec_sampled_evals) where the last is
    the sampled-pair lookup count ``iters * t * num_samples`` (not fresh
    kernel evaluations -- the submatrix is already materialized).  With
    ``mesh=`` the submatrix is sharded over columns and each iteration's
    sampled matvec is a local masked gather plus one all-reduce
    (``kde_sampler.sharded.sharded_noisy_power``); the noise and the math
    are the same, and every rank of the mesh calls it.

    >>> lam, v, _ = noisy_power_method(ksub, 12, 32, torch.Generator())
    """
    t = int(ksub.shape[0])
    v0 = torch.randn(t, generator=generator, device=ksub.device,
                     dtype=ksub.dtype)
    v0 = v0 / torch.linalg.norm(v0)
    us = torch.rand((iters, num_samples), generator=generator,
                    device=ksub.device)
    if mesh is not None:
        lam, v, st = sharded_noisy_power(mesh, ksub, v0, us,
                                         num_samples=num_samples)
    else:
        lam, v, st = _ops.noisy_power_scan(ksub, v0, us,
                                           num_samples=num_samples)
    # stalled iterations (ZERO_MASS) keep the previous iterate -- benign;
    # NaN/Inf anywhere in the loop is fatal under REPRO_CHECKS=1
    _g.raise_on_status(st, context="noisy_power_method", allow=_g.ZERO_MASS)
    return (float(lam), v.cpu().numpy().astype(np.float64),
            iters * t * num_samples)


def top_eigenvalue(x, kernel: Kernel, eps: float = 0.25, tau: float = 0.1,
                   t: Optional[int] = None, method: str = "power",
                   seed: int = 0, mesh=None, device=None) -> EigenResult:
    """Algorithm 5.18 / Theorem 5.22: (1 - eps)-approximate top eigenvalue
    of the n x n kernel matrix from a t x t principal submatrix,
    t = O(1/(eps^2 tau^2)) -- cost independent of n.  The support comes
    from ``np.random.default_rng(seed)``, as the reference draws it; the
    noisy method's noise from a generator seeded with ``seed + 1``.

    Cost: ``t^2`` kernel evals (submatrix materialization); with
    ``method="noisy_power"`` additionally ``iters * t * num_samples``
    sampled pair lookups, reported in ``matvec_sampled_evals``.

    With ``mesh=`` (``method="noisy_power"`` only) the noisy power
    iteration runs sharded on the mesh's device.

    >>> res = top_eigenvalue(x, gaussian(1.0), t=180, method="noisy_power")
    """
    if mesh is not None and method != "noisy_power":
        raise ValueError("mesh= shards the noisy power iteration; use "
                         "method='noisy_power' (the plain power method is "
                         "a host post-processing step)")
    dev = (mesh_device(mesh, device) if mesh is not None
           else resolve_device(device))
    n = int(x.shape[0])
    rng = np.random.default_rng(seed)
    t = int(t if t is not None
            else min(n, int(np.ceil(1.0 / (eps * eps * tau * tau)))))
    support = rng.choice(n, size=t, replace=False)
    xs = as_f32(x, dev)[torch.as_tensor(support).to(dev)]
    ksub_dev = kernel.pairwise(xs, xs)
    evals = t * t
    iters = max(int(np.ceil(np.log(max(t, 2) / eps) / np.sqrt(eps))), 8)
    sampled = 0
    if method == "noisy_power":
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        lam, v, sampled = noisy_power_method(
            ksub_dev, iters, num_samples=max(t // 2, 8), generator=gen,
            mesh=mesh)
    else:
        ksub = ksub_dev.cpu().numpy().astype(np.float64)
        lam, v = power_method(ksub, iters, rng)
    vec = np.zeros(n)
    vec[support] = v
    return EigenResult(eigenvalue=float(lam * n / t), eigenvector=vec,
                       support=support, kernel_evals=evals,
                       matvec_sampled_evals=sampled)


def top_eigenvalue_exact(kernel: Kernel, x, device=None) -> float:
    """Oracle: lambda_1(K) by dense eigendecomposition (n^2 evals on
    ``device``, the decomposition in float64 on the host)."""
    k = kernel.matrix(as_f32(x, resolve_device(device))).cpu().numpy()
    return float(np.linalg.eigvalsh(k.astype(np.float64))[-1])
