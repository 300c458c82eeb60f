"""Laplacian utilities + approximate Laplacian system solver (Section 5.1.1).

Solve L_G x = b by (1) building an eps-sparsifier G' (Theorem 5.3), then
(2) running preconditioned CG on L_{G'} (the stand-in for the fast
KMP11/ST04 solver -- CG on an m-edge graph costs O(m) per iteration and
Theorem 5.11 bounds the sparsifier-induced error by 2 sqrt(eps)
||L^+ b||_L).

The CG loop runs on the device (``kde_sampler.ops.laplacian_cg``): its
``L_{G'} p`` matvec is a pair of scatter-adds over the COO edge list,
uploaded once, and the host reads the convergence flag every few
iterations only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.sparsify import SparseGraph, spectral_sparsify
from repro_torch.device import as_f32, resolve_device
from repro_torch.ft import guards as _g
from repro_torch.kernels.kde_sampler import ops as _ops


def project_ones(v: np.ndarray) -> np.ndarray:
    """Project onto 1^perp (Laplacian range for connected graphs)."""
    return v - v.mean()


def cg_laplacian(g: SparseGraph, b: np.ndarray, iters: int = 200,
                 tol: float = 1e-10, device=None) -> Tuple[np.ndarray, float]:
    """Jacobi-preconditioned CG for L_G' x = b with b perp 1 (the solve
    step of Section 5.1.1) on ``device``: scatter-add matvecs,
    best-iterate tracking for float32 stability.  Costs no kernel evals
    (operates on the materialized sparsifier); O(m) work per iteration.
    Non-finite flags raise under ``REPRO_CHECKS=1``; ``CG_NO_CONVERGE``
    stays advisory because the returned residual already tells callers
    how far the solve got.

    >>> sol, res = cg_laplacian(g, b, iters=300)
    """
    dev = resolve_device(device)
    sol, res, st = _ops.laplacian_cg(
        torch.as_tensor(g.src, dtype=torch.int64).to(dev),
        torch.as_tensor(g.dst, dtype=torch.int64).to(dev),
        as_f32(g.weight, dev), as_f32(np.asarray(b, np.float64), dev), tol,
        n=int(g.n), iters=int(iters))
    _g.raise_on_status(st, context="cg_laplacian",
                       allow=_g.CG_NO_CONVERGE)
    return project_ones(sol.cpu().numpy().astype(np.float64)), float(res)


def solve_kernel_laplacian(x, kernel: Kernel, b: np.ndarray,
                           num_edges: Optional[int] = None,
                           estimator: str = "stratified", seed: int = 0,
                           iters: int = 300, device=None
                           ) -> Tuple[np.ndarray, SparseGraph]:
    """End-to-end Section 5.1.1 / Theorem 5.11: sparsify the kernel graph
    (Algorithm 5.1, ``num_edges`` defaults to 8 n log n), then solve on the
    sparsifier with the device CG.  Cost: the sparsifier's kernel evals
    (see ``spectral_sparsify``); the solve itself adds none.

    >>> sol, g = solve_kernel_laplacian(x, gaussian(1.0), b)
    """
    n = int(x.shape[0])
    if num_edges is None:
        num_edges = int(8 * n * max(np.log(n), 1.0))
    g = spectral_sparsify(x, kernel, num_edges, estimator=estimator, seed=seed,
                          device=device)
    sol, _ = cg_laplacian(g, b, iters=iters, device=device)
    return sol, g


def _dense_kernel(kernel: Kernel, x, device) -> np.ndarray:
    """K with a zero diagonal, computed on ``device`` in f32, as a float64
    host array."""
    k = kernel.matrix(as_f32(x, resolve_device(device))).cpu().numpy()
    k = k.astype(np.float64)
    np.fill_diagonal(k, 0.0)
    return k


def laplacian_dense(kernel: Kernel, x, device=None) -> np.ndarray:
    """Exact dense Laplacian of the kernel graph (oracle for tests;
    n^2 kernel evals)."""
    k = _dense_kernel(kernel, x, device)
    return np.diag(k.sum(1)) - k


def normalized_laplacian_dense(kernel: Kernel, x, device=None) -> np.ndarray:
    """I - D^{-1/2} K_offdiag D^{-1/2} (used by spectrum/clustering
    oracles; n^2 kernel evals)."""
    k = _dense_kernel(kernel, x, device)
    d = np.maximum(k.sum(1), 1e-30)
    dm = 1.0 / np.sqrt(d)
    return np.eye(k.shape[0]) - (dm[:, None] * k) * dm[None, :]
