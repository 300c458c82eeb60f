"""Additive-error low-rank approximation of K -- Algorithm 5.15 / Cor 5.14.

FKV over rows sampled from the squared-row-norm distribution, which
Section 5.2 obtains with n KDE queries against the scaled dataset cX (the
rowsum CUDA kernel on the card).  Post-processing constructs only
O(r/eps) rows explicitly; the sketch's Gram matrix and eigenvectors are
computed in float64 on the sampler's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.sampling.rownorm import RowNormSampler
from repro_torch.device import as_f32, resolve_device
from repro_torch.obs import metrics as _m


@dataclasses.dataclass
class LowRankResult:
    """Algorithm 5.15 output: the factors plus the eval/query budget."""

    u: np.ndarray            # (r, n) right factor, rows ~ orthonormal
    v: Optional[np.ndarray]  # (n, r) left factor (CP17 fit), or None
    kernel_evals: int
    kde_queries: int
    row_indices: np.ndarray

    def approx(self) -> np.ndarray:
        """B = V @ U (requires v)."""
        if self.v is None:
            raise ValueError("no left factor: call fkv_lowrank(fit_cols=)")
        return self.v @ self.u


def fkv_lowrank(x, kernel: Kernel, rank: int, num_rows: Optional[int] = None,
                estimator: str = "exact", seed: int = 0,
                fit_cols: Optional[int] = None, mesh=None,
                device=None) -> LowRankResult:
    """Theorem 5.12 pipeline.  num_rows defaults to 25*rank (the paper's
    experimental setting, Section 7.1).  The call is the ``lowrank`` span;
    the sampler's ``row_norms``, ``row_draws`` and ``sketch_rows`` and the
    factor's ``lowrank.eigh`` are spans inside it."""
    with _m.span("lowrank"):
        n = int(x.shape[0])
        s = int(num_rows if num_rows is not None else 25 * rank)
        sampler = RowNormSampler(x, kernel, estimator=estimator, seed=seed,
                                 mesh=mesh, device=device)
        idx = sampler.sample(s)
        sk = sampler.sketch_rows_device(idx)             # (s, n) float64

        # Top right-singular directions of the sketch.
        with _m.span("lowrank.eigh"):
            w = sk @ sk.T                                # (s, s)
            _m.note_sync()           # eigh reads its solver's status
            eigval, eigvec = torch.linalg.eigh(w)
            order = torch.argsort(eigval, descending=True)[:rank]
            sig = torch.sqrt(torch.clamp(eigval[order], min=1e-30))
            u = (sk.T @ eigvec[:, order] / sig[None, :]).T   # (r, n)
            u = _m.to_host(u).numpy()

        v = None
        if fit_cols:
            v, _ = fit_left_factor(x, kernel, u, num_cols=fit_cols,
                                   seed=seed + 1, sampler=sampler)
        return LowRankResult(u=u, v=v, kernel_evals=sampler.evals,
                             kde_queries=n, row_indices=idx)


def fit_left_factor(x, kernel: Kernel, u: np.ndarray, num_cols: int,
                    seed: int = 0,
                    sampler: Optional[RowNormSampler] = None,
                    device=None) -> Tuple[np.ndarray, int]:
    """Theorem 5.13 (CP17): fit V = argmin ||K - V U||_F reading only
    O(r/eps) columns of K, via uniformly subsampled least squares.  With a
    ``sampler`` the columns are read as device rows on the sampler's
    device (K symmetric) and counted on the sampler (the returned eval
    count is then 0); standalone calls read them with one pairwise sweep
    on ``device`` and return its cost."""
    n = int(x.shape[0])
    rng = np.random.default_rng(seed)
    cols = rng.choice(n, size=min(num_cols, n), replace=False)
    if sampler is not None:
        k_cols = sampler.rows(cols).T                                # (n, c)
        extra = 0
    else:
        dev = resolve_device(device)
        xj = as_f32(x, dev)
        sel = torch.as_tensor(cols).to(dev)
        k_cols = kernel.pairwise(xj, xj[sel]).cpu().numpy()
        extra = n * len(cols)
    u_cols = u[:, cols]                                              # (r, c)
    # V = K_cols U_cols^T (U_cols U_cols^T)^{-1}
    gram = u_cols @ u_cols.T
    rhs = k_cols @ u_cols.T
    return rhs @ np.linalg.pinv(gram), extra


def projection_error(k: np.ndarray, u: np.ndarray) -> float:
    """||K - K U^T U||_F^2 (evaluation oracle)."""
    proj = (k @ u.T) @ u
    return float(np.linalg.norm(k - proj, "fro") ** 2)


def factored_error(k: np.ndarray, v: np.ndarray, u: np.ndarray) -> float:
    """||K - V U||_F^2 (evaluation oracle for the Theorem 5.13 fit)."""
    return float(np.linalg.norm(k - v @ u, "fro") ** 2)


def countsketch_lowrank(k: np.ndarray, rank: int, sketch_size: int,
                        seed: int = 0) -> np.ndarray:
    """Clarkson-Woodruff input-sparsity LRA baseline (needs the
    materialized matrix): U = top-r right singular directions of the
    CountSketch S K, with the reference's numpy draws."""
    n = k.shape[0]
    rng = np.random.default_rng(seed)
    h = rng.integers(0, sketch_size, size=n)
    s = rng.choice([-1.0, 1.0], size=n)
    sk = np.zeros((sketch_size, n))
    np.add.at(sk, h, s[:, None] * k)                 # S K
    _, _, vt = np.linalg.svd(sk, full_matrices=False)
    return vt[:rank]                                 # (r, n)


def subspace_iteration(k: np.ndarray, rank: int, iters: int = 12,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Iterative SVD baseline: block power iteration with QR; returns
    (eigvals ~ (r,), U (r, n))."""
    n = k.shape[0]
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, rank)))
    for _ in range(iters):
        q, _ = np.linalg.qr(k @ q)
    small = q.T @ (k @ q)
    val, vec = np.linalg.eigh(small)
    order = np.argsort(np.abs(val))[::-1]
    return val[order], (q @ vec[:, order]).T


def optimal_error(k: np.ndarray, rank: int) -> float:
    """||K - K_r||_F^2 via full eigendecomposition (oracle)."""
    val = np.sort(np.abs(np.linalg.eigvalsh(k)))[::-1]
    return float(np.sum(val[rank:] ** 2))
