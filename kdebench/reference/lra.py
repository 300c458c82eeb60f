"""Plain reference of Algorithm 5.15 (FKV low-rank approximation over
squared-row-norm sampling), laplacian kernel exp(-||x - y||_1 / sigma).

``row_norms`` visits every pair once: ||K_i||^2 = sum_j k_ij^2, diagonal
included.  ``lra_numbers`` holds the program's calls to them:

- ``eig_resid``: the program's factor rows u_k, each normalized, as
  eigenvectors of the reference's sketch Gram A = S^T S, where S is the
  reference's sketch (kernel rows of the program's sampled indices, scaled
  by 1 / sqrt(s p_i) with the reference's probabilities): the largest
  ||A u_k - (u_k^T A u_k) u_k|| over the largest eigenvalue of A.  It reads
  the row norms (as the scales), the sketch rows and the factor at once,
  to first order, and needs no spectral gap;
- ``orth_err``: the largest entry of |U U^T - I|, the factor's rows
  orthonormal;
- ``rows_z``: the sampled indices of the checked calls, pooled, in 20 bins
  of equal reference mass (rows in order of their probability), a
  chi-square z score (the row-norm law).

``control_lra`` is the control: the same algorithm written plainly, every
kernel value from TF32-rounded coordinates, drawing its own rows.
"""
from __future__ import annotations

import numpy as np
import torch

from .precision import chi2_z, round_tf32

ROW_BINS = 20


def l1_kernel(q: torch.Tensor, x: torch.Tensor, inv_bw: float,
              tf32: bool = False) -> torch.Tensor:
    """(m, n) exp(-||q_i - x_j||_1 / sigma), float64: L1 distances in
    float64, or in float32 between TF32-rounded coordinates."""
    if tf32:
        d1 = torch.cdist(round_tf32(q), round_tf32(x), p=1).double()
    else:
        d1 = torch.cdist(q.double(), x.double(), p=1)
    return torch.exp(-d1 * inv_bw)


def row_norms(x: torch.Tensor, inv_bw: float, tf32: bool = False,
              block: int = 512) -> torch.Tensor:
    """||K_i||^2 of every row, diagonal included, float64."""
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.float64, device=x.device)
    with torch.no_grad():
        for lo in range(0, n, block):
            hi = min(lo + block, n)
            k = l1_kernel(x[lo:hi], x, inv_bw, tf32)
            out[lo:hi] = (k * k).sum(1)
            del k
    return out


def sketch(x: torch.Tensor, idx: torch.Tensor, p: torch.Tensor,
           inv_bw: float, tf32: bool = False) -> torch.Tensor:
    """The FKV sketch S: rows K_{idx,*} / sqrt(s p_idx), float64."""
    s = idx.numel()
    scale = 1.0 / torch.sqrt(s * p[idx])
    return l1_kernel(x[idx], x, inv_bw, tf32) * scale[:, None]


def factor(sk: torch.Tensor, rank: int) -> torch.Tensor:
    """The top ``rank`` right singular directions of the sketch, (rank, n):
    the Gram S S^T, its eigenvectors, U = (S^T V / sigma)^T."""
    val, vec = torch.linalg.eigh(sk @ sk.T)
    order = torch.argsort(val, descending=True)[:rank]
    sig = torch.sqrt(torch.clamp(val[order], min=1e-30))
    return (sk.T @ vec[:, order] / sig[None, :]).T


def call_numbers(x, p_ref, idx, u, inv_bw) -> tuple:
    """(eig_resid, orth_err) of one call's sampled ``idx`` and factor
    ``u``."""
    dev = x.device
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=dev)
    u = torch.as_tensor(np.asarray(u, np.float64), device=dev)
    sk = sketch(x, idx, p_ref, inv_bw)
    lam1 = float(torch.linalg.eigvalsh(sk @ sk.T)[-1])
    norms = torch.linalg.vector_norm(u, dim=1)
    uh = u / norms[:, None]
    a = (sk.T @ (sk @ uh.T)).T
    lam = (a * uh).sum(1)
    resid = torch.linalg.vector_norm(a - lam[:, None] * uh, dim=1)
    eye = torch.eye(u.shape[0], dtype=torch.float64, device=dev)
    orth = float((u @ u.T - eye).abs().max())
    return float(resid.max()) / lam1, orth


def rows_z(p_ref: torch.Tensor, idx_all: torch.Tensor) -> float:
    """The pooled indices against the reference law in ROW_BINS bins of
    about equal mass."""
    order = torch.argsort(p_ref)
    before = torch.cumsum(p_ref[order], 0) - p_ref[order]
    bin_sorted = (before * ROW_BINS).long().clamp_(0, ROW_BINS - 1)
    bin_of = torch.empty_like(bin_sorted)
    bin_of[order] = bin_sorted
    mass = torch.zeros(ROW_BINS, dtype=torch.float64, device=p_ref.device)
    mass.index_add_(0, bin_of, p_ref)
    got = torch.bincount(bin_of[idx_all], minlength=ROW_BINS)
    return chi2_z(got, idx_all.numel() * mass / mass.sum())


def lra_numbers(x: torch.Tensor, norms: torch.Tensor, calls: list,
                inv_bw: float) -> dict:
    """The numbers above over ``calls`` (each a dict of numpy
    ``row_indices`` and ``u``): the largest over the calls, the law over
    their pooled indices."""
    p_ref = norms / norms.sum()
    res = dict(eig_resid=0.0, orth_err=0.0)
    with torch.no_grad():
        for c in calls:
            e, o = call_numbers(x, p_ref, c["row_indices"], c["u"], inv_bw)
            res["eig_resid"] = max(res["eig_resid"], e)
            res["orth_err"] = max(res["orth_err"], o)
        idx_all = torch.as_tensor(np.concatenate(
            [np.asarray(c["row_indices"], np.int64) for c in calls]),
            device=x.device)
        res["rows_z"] = rows_z(p_ref, idx_all)
    return res


def control_lra(x: torch.Tensor, inv_bw: float, rank: int, rows: int,
                seed: int, norms_tf32: torch.Tensor | None = None) -> dict:
    """The control: Algorithm 5.15 written plainly with TF32-rounded
    coordinates: row norms, ``rows`` indices drawn by them from ``seed``,
    the sketch and its factor.  Returns a call as ``lra_numbers`` takes
    it."""
    dev = x.device
    norms = row_norms(x, inv_bw, tf32=True) if norms_tf32 is None \
        else norms_tf32
    p = norms / norms.sum()
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    idx = torch.multinomial(p, rows, replacement=True, generator=gen)
    with torch.no_grad():
        u = factor(sketch(x, idx, p, inv_bw, tf32=True), rank)
    return dict(row_indices=idx.cpu().numpy(), u=u.cpu().numpy())
