"""Pure-torch oracle for the kde_rowsum kernels: the kernel values (the
f32 path and the bf16 policy of DESIGN.md §14) and the row and block sums
built on them -- the plain versions of the CUDA wrappers in ``kernel.py``
(the torch mirror of ``repro.kernels.kde_rowsum.ref``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.kde_sampler.ref import (_finish_l2, check_precision,
                                                 kv_matrix_bf16, l1_dists)


def kernel_values(q, x, kind: str, inv_bw: float, beta: float = 1.0,
                  precision: str = "f32"):
    """(m, n) kernel values k(q_i, x_j) of the four built-in kinds;
    ``precision="bf16"`` (the three L2 kinds) rounds both operands to
    bf16, recomputes both norms from the rounded values and finishes
    through the bf16 exp table."""
    if precision != "f32":
        check_precision(precision, kind, None)
        return kv_matrix_bf16(q, x, kind, inv_bw, beta)
    if kind == "laplacian":
        return torch.exp(-l1_dists(q, x) * inv_bw)
    if kind not in ("gaussian", "exponential", "rational_quadratic"):
        raise ValueError(kind)
    qq = torch.sum(q * q, dim=1, keepdim=True)
    xx = torch.sum(x * x, dim=1, keepdim=True).T
    return _finish_l2(qq + xx - 2.0 * (q @ x.T), kind, inv_bw, beta)


def rowsum_ref(q, x, kind: str, inv_bw: float, beta: float = 1.0,
               precision: str = "f32"):
    """(m,) row sums sum_j k(q_i, x_j)."""
    return torch.sum(kernel_values(q, x, kind, inv_bw, beta, precision),
                     dim=1)


def blocksum_ref(q, x, kind: str, inv_bw: float, beta: float = 1.0,
                 bn: int = 256, precision: str = "f32"):
    """(m, ceil(n / bn)) sums over blocks of ``bn`` consecutive rows of x.
    The reference needs n a multiple of ``bn``; here a ragged last block
    sums the rows it has (the values zero-padded to a block multiple)."""
    kv = kernel_values(q, x, kind, inv_bw, beta, precision)
    pad = -kv.shape[1] % bn
    if pad:
        kv = torch.nn.functional.pad(kv, (0, pad))
    return kv.reshape(kv.shape[0], -1, bn).sum(-1)
