"""Plain-torch kernel values of the kde_rowsum kernels (the f32 path and
the bf16 policy of DESIGN.md §14); the plain row and block sums built on
them are in ``kernel.py``."""
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
