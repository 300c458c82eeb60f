"""Bindings of the weighted gathered kernel-value CUDA kernels
(``csrc/kde_hash.cu``), with their plain PyTorch versions.

``weighted_kv_cuda`` / ``weighted_kv_sum_cuda`` launch the kernels on CUDA
tensors and count each launch in ``LAUNCHES``; ``weighted_kv_plain`` /
``weighted_kv_sum_plain`` compute the same functions with plain torch ops
(``ref.rowwise_kv`` over the gathered rows ``x[cols]``).  All four take the
dataset and the column indices, not gathered rows: the kernels gather
inside, so the (m, t, d) tensor exists only in the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.kde_hash.ref import weighted_kv_ref
from repro_torch.kernels.kde_rowsum.kernel import (check_operand, kind_args,
                                                   stream_of)

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES = {"weighted_kv_sum": 0, "weighted_kv": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(name: str, out_shape, q, x, cols, wgt, kind, inv_bw, beta):
    check_operand(q, "q", torch.float32, 2, q.device)
    check_operand(x, "x", torch.float32, 2, q.device)
    m, d = q.shape
    n = x.shape[0]
    if x.shape[1] != d:
        raise ValueError(f"q and x widths differ: {d} vs {x.shape[1]}")
    if n == 0:
        raise ValueError("empty dataset")
    check_operand(cols, "cols", torch.int32, 2, q.device)
    check_operand(wgt, "wgt", torch.float32, 2, q.device)
    if cols.shape[0] != m or wgt.shape != cols.shape:
        raise ValueError(f"cols {tuple(cols.shape)} and wgt "
                         f"{tuple(wgt.shape)} must both be ({m}, t)")
    t = cols.shape[1]
    out = torch.empty(out_shape(m, t), dtype=torch.float32, device=q.device)
    if m == 0:
        return out
    vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0)
    fn_name = f"kde_{name}_launch"
    err = getattr(_build.library(), fn_name)(
        q.data_ptr(), x.data_ptr(), cols.data_ptr(), wgt.data_ptr(),
        out.data_ptr(), m, n, d, t, vec4, *kind_args(kind, inv_bw, beta),
        stream_of(q))
    _build.check(err, fn_name)
    LAUNCHES[name] += 1
    return out


def weighted_kv_cuda(q, x, cols, wgt, kind: str, inv_bw: float,
                     beta: float = 1.0):
    """out[i, j] = wgt[i, j] k(q_i, x[cols[i, j]]) by the weighted-kv
    kernel: q (m, d), x (n, d), wgt (m, t) f32 and cols (m, t) int32 CUDA
    tensors -> (m, t) f32.  Columns outside [0, n) are clamped."""
    return _launch("weighted_kv", lambda m, t: (m, t), q, x, cols, wgt, kind,
                   inv_bw, beta)


def weighted_kv_sum_cuda(q, x, cols, wgt, kind: str, inv_bw: float,
                         beta: float = 1.0):
    """out[i] = sum_j wgt[i, j] k(q_i, x[cols[i, j]]) by the
    weighted-kv-sum kernel -> (m,) f32, reduced in a fixed order."""
    return _launch("weighted_kv_sum", lambda m, t: (m,), q, x, cols, wgt,
                   kind, inv_bw, beta)


def weighted_kv_plain(q, x, cols, wgt, kind: str, inv_bw: float,
                      beta: float = 1.0, pairwise=None):
    """Plain torch version of ``weighted_kv_cuda`` (also takes the custom
    kinds' ``pairwise`` callable)."""
    return weighted_kv_ref(q, x, cols, wgt, kind, inv_bw, beta, pairwise)


def weighted_kv_sum_plain(q, x, cols, wgt, kind: str, inv_bw: float,
                          beta: float = 1.0, pairwise=None):
    """Plain torch version of ``weighted_kv_sum_cuda``."""
    return torch.sum(weighted_kv_plain(q, x, cols, wgt, kind, inv_bw, beta,
                                       pairwise), dim=1)
