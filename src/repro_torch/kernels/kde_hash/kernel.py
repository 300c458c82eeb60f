"""Bindings of the weighted gathered kernel-value CUDA kernels
(``csrc/kde_hash.cu``), with their plain PyTorch versions.

``weighted_kv_cuda`` / ``weighted_kv_sum_cuda`` launch the kernels on CUDA
tensors and count each launch in ``LAUNCHES``; ``weighted_kv_plain`` /
``weighted_kv_sum_plain`` compute the same functions with plain torch ops
(``ref.rowwise_kv`` over the gathered rows ``x[cols]``).  All four take the
dataset and the column indices, not gathered rows: the kernels gather
inside, so the (m, t, d) tensor exists only in the plain versions.

``weighted_kv_plan`` is the host-side plan of both kernels (the vector
instance where the rows allow 16-byte gathers, the scalar one elsewhere).
The wrappers validate a call's operands once per (shapes, dtypes,
devices, layout, kernel arguments) and keep the launch's static arguments
as a ``build.KdeWeightedShape``, so a call is one allocation and one
ctypes call of seven arguments.
"""
from __future__ import annotations

from typing import NamedTuple

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


_INT_MAX = 2 ** 31 - 1


class WeightedPlan(NamedTuple):
    instance: int   # 0: scalar; 4 / 8: vector, float4 per row padded to it
    lanes: int      # lanes that read one gathered row (1 on the scalar path)


def weighted_kv_plan(m: int, n: int, d: int, t: int,
                     aligned: bool = True) -> WeightedPlan:
    """The instance an (m, n, d, t) call of either weighted kernel runs:
    the vector instance (4 lanes read a gathered row at d <= 16, 8 at
    d <= 32, a 16-byte piece each) when d % 4 == 0, d <= 32 and x starts
    on 16 bytes (``aligned``), else the scalar one (a lane a row).  Raises ValueError for what the
    kernel does not take: an empty dataset, d below 1, sizes past int32."""
    if n < 1:
        raise ValueError("empty dataset")
    if d < 1:
        raise ValueError(f"width {d} must be >= 1")
    if max(m, n, d, t) > _INT_MAX:
        raise ValueError(f"(m, n, d, t) = ({m}, {n}, {d}, {t}) exceed the "
                         f"kernel's int32 sizes")
    if not (aligned and d % 4 == 0 and d <= 32):
        return WeightedPlan(0, 1)
    return WeightedPlan(4, 4) if d <= 16 else WeightedPlan(8, 8)


#: build.KdeWeightedShape per validated call signature
_PLANS: dict = {}


def _plan(q, x, cols, wgt, kind, inv_bw, beta, aligned):
    """Check a call once; the launch's static arguments."""
    check_operand(q, "q", torch.float32, 2, q.device)
    check_operand(x, "x", torch.float32, 2, q.device)
    m, d = q.shape
    n = x.shape[0]
    if x.shape[1] != d:
        raise ValueError(f"q and x widths differ: {d} vs {x.shape[1]}")
    check_operand(cols, "cols", torch.int32, 2, q.device)
    check_operand(wgt, "wgt", torch.float32, 2, q.device)
    if cols.shape[0] != m or wgt.shape != cols.shape:
        raise ValueError(f"cols {tuple(cols.shape)} and wgt "
                         f"{tuple(wgt.shape)} must both be ({m}, t)")
    t = cols.shape[1]
    plan = weighted_kv_plan(m, n, d, t, aligned)
    return _build.KdeWeightedShape(m, n, d, t, plan.instance,
                                   *kind_args(kind, inv_bw, beta))


def _launch(name: str, q, x, cols, wgt, kind, inv_bw, beta):
    xp = x.data_ptr()
    aligned = xp % 16 == 0
    # (shape, strides) pins contiguity; the checks run once per key
    key = (q.shape, q.stride(), x.shape, x.stride(), cols.shape,
           cols.stride(), wgt.shape, wgt.stride(), q.dtype, x.dtype,
           cols.dtype, wgt.dtype, q.get_device(), x.get_device(),
           cols.get_device(), wgt.get_device(), kind, inv_bw, beta, aligned)
    shape = _PLANS.get(key)
    if shape is None:
        shape = _PLANS[key] = _plan(q, x, cols, wgt, kind, inv_bw, beta,
                                    aligned)
    m = shape.m
    out = torch.empty((m,) if name == "weighted_kv_sum" else (m, shape.t),
                      dtype=torch.float32, device=q.device)
    if m == 0:
        return out
    lib = _build.library()
    fn = lib.kde_weighted_kv_sum_launch if name == "weighted_kv_sum" \
        else lib.kde_weighted_kv_launch
    err = fn(q.data_ptr(), xp, cols.data_ptr(), wgt.data_ptr(),
             out.data_ptr(), stream_of(q), shape)
    if err:
        _build.check(err, f"kde_{name}")
    LAUNCHES[name] += 1
    return out


def weighted_kv_cuda(q, x, cols, wgt, kind: str, inv_bw: float,
                     beta: float = 1.0):
    """out[i, j] = wgt[i, j] k(q_i, x[cols[i, j]]) by the weighted-kv
    kernel: q (m, d), x (n, d), wgt (m, t) f32 and cols (m, t) int32 CUDA
    tensors -> (m, t) f32.  Columns outside [0, n) are clamped."""
    return _launch("weighted_kv", q, x, cols, wgt, kind, inv_bw, beta)


def weighted_kv_sum_cuda(q, x, cols, wgt, kind: str, inv_bw: float,
                         beta: float = 1.0):
    """out[i] = sum_j wgt[i, j] k(q_i, x[cols[i, j]]) by the
    weighted-kv-sum kernel -> (m,) f32, reduced in a fixed order."""
    return _launch("weighted_kv_sum", q, x, cols, wgt, kind, inv_bw, beta)


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
