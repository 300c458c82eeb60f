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
ctypes call of eight arguments.  ``precision="bf16"`` launches the bf16
instances (``kde_rowsum.kernel``'s kind ids and exp table), counted under
``<name>_bf16``.  At ``precision="bf16"`` x may be the dataset's
bf16-resident copy (``round_bf16(x).to(torch.bfloat16)``, made once per
dataset by the hashed estimator): the plan then takes the instances that
gather bf16 rows, half the bytes, with outputs bitwise those of the f32 x.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.kde_hash.ref import weighted_kv_ref
from repro_torch.kernels.kde_rowsum.kernel import (check_operand,
                                                   exp_table_ptr, kind_args,
                                                   launch_key, stream_of)

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES = {"weighted_kv_sum": 0, "weighted_kv": 0,
            "weighted_kv_sum_bf16": 0, "weighted_kv_bf16": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_INT_MAX = 2 ** 31 - 1


#: ``KdeWeightedShape::instance`` flag of the instances on a bf16 x
BF16_ROWS = 16
#: the dtypes x may have
X_DTYPES = (torch.float32, torch.bfloat16)


class WeightedPlan(NamedTuple):
    instance: int   # 0: scalar; 4 / 8: vector, float4 per row padded to it;
    #                 + BF16_ROWS: the same gathering bf16 rows
    lanes: int      # lanes that read one gathered row (1 on the scalar path)


def check_rows(x_dtype: torch.dtype, precision: str) -> None:
    """Refuse an x the weighted kernels do not take: a dtype other than f32
    or bf16, and a bf16 x at ``precision="f32"`` (its rows are rounded)."""
    if x_dtype not in X_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x_dtype}")
    if x_dtype == torch.bfloat16 and precision == "f32":
        raise ValueError("a bfloat16 x needs precision='bf16': its rows "
                         "are already rounded")


def weighted_kv_plan(m: int, n: int, d: int, t: int,
                     aligned: bool = True, x_dtype=torch.float32,
                     precision: str = "f32") -> WeightedPlan:
    """The instance an (m, n, d, t) call of either weighted kernel runs:
    the vector instance (4 lanes read a gathered row at d <= 16, 8 at
    d <= 32, 4 coordinates each) when d % 4 == 0, d <= 32 and x starts on
    16 bytes (8 for a bf16 x; ``aligned``), else the scalar one (a lane a
    row); + ``BF16_ROWS`` for a bf16 x (``x_dtype``).  Raises ValueError
    for what the kernel does not take: an empty dataset, d below 1, sizes
    past int32, and ``check_rows``'s x."""
    check_rows(x_dtype, precision)
    if n < 1:
        raise ValueError("empty dataset")
    if d < 1:
        raise ValueError(f"width {d} must be >= 1")
    if max(m, n, d, t) > _INT_MAX:
        raise ValueError(f"(m, n, d, t) = ({m}, {n}, {d}, {t}) exceed the "
                         f"kernel's int32 sizes")
    rows = BF16_ROWS if x_dtype == torch.bfloat16 else 0
    if not (aligned and d % 4 == 0 and d <= 32):
        return WeightedPlan(rows, 1)
    return WeightedPlan(rows + 4, 4) if d <= 16 else WeightedPlan(rows + 8, 8)


#: build.KdeWeightedShape per validated call signature
_PLANS: dict = {}


def _plan(q, x, cols, wgt, kind, inv_bw, beta, aligned, precision):
    """Check a call once; the launch's static arguments."""
    check_operand(q, "q", torch.float32, 2, q.device)
    check_operand(x, "x", x.dtype, 2, q.device)   # the plan checks the dtype
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
    plan = weighted_kv_plan(m, n, d, t, aligned, x.dtype, precision)
    return _build.KdeWeightedShape(m, n, d, t, plan.instance,
                                   *kind_args(kind, inv_bw, beta, precision))


def _launch(name: str, q, x, cols, wgt, kind, inv_bw, beta, precision):
    xp = x.data_ptr()
    aligned = xp % (16 if x.dtype == torch.float32 else 8) == 0
    # (shape, strides) pins contiguity; the checks run once per key
    key = (q.shape, q.stride(), x.shape, x.stride(), cols.shape,
           cols.stride(), wgt.shape, wgt.stride(), q.dtype, x.dtype,
           cols.dtype, wgt.dtype, q.get_device(), x.get_device(),
           cols.get_device(), wgt.get_device(), kind, inv_bw, beta, aligned,
           precision)
    shape = _PLANS.get(key)
    if shape is None:
        shape = _PLANS[key] = _plan(q, x, cols, wgt, kind, inv_bw, beta,
                                    aligned, precision)
    m = shape.m
    out = torch.empty((m,) if name == "weighted_kv_sum" else (m, shape.t),
                      dtype=torch.float32, device=q.device)
    if m == 0:
        return out
    lib = _build.library()
    fn = lib.kde_weighted_kv_sum_launch if name == "weighted_kv_sum" \
        else lib.kde_weighted_kv_launch
    err = fn(q.data_ptr(), xp, cols.data_ptr(), wgt.data_ptr(),
             out.data_ptr(), exp_table_ptr(kind, precision, q.device),
             stream_of(q), shape)
    if err:
        _build.check(err, f"kde_{name}")
    LAUNCHES[launch_key(name, precision)] += 1
    return out


def weighted_kv_cuda(q, x, cols, wgt, kind: str, inv_bw: float,
                     beta: float = 1.0, precision: str = "f32"):
    """out[i, j] = wgt[i, j] k(q_i, x[cols[i, j]]) by the weighted-kv
    kernel: q (m, d), x (n, d), wgt (m, t) f32 and cols (m, t) int32 CUDA
    tensors -> (m, t) f32.  Columns outside [0, n) are clamped.  x may be
    bf16 at ``precision="bf16"`` (``check_rows``)."""
    return _launch("weighted_kv", q, x, cols, wgt, kind, inv_bw, beta,
                   precision)


def weighted_kv_sum_cuda(q, x, cols, wgt, kind: str, inv_bw: float,
                         beta: float = 1.0, precision: str = "f32"):
    """out[i] = sum_j wgt[i, j] k(q_i, x[cols[i, j]]) by the
    weighted-kv-sum kernel -> (m,) f32, reduced in a fixed order."""
    return _launch("weighted_kv_sum", q, x, cols, wgt, kind, inv_bw, beta,
                   precision)


def weighted_kv_plain(q, x, cols, wgt, kind: str, inv_bw: float,
                      beta: float = 1.0, pairwise=None,
                      precision: str = "f32"):
    """Plain torch version of ``weighted_kv_cuda`` (also takes the custom
    kinds' ``pairwise`` callable).  A bf16 x gives the same values as the
    f32 x it was rounded from."""
    check_rows(x.dtype, precision)
    return weighted_kv_ref(q, x, cols, wgt, kind, inv_bw, beta, pairwise,
                           precision)


def weighted_kv_sum_plain(q, x, cols, wgt, kind: str, inv_bw: float,
                          beta: float = 1.0, pairwise=None,
                          precision: str = "f32"):
    """Plain torch version of ``weighted_kv_sum_cuda``."""
    return torch.sum(weighted_kv_plain(q, x, cols, wgt, kind, inv_bw, beta,
                                       pairwise, precision), dim=1)
