"""The card's peaks and the least time a call's kernel evaluations take.

Peaks of one NVIDIA H100 SXM from its data sheet (the port's
``roofline/analysis.H100``), dense rates, at the full 700 W power limit.
The FP32 operations of one kernel evaluation are the configuration's
(``kernel.ops_per_eval``), counted as the port's kernel table in PERF.md
counts them.
"""
from __future__ import annotations

FP32_FLOPS = 67e12          # FP32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12         # HBM3, bytes/s


def least_seconds(evals: float, ops_per_eval: float,
                  input_bytes: float) -> float:
    """The larger of the evaluations' operations at the FP32 peak and the
    inputs read once at the HBM peak."""
    return max(evals * ops_per_eval / FP32_FLOPS, input_bytes / HBM_BYTES)
