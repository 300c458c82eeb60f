"""Rounding to TF32 and the chi-square arithmetic the comparisons share."""
from __future__ import annotations

import math

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 stored mantissa bits, to the
    nearest and ties to even, as a tensor core rounds a TF32 operand.  The
    product of two such values is exact in float32, so a float32 matmul of
    rounded operands is a TF32 matmul up to its order of summation."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    b = torch.where(b >= 1 << 31, b - (1 << 32), b)
    return b.to(torch.int32).view(torch.float32)


def chi2_z(counts: torch.Tensor, expected: torch.Tensor) -> float:
    """The chi-square statistic of ``counts`` against ``expected`` as a z
    score, (chi2 - df) / sqrt(2 df): about N(0, 1) when the counts follow
    the law, whatever the number of draws and bins."""
    counts = counts.double()
    expected = expected.double()
    stat = float(((counts - expected) ** 2 / expected).sum())
    df = counts.numel() - 1
    return (stat - df) / math.sqrt(2.0 * df)
