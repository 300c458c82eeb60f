"""Comparison helpers shared by the port's tests and ``chip_smoke.py``."""
from __future__ import annotations

import torch


def bf16_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 steps between two bf16 tensors: their bit patterns
    mapped onto a line (negative values mirrored below +0, -0 onto +0)."""
    def line(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (line(a) - line(b)).abs()


def assert_bf16_close(got: torch.Tensor, want: torch.Tensor, atol: float,
                      what: str = "") -> tuple:
    """bf16 ``got`` within one bf16 step of bf16 ``want``, or within
    ``atol`` of it where a value near zero has steps finer than an f32
    sum's rounding: two f32 computations from the same bf16 operands, each
    rounded once.  Returns (max abs diff, max steps where the diff passes
    ``atol``)."""
    diff = (got.float() - want.float()).abs()
    steps = torch.where(diff > atol, bf16_steps(got, want), 0)
    worst = int(steps.max()) if steps.numel() else 0
    assert worst <= 1, (
        f"{what}: {int((steps > 1).sum())} outputs more than one bf16 step "
        f"from the reference (max abs diff {float(diff.max()):.3e})")
    return float(diff.max()), worst
