"""``normal``: an isotropic cloud, every coordinate N(0, std^2), as the
upstream benchmarks/bench_sparsify.py draws its points (``rng.normal(0,
std, (n, d))``), drawn on the device."""
from __future__ import annotations

import torch


def make(g: torch.Generator, device, *, n: int, d: int,
         std: float) -> torch.Tensor:
    return torch.randn((n, d), generator=g, device=device) * std
