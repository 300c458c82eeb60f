"""``mnist_like``: the upstream stand-in of MNIST's shape
(``data/synthetic_points.py``), drawn on the device.  A sparse non-negative
class-structured cloud in [0, 1]^d: prototypes U(0, 1) kept with
probability 0.2, a uniform class a point, N(0, 0.08^2) noise, clipped to
[0, 1]."""
from __future__ import annotations

import torch


def make(g: torch.Generator, device, *, n: int, d: int,
         classes: int) -> torch.Tensor:
    protos = torch.rand((classes, d), generator=g, device=device)
    keep = torch.rand((classes, d), generator=g, device=device) < 0.2
    protos = protos * keep
    lab = torch.randint(0, classes, (n,), generator=g, device=device)
    x = protos[lab]
    x.add_(torch.randn((n, d), generator=g, device=device), alpha=0.08)
    return x.clamp_(0.0, 1.0)
