"""``median_l1``: the median rule for the L1 distance (Section 3.1; the
upstream ``bench_lra.py`` bandwidth): the median of the pairwise L1
distances of 2,048 points drawn by the generator, the two middle values
averaged."""
from __future__ import annotations

import torch

SAMPLE = 2048


def rule(x: torch.Tensor, g: torch.Generator) -> float:
    idx = torch.randperm(x.shape[0], generator=g, device=x.device)[:SAMPLE]
    xs = x[idx].double()
    d = torch.cdist(xs, xs, p=1)
    iu = torch.triu_indices(xs.shape[0], xs.shape[0], offset=1,
                            device=x.device)
    s = torch.sort(d[iu[0], iu[1]]).values
    k = s.numel()
    return float((s[(k - 1) // 2] + s[k // 2]) / 2.0)
