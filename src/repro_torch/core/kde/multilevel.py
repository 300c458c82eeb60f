"""Multi-level KDE (Algorithm 4.1) -- estimators over a dyadic partition tree.

One KDE structure on X, then recursively on each half (Lemma 4.2: a
structure of cost f(n) linear in n gives a tree of cost f(n log n)).  The
tree is consumed by the faithful (``mode="tree"``) neighbor sampler, which
descends it with two child-segment queries per level (Algorithm 4.11).
With ``ExactKDE`` nodes every segment query is one rowsum kernel call on
the card.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.core.kde.base import KDEBase
from repro_torch.core.kernels_fn import Kernel
from repro_torch.device import as_f32, resolve_device


class MultiLevelKDE:
    """KDE structures over dyadic segments [lo, hi) of X.

    ``factory(x_segment, seed)`` builds a Definition-1.1 estimator for one
    segment (a row slice of the tree's device tensor; node seeds are
    ``seed + 977 lo + hi``, the reference's).  Level l has 2^l segments;
    depth stops when segments reach ``leaf_size`` (leaves are evaluated
    exactly -- a leaf *is* its points).
    """

    def __init__(self, x, kernel: Kernel,
                 factory: Callable[[torch.Tensor, int], KDEBase],
                 leaf_size: int = 32, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.x = as_f32(x, self.device)
        self.kernel = kernel
        self.n = int(self.x.shape[0])
        self.leaf_size = leaf_size
        self._nodes: Dict[Tuple[int, int], KDEBase] = {}
        self.depth = 0
        # Build breadth-first over dyadic segments.
        frontier: List[Tuple[int, int]] = [(0, self.n)]
        level = 0
        while frontier:
            nxt: List[Tuple[int, int]] = []
            for (lo, hi) in frontier:
                self._nodes[(lo, hi)] = factory(self.x[lo:hi],
                                                seed + 977 * lo + hi)
                if hi - lo > leaf_size:
                    mid = lo + (hi - lo) // 2
                    nxt.extend([(lo, mid), (mid, hi)])
            frontier = nxt
            level += 1
        self.depth = level

    @property
    def evals(self) -> int:
        """Kernel evaluations summed over every tree node."""
        return sum(node.evals for node in self._nodes.values())

    def segment_query(self, y: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """Estimate sum_{j in [lo, hi)} k(y_i, x_j) via the node estimator."""
        return self._nodes[(lo, hi)].query(y)

    def children(self, lo: int, hi: int):
        """The two dyadic child segments of [lo, hi)."""
        mid = lo + (hi - lo) // 2
        return (lo, mid), (mid, hi)

    def is_leaf(self, lo: int, hi: int) -> bool:
        """True when [lo, hi) is evaluated exactly (Algorithm 4.1)."""
        return hi - lo <= self.leaf_size
