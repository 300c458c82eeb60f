"""Point-cloud datasets for the paper's experiments (Section 7): numpy
copies of ``repro.data.synthetic_points.mnist_like`` and
``gaussian_clusters`` (same generator calls, so the same seed gives the
same points)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def mnist_like(n: int = 4000, d: int = 784, classes: int = 10,
               seed: int = 0) -> np.ndarray:
    """Sparse non-negative class-structured cloud in [0, 1]^784 (offline
    stand-in for MNIST)."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 1, size=(classes, d)) * (
        rng.uniform(size=(classes, d)) < 0.2)
    lab = rng.integers(0, classes, size=n)
    x = protos[lab] + rng.normal(0, 0.08, size=(n, d))
    return np.clip(x, 0, 1).astype(np.float32)


def gaussian_clusters(n: int = 1024, d: int = 8, k: int = 2,
                      spread: float = 0.25, sep: float = 3.0,
                      seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Generic k-clusterable point cloud."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * sep
    lab = rng.integers(0, k, size=n)
    x = centers[lab] + rng.normal(0, spread, size=(n, d))
    return x.astype(np.float32), lab
