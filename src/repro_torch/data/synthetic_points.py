"""Point-cloud datasets for the paper's experiments (Section 7): numpy
copies of ``repro.data.synthetic_points`` (same generator calls in the
same order, so the same ``(n, seed)`` gives bitwise the same points and
labels).

``nested`` (Figure 2a) and ``rings`` (Figure 2b) are the spectral
sparsification and clustering datasets of Figure 4; ``mnist_like`` and
``glove_like`` are offline stand-ins for the MNIST / GloVe clouds of the
LRA experiment (Figure 3): mixtures of matched dimension and scale, so
the kernel spectra behave comparably; ``gaussian_clusters`` is a generic
k-clusterable cloud.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def nested(n: int = 5000, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Half the points at the origin, half on the unit circle (Figure 2a).
    Small jitter keeps the kernel matrix non-degenerate."""
    rng = np.random.default_rng(seed)
    half = n // 2
    inner = rng.normal(0.0, 0.05, size=(half, 2))
    theta = rng.uniform(0, 2 * np.pi, size=n - half)
    outer = np.stack([np.cos(theta), np.sin(theta)], 1)
    outer += rng.normal(0.0, 0.02, size=outer.shape)
    x = np.concatenate([inner, outer]).astype(np.float32)
    y = np.concatenate([np.zeros(half, np.int64), np.ones(n - half, np.int64)])
    perm = rng.permutation(n)
    return x[perm], y[perm]


def rings(n: int = 2500, minor: float = 5.0, major: float = 100.0,
          seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Two interlocked tori in R^3 (Figure 2b): minor radius 5, major 100."""
    rng = np.random.default_rng(seed)
    half = n // 2

    def torus(m):
        u = rng.uniform(0, 2 * np.pi, size=m)
        v = rng.uniform(0, 2 * np.pi, size=m)
        xx = (major + minor * np.cos(v)) * np.cos(u)
        yy = (major + minor * np.cos(v)) * np.sin(u)
        zz = minor * np.sin(v)
        return np.stack([xx, yy, zz], 1)

    t1 = torus(half)
    t2 = torus(n - half)
    # interlock: rotate the second torus 90 deg about x and shift by major
    rot = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], float)
    t2 = t2 @ rot.T + np.array([major, 0.0, 0.0])
    x = np.concatenate([t1, t2]).astype(np.float32)
    y = np.concatenate([np.zeros(half, np.int64), np.ones(n - half, np.int64)])
    perm = rng.permutation(n)
    return x[perm], y[perm]


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


def glove_like(n: int = 4000, d: int = 200, seed: int = 0) -> np.ndarray:
    """Dense low-intrinsic-dimension embedding cloud (offline stand-in for
    GloVe)."""
    rng = np.random.default_rng(seed)
    basis = rng.normal(size=(24, d)) / np.sqrt(d)
    coef = rng.normal(size=(n, 24)) * np.geomspace(1.0, 0.05, 24)[None, :]
    x = coef @ basis + 0.02 * rng.normal(size=(n, d))
    return x.astype(np.float32)


def gaussian_clusters(n: int = 1024, d: int = 8, k: int = 2,
                      spread: float = 0.25, sep: float = 3.0,
                      seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Generic k-clusterable point cloud."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * sep
    lab = rng.integers(0, k, size=n)
    x = centers[lab] + rng.normal(0, spread, size=(n, d))
    return x.astype(np.float32), lab
