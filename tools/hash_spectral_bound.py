"""Spectral error of the JAX reference's hashed-KDE sparsifier, over seeds.

The configuration is the spectral config of ``benchmarks/bench_kde.py``:
x ~ N(0, 0.35^2) with numpy seed 0, n = 1024, d = 8, gaussian kernel at
bandwidth 3.0, t = 16n edges, ``spectral_sparsify(estimator="hash")``.  The
error is the bench's: the largest |v^T L_G v / v^T L v - 1| over 24 centred
Gaussian probes (numpy seed 1) against the dense Laplacian.  The port's
smoke test (``chip_smoke.py``, hash phase) pins its bound at 1.5x the largest
value this script prints.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/hash_spectral_bound.py
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np

from repro.core.kernels_fn import gaussian
from repro.core.sparsify import spectral_sparsify

N, D, SIGMA, BW, SEEDS = 1024, 8, 0.35, 3.0, range(5)


def spectral_error(lap_g: np.ndarray, lap: np.ndarray, probes: int = 24,
                   seed: int = 1) -> float:
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((lap.shape[0], probes))
    v -= v.mean(0)
    ratios = np.einsum("ij,ij->j", v, lap_g @ v) / \
        np.einsum("ij,ij->j", v, lap @ v)
    return float(np.abs(ratios - 1.0).max())


def main() -> None:
    x = np.random.default_rng(0).normal(0, SIGMA, (N, D)).astype(np.float32)
    ker = gaussian(bandwidth=BW)
    k = np.asarray(ker.matrix(jnp.asarray(x)), np.float64)
    np.fill_diagonal(k, 0.0)
    lap = np.diag(k.sum(1)) - k
    errs = []
    for seed in SEEDS:
        g = spectral_sparsify(x, ker, num_edges=16 * N, estimator="hash",
                              seed=seed)
        errs.append(spectral_error(g.laplacian_dense(), lap))
        print(f"seed {seed}: spectral error {errs[-1]!r}", flush=True)
    print(json.dumps({"errors": errs, "max": max(errs),
                      "bound": 1.5 * max(errs)}))


if __name__ == "__main__":
    main()
