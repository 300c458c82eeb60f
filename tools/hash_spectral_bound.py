"""Spectral error of the JAX reference's sparsifier, over seeds.

The configuration is the spectral config of ``benchmarks/bench_kde.py``
(and of ``benchmarks/bench_sparsify.py``'s quick run): x ~ N(0, 0.35^2)
with numpy seed 0, n = 1024, d = 8, gaussian kernel at bandwidth 3.0, t =
16n edges, ``spectral_sparsify(estimator=...)`` with the estimator's
defaults (``--estimator hash``, the default, or ``stratified``: s = 16
rows a level-1 block).  The error is the bench's: the largest |v^T L_G v /
v^T L v - 1| over 24 centred Gaussian probes (numpy seed 1) against the
dense Laplacian.  The port's smoke test (``chip_smoke.py``, hash and
stratified phases) pins each bound at 1.5x the largest value this script
prints for that estimator.

With ``--lra`` it prints instead the reference's ``fkv_lowrank(estimator=
"rs")`` error over a 10-step subspace iteration's, at the configuration of
``benchmarks/bench_lra.py`` (mnist_like n = 2500, laplacian at the median
L1 bandwidth, rank 20, 500 rows; errors ||K - K U^T U||_F^2 / ||K||_F^2),
over the same seeds: the smoke test's LRA bound is 1.5x the subspace
iteration's error unless this ratio exceeds 1.5.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/hash_spectral_bound.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/hash_spectral_bound.py \
        --estimator stratified
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/hash_spectral_bound.py \
        --lra
"""
from __future__ import annotations

import argparse
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


def lra_ratios() -> None:
    from repro.core.kernels_fn import laplacian, median_bandwidth
    from repro.core.lowrank import (fkv_lowrank, projection_error,
                                    subspace_iteration)
    from repro.data.synthetic_points import mnist_like
    x = mnist_like(n=2500)
    ker = laplacian(bandwidth=median_bandwidth(jnp.asarray(x), ord=1))
    k = np.asarray(ker.matrix(jnp.asarray(x)), np.float64)
    fro2 = np.linalg.norm(k, "fro") ** 2
    _, u_svd = subspace_iteration(k, 20, iters=10, seed=0)
    e_svd = projection_error(k, u_svd) / fro2
    ratios = []
    for seed in SEEDS:
        res = fkv_lowrank(x, ker, rank=20, num_rows=500, estimator="rs",
                          seed=seed)
        ratios.append(float(projection_error(k, res.u) / fro2 / e_svd))
        print(f"seed {seed}: rs / subspace iteration error {ratios[-1]!r}",
              flush=True)
    print(json.dumps({"estimator": "rs", "ratios": ratios,
                      "max": max(ratios),
                      "fallback_bound": 1.5 * max(ratios)}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--estimator", default="hash",
                    choices=("hash", "stratified"))
    ap.add_argument("--lra", action="store_true")
    args = ap.parse_args()
    if args.lra:
        lra_ratios()
        return
    x = np.random.default_rng(0).normal(0, SIGMA, (N, D)).astype(np.float32)
    ker = gaussian(bandwidth=BW)
    k = np.asarray(ker.matrix(jnp.asarray(x)), np.float64)
    np.fill_diagonal(k, 0.0)
    lap = np.diag(k.sum(1)) - k
    errs = []
    for seed in SEEDS:
        g = spectral_sparsify(x, ker, num_edges=16 * N,
                              estimator=args.estimator, seed=seed)
        errs.append(spectral_error(g.laplacian_dense(), lap))
        print(f"seed {seed}: spectral error {errs[-1]!r}", flush=True)
    print(json.dumps({"estimator": args.estimator, "errors": errs,
                      "max": max(errs), "bound": 1.5 * max(errs)}))


if __name__ == "__main__":
    main()
