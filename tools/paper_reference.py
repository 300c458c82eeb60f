"""The JAX reference's counters and accuracies of the paper's Section 7
experiments, at the sizes ``chip_smoke.py``'s ``paper`` phase runs them.

Figure 4 (``benchmarks/bench_sparsify.py`` ``_figure4``): nested (n =
5000, gaussian at bandwidth 0.3, 2.5% of all edges) and rings (n = 2500,
gaussian at 0.25 x the median bandwidth, 3.3% of all edges), each
``spectral_sparsify(estimator="exact", exact_blocks=True, seed=0)`` then
``spectral_cluster(g, 2, seed=0)``.  Figure 3 (``benchmarks/bench_lra.py``
``run``): mnist_like and glove_like at n = 2500, laplacian at the median
L1 bandwidth, ranks 5 / 10 / 20 / 40, ``fkv_lowrank(estimator="rs",
num_rows=25 r, seed=0)``, its relative Frobenius error beside a 10-step
subspace iteration's.

``num_edges``, ``kernel_evals`` and ``kde_queries`` are functions of the
static shapes, so the port must give the same values; the accuracies and
errors are the yardsticks the phase holds the port's to.  Prints one JSON
object.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/paper_reference.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/paper_reference.py \
        --nested 2500 --rings 1500      # bench_sparsify.py's sizes
"""
from __future__ import annotations

import argparse
import json

import jax.numpy as jnp
import numpy as np

from repro.core.cluster.spectral import cluster_accuracy, spectral_cluster
from repro.core.kernels_fn import gaussian, laplacian, median_bandwidth
from repro.core.lowrank import (fkv_lowrank, projection_error,
                                subspace_iteration)
from repro.core.sparsify import spectral_sparsify
from repro.data.synthetic_points import glove_like, mnist_like, nested, rings

RANKS = (5, 10, 20, 40)


def figure4(name: str, n: int, frac: float) -> dict:
    x, lab = (nested if name == "nested" else rings)(n=n, seed=0)
    bw = 0.3 if name == "nested" else \
        0.25 * median_bandwidth(jnp.asarray(x))
    budget = int(frac * n * (n - 1) / 2)
    g = spectral_sparsify(x, gaussian(bandwidth=bw), num_edges=budget,
                          estimator="exact", exact_blocks=True, seed=0)
    acc = cluster_accuracy(spectral_cluster(g, 2, seed=0).labels, lab, 2)
    return dict(n=n, frac=frac, bandwidth=float(bw), num_edges=g.num_edges,
                kernel_evals=int(g.kernel_evals),
                kde_queries=int(g.kde_queries), accuracy=float(acc))


def figure3(name: str, n: int) -> dict:
    x = (mnist_like if name == "mnist" else glove_like)(n=n)
    ker = laplacian(bandwidth=median_bandwidth(jnp.asarray(x), ord=1))
    k = np.asarray(ker.matrix(jnp.asarray(x)), np.float64)
    fro2 = np.linalg.norm(k, "fro") ** 2
    out = dict(n=n, bandwidth=float(ker.bandwidth), ranks={})
    for r in RANKS:
        res = fkv_lowrank(x, ker, rank=r, num_rows=25 * r, estimator="rs",
                          seed=0)
        _, u_svd = subspace_iteration(k, r, iters=10, seed=0)
        out["ranks"][r] = dict(
            kernel_evals=int(res.kernel_evals),
            err=float(projection_error(k, res.u) / fro2),
            err_svd=float(projection_error(k, u_svd) / fro2))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nested", type=int, default=5000)
    ap.add_argument("--rings", type=int, default=2500)
    ap.add_argument("--lra-n", type=int, default=2500)
    args = ap.parse_args()
    print(json.dumps(dict(
        nested=figure4("nested", args.nested, 0.025),
        rings=figure4("rings", args.rings, 0.033),
        mnist=figure3("mnist", args.lra_n),
        glove=figure3("glove", args.lra_n))))


if __name__ == "__main__":
    main()
