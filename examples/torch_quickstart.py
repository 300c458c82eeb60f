"""Quickstart on the PyTorch port: sub-quadratic kernel-matrix algorithms
in 60 seconds (``examples/quickstart.py`` on ``repro_torch``).

Builds a kernel graph over a synthetic point cloud and runs the paper's
pipeline end-to-end using only KDE-query-powered primitives -- no n x n
matrix is ever materialized by the algorithms (oracles are used here only
to *verify* the answers).  Runs on the CUDA card; ``--device cpu`` runs
the plain versions.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

from repro_torch.core.cluster.spectral import (cluster_accuracy,
                                               spectral_cluster)
from repro_torch.core.eigen import top_eigenvalue, top_eigenvalue_exact
from repro_torch.core.kernels_fn import gaussian
from repro_torch.core.lowrank import fkv_lowrank
from repro_torch.core.sparsify import spectral_sparsify
from repro_torch.data.synthetic_points import gaussian_clusters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    dev = ap.parse_args(argv).device
    n = 1200
    x, labels = gaussian_clusters(n=n, d=6, k=2, spread=0.3, sep=1.2, seed=0)
    kernel = gaussian(bandwidth=1.0)
    print(f"== kernel graph on {n} points (never materialized: "
          f"{n * n:,} entries) ==")

    # 1. spectral sparsification (Theorem 5.3)
    g = spectral_sparsify(x, kernel, num_edges=8 * n, estimator="stratified",
                          seed=0, device=dev)
    print(f"sparsifier: {g.num_edges} edges "
          f"({g.num_edges / (n * (n - 1) / 2):.1%} of all pairs), "
          f"{g.kernel_evals:,} kernel evals "
          f"(cost ~ n^1.5: wins over the n^2 matrix beyond ~10^4 points)")

    # 2. spectral clustering on the sparsifier (Section 6.2)
    res = spectral_cluster(g, 2, seed=0)
    print(f"clustering accuracy vs ground truth: "
          f"{cluster_accuracy(res.labels, labels, 2):.3f}")

    # 3. low-rank approximation (Corollary 5.14)
    lra = fkv_lowrank(x, kernel, rank=8, estimator="rs", seed=0, device=dev)
    print(f"rank-8 LRA: {lra.kernel_evals:,} kernel evals "
          f"({lra.kernel_evals / n**2:.2f} n^2)")

    # 4. top eigenvalue (Theorem 5.22)
    eig = top_eigenvalue(x, kernel, t=200, seed=0, device=dev)
    truth = top_eigenvalue_exact(kernel, x, device=dev)
    print(f"top eigenvalue: estimate {eig.eigenvalue:.1f} vs exact "
          f"{truth:.1f} ({abs(eig.eigenvalue / truth - 1):.1%} error, "
          f"{eig.kernel_evals:,} evals)")


if __name__ == "__main__":
    main()
