"""Kernel-graph analytics over LM embeddings on the PyTorch port
(``examples/kernel_graph_analytics.py`` on ``repro_torch``).

Trains a tiny LM for a few steps, takes its token-embedding table, and runs
the full Table-1 application suite on the embedding kernel graph: sparsify,
spectral + local clustering, a Laplacian solve, the top eigenvalue,
arboricity, triangle weight.  Runs on the CUDA card; ``--device cpu`` runs
the plain versions.

  PYTHONPATH=src python examples/torch_kernel_graph_analytics.py
  PYTHONPATH=src python examples/torch_kernel_graph_analytics.py --device cpu
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, get_reduced
from repro_torch.core.cluster.local import same_cluster_test
from repro_torch.core.cluster.spectral import spectral_cluster
from repro_torch.core.eigen import top_eigenvalue
from repro_torch.core.graph.arboricity import estimate_arboricity
from repro_torch.core.graph.triangles import estimate_triangle_weight
from repro_torch.core.kernels_fn import gaussian, median_bandwidth
from repro_torch.core.laplacian import cg_laplacian
from repro_torch.core.sparsify import spectral_sparsify
from repro_torch.data.pipeline import make_batch
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWConfig, init_adamw
from repro_torch.train.train_step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    dev = ap.parse_args(argv).device
    cfg = dataclasses.replace(get_reduced("granite_3_2b"), dtype="float32")
    shape = ShapeConfig("t", 128, 4, "train")
    model = T.init_params(cfg, seed=0, device=dev)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    state = init_adamw(model)
    print("== training a small LM for 20 steps ==")
    for i in range(20):
        model, state, m = step(model, state, make_batch(cfg, shape, i))
    print(f"final loss: {float(m['loss']):.3f}")

    emb = model.embed.detach().cpu().numpy()[:cfg.vocab_size]
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    n = emb.shape[0]
    bw = median_bandwidth(torch.as_tensor(emb))
    kernel = gaussian(bandwidth=bw)
    print(f"== kernel graph over {n} token embeddings (bw={bw:.3f}) ==")

    g = spectral_sparsify(emb, kernel, num_edges=10 * n,
                          estimator="stratified", seed=0, device=dev)
    print(f"sparsifier: {g.num_edges} edges, {g.kernel_evals:,} kernel evals")

    res = spectral_cluster(g, 2, seed=0)
    sizes = np.bincount(res.labels)
    print(f"token communities: sizes={sizes.tolist()} "
          f"(bottom eigenvalues {np.round(res.eigenvalues, 4).tolist()})")

    # Laplacian solve on the sparsifier (Section 5.1.1, device CG).
    b = np.random.default_rng(0).standard_normal(n)
    b -= b.mean()
    sol, resid = cg_laplacian(g, b, iters=200, device=dev)
    print(f"Laplacian solve on the sparsifier: residual {resid:.2e}")

    # Same-cluster test between two tokens (Algorithm 6.1, one device walk).
    same = np.where(res.labels == res.labels[0])[0]
    diff = np.where(res.labels != res.labels[0])[0]
    i0 = int(same[1]) if len(same) > 1 else 1
    i1 = int(diff[0]) if len(diff) else n - 1
    lc = same_cluster_test(emb, kernel, 0, i1, walk_length=5, num_walks=200,
                           seed=0, device=dev)
    lc0 = same_cluster_test(emb, kernel, 0, i0, walk_length=5,
                            num_walks=200, seed=1, device=dev)
    print(f"same-cluster(0, {i1})? {lc.same_cluster} "
          f"(stat {lc.statistic:.2e} vs thr {lc.threshold:.2e}); "
          f"same-cluster(0, {i0})? {lc0.same_cluster}")

    # Top eigenvalue from a submatrix (Algorithm 5.18, noisy power).
    eig = top_eigenvalue(emb, kernel, t=min(192, n), method="noisy_power",
                         seed=0, device=dev)
    print(f"top eigenvalue ~ {eig.eigenvalue:.1f} "
          f"({eig.kernel_evals:,} evals + "
          f"{eig.matvec_sampled_evals:,} sampled matvec lookups)")

    arb = estimate_arboricity(emb, kernel, num_edges=4 * n,
                              estimator="stratified", seed=0, device=dev)
    print(f"embedding-graph arboricity (densest community density): "
          f"{arb.density:.2f}")

    tri = estimate_triangle_weight(emb, kernel, num_edges=300,
                                   neighbor_samples=12,
                                   estimator="stratified", seed=0,
                                   device=dev)
    print(f"total triangle weight (clustering-coefficient mass): "
          f"{tri.total_weight:.3e}")


if __name__ == "__main__":
    main()
