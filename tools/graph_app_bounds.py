"""Relative errors of the JAX reference's triangle and arboricity
estimators, over seeds.

The configuration is ``benchmarks/bench_graph.py``'s accuracy part at its
full size: ``gaussian_clusters(n=1200, d=4, k=2, spread=0.3, sep=1.2,
seed=3)``, gaussian kernel at bandwidth 1.0, stratified level-1 reads (the
estimators' defaults); ``estimate_arboricity`` at m = 2400 and 9600 edges
against ``exact_arboricity`` (the greedy peel of the full graph), and
``estimate_triangle_weight`` at 200 pairs x 8 draws and 600 x 24 against
``exact_triangle_weight``.  The port's smoke test (``chip_smoke.py``, graph
phase) pins each bound at 1.5x the largest relative error this script
prints for that configuration.  It runs the reference only.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/graph_app_bounds.py
"""
from __future__ import annotations

import json

from repro.core.graph.arboricity import estimate_arboricity, exact_arboricity
from repro.core.graph.triangles import (estimate_triangle_weight,
                                        exact_triangle_weight)
from repro.core.kernels_fn import gaussian
from repro.data.synthetic_points import gaussian_clusters

N, SEEDS = 1200, range(5)
ARB_EDGES = (2 * N, 8 * N)
TRI_CONFIGS = ((200, 8), (600, 24))


def main() -> None:
    x, _ = gaussian_clusters(n=N, d=4, k=2, spread=0.3, sep=1.2, seed=3)
    ker = gaussian(bandwidth=1.0)
    out = {}
    truth = exact_arboricity(ker, x)
    for m in ARB_EDGES:
        errs = []
        for seed in SEEDS:
            res = estimate_arboricity(x, ker, num_edges=m,
                                      estimator="stratified", seed=seed)
            errs.append(abs(res.density - truth) / truth)
            print(f"arboricity m={m} seed {seed}: rel err {errs[-1]!r}",
                  flush=True)
        out[f"arboricity m={m}"] = dict(errs=errs, max=max(errs),
                                        bound=1.5 * max(errs))
    truth = exact_triangle_weight(ker, x)
    for m, ns in TRI_CONFIGS:
        errs = []
        for seed in SEEDS:
            res = estimate_triangle_weight(x, ker, num_edges=m,
                                           neighbor_samples=ns,
                                           estimator="stratified", seed=seed)
            errs.append(abs(res.total_weight - truth) / truth)
            print(f"triangles {m}x{ns} seed {seed}: rel err {errs[-1]!r}",
                  flush=True)
        out[f"triangles {m}x{ns}"] = dict(errs=errs, max=max(errs),
                                          bound=1.5 * max(errs))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
