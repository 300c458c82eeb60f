"""Power of the Markov-law check of ``chip_smoke.py``'s graph phase.

The check bins the endpoints of 20,000 walks of 3 steps from vertex 0 by
level-1 block (64 rows at n = 4096) and holds them by Pearson's
chi-square at alpha 1e-3 against the block masses of e_0 M^3, M the
gaussian walk matrix.  For each data set this script prints, in float64
on the CPU, the expected statistic when the endpoints follow the right
law (about df) and when they follow a wrong one -- uniform endpoints, or
e_0 M^2 -- next to the critical point: a check separates the laws only
where the wrong laws' expected statistics lie far above it.

    PYTHONPATH=src python tools/markov_law_power.py
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.data.synthetic_points import gaussian_clusters

N, D, WALKS, BLOCK, Z = 4096, 16, 20000, 64, 3.0902


def critical(df: int) -> float:
    """Upper alpha = 1e-3 point of chi-square(df), Wilson-Hilferty."""
    a = 2.0 / (9.0 * df)
    return df * (1.0 - a + Z * a ** 0.5) ** 3


def expected_stat(p, q) -> float:
    """E[chi-square] of WALKS draws from block law ``p`` tested against
    ``q`` (cells expecting fewer than 5 pooled, as the check does)."""
    small = WALKS * q < 5.0
    if small.any():
        p = np.append(p[~small], p[small].sum())
        q = np.append(q[~small], q[small].sum())
    return float(WALKS * ((p - q) ** 2 / q).sum() + len(q) - 1)


def masses(x, bw):
    """Block masses of e_0 M^2 and e_0 M^3."""
    x = x.astype(np.float64)
    sq = (x * x).sum(1)
    k = np.exp(-np.maximum(sq[:, None] + sq[None] - 2 * x @ x.T, 0) / bw ** 2)
    np.fill_diagonal(k, 0.0)
    m = k / k.sum(1, keepdims=True)
    p2 = m[0] @ m
    own = np.arange(N) // BLOCK
    return [np.bincount(own, weights=p, minlength=N // BLOCK)
            for p in (p2, p2 @ m)]


def main() -> None:
    plain = np.random.default_rng(0).normal(0, 0.5, (N, D))
    xc, lab = gaussian_clusters(n=N, d=D, k=8, spread=0.3, sep=0.4, seed=0)
    sets = {"N(0, 0.5^2), bandwidth 4.0": (plain, 4.0),
            "8 clusters (spread 0.3, sep 0.4) sorted by label, bandwidth "
            "1.0": (xc[np.argsort(lab, kind="stable")], 1.0)}
    for name, (x, bw) in sets.items():
        b2, b3 = masses(x, bw)
        df = N // BLOCK - 1
        print(json.dumps({
            "data": name, "df": df, "critical": critical(df),
            "right law": expected_stat(b3, b3),
            "uniform endpoints": expected_stat(
                np.full(N // BLOCK, BLOCK / N), b3),
            "endpoints against e_0 M^2": expected_stat(b3, b2)}))


if __name__ == "__main__":
    main()
