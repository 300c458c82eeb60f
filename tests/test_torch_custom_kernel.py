"""A custom kernel through the port's sampler, estimators, sparsifiers and
LRA, held against the reference on the same inputs (ROADMAP.md section 3,
fault F3).

The kernel is ``dataclasses.replace(gaussian(1.0), name="mykind",
pairwise=<exp(-|x - y|^2)>)`` in each package, x a 256 x 4 standard
normal from ``np.random.default_rng(0)``.  A custom kind runs its
``pairwise`` closure on every device (no CUDA kernel can evaluate a Python
closure): the port's kernel wrappers, CUDA and plain, are never entered
for it.

Tolerances: exact sums and probabilities rtol 2e-4 (the reference's own);
counters exactly; draws in law (``tests/stats.py``, alpha 1e-3): a
chi-square against the reference's exact probabilities where the law is
the exact one, a two-sample TV otherwise.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kde.base import make_estimator as j_make_estimator
from repro.core.kernels_fn import gaussian as j_gaussian
from repro.core.lowrank import fkv_lowrank as j_fkv
from repro.core.sampling.edge import NeighborSampler as JSampler
from repro.core.sampling.rownorm import RowNormSampler as JRowNorm
from repro.core.sparsify import spectral_sparsify as j_sparsify
from repro_torch.core.kde.base import make_estimator as t_make_estimator
from repro_torch.core.kernels_fn import gaussian as t_gaussian
from repro_torch.core.lowrank import fkv_lowrank as t_fkv
from repro_torch.core.sampling.edge import NeighborSampler as TSampler
from repro_torch.core.sampling.rownorm import RowNormSampler as TRowNorm
from repro_torch.core.sparsify import spectral_sparsify as t_sparsify
from repro_torch.kernels.kde_hash import kernel as hash_k
from repro_torch.kernels.kde_rowsum import kernel as rowsum_k
from repro_torch.kernels.kde_sampler import kernel as sampler_k

from stats import chi2_critical, chi2_statistic, tv_distance, tv_tolerance

RTOL = 2e-4
N, D = 256, 4


def _j_pairwise(a, b):
    d2 = jnp.sum(a * a, 1)[:, None] + jnp.sum(b * b, 1)[None, :] \
        - 2.0 * a @ b.T
    return jnp.exp(-jnp.maximum(d2, 0.0))


def _t_pairwise(a, b):
    d2 = torch.sum(a * a, 1)[:, None] + torch.sum(b * b, 1)[None, :] \
        - 2.0 * a @ b.T
    return torch.exp(-torch.clamp(d2, min=0.0))


JK = dataclasses.replace(j_gaussian(1.0), name="mykind", pairwise=_j_pairwise)
TK = dataclasses.replace(t_gaussian(1.0), name="mykind", pairwise=_t_pairwise)
X = np.random.default_rng(0).standard_normal((N, D)).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_kernel_wrapper(monkeypatch):
    """Every CUDA wrapper of the KDE kernels raises, and so do the plain
    versions that evaluate the built-in kinds by name (the level-1 and
    rowsum ones): a custom kind must reach none of them.  The hashed
    read's plain versions take the ``pairwise`` closure and stay."""
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"{name} entered for a custom kind")
        return fn
    wrappers = [(mod, name + suffix) for mod, names in (
        (sampler_k, ("masked_blocksum", "sample_block")),
        (rowsum_k, ("rowsum", "blocksum"))) for name in names
        for suffix in ("_cuda", "_plain")]
    wrappers += [(hash_k, "weighted_kv_cuda"), (hash_k, "weighted_kv_sum_cuda")]
    for mod, name in wrappers:
        monkeypatch.setattr(mod, name, refuse(name))


def _mass_bins(probs, num_bins=16):
    """Cells of ``probs`` grouped into ``num_bins`` bins of about equal
    mass (cells sorted by probability): the bin of every cell."""
    order = np.argsort(probs, kind="stable")
    edges = np.cumsum(probs[order]) / probs.sum()
    bins = np.empty(len(probs), np.int64)
    bins[order] = np.minimum((edges * num_bins).astype(np.int64),
                             num_bins - 1)
    return bins


def _chi2_law(draws, probs, num_bins=16):
    """Chi-square of ``draws`` against the law ``probs`` over equal-mass
    bins (alpha 1e-3)."""
    bins = _mass_bins(probs, num_bins)
    counts = np.bincount(bins[draws], minlength=num_bins)
    want = np.bincount(bins, weights=probs, minlength=num_bins) \
        / probs.sum() * len(draws)
    return chi2_statistic(counts, want), chi2_critical(num_bins - 1)


def _tv_law(a, b, bins, num_bins):
    """Two-sample TV between draws ``a`` and ``b`` over ``bins``."""
    ca = np.bincount(bins[a], minlength=num_bins)
    cb = np.bincount(bins[b], minlength=num_bins)
    return tv_distance(ca, cb), tv_tolerance(num_bins, len(a), len(b))


def _dense_row(u):
    return np.asarray(JK.pairwise(jnp.asarray(X[u:u + 1]),
                                  jnp.asarray(X)))[0].astype(np.float64)


def test_exact_neighbor_sampler_matches_reference():
    """``exact_blocks=True``: ``prob_of`` equals the reference's (rtol
    2e-4) over a (src, dst) grid; 4,000 draws from one source follow the
    reference's probabilities (chi-square)."""
    src = np.repeat(np.arange(0, N, 16), 12)
    dst = np.random.default_rng(1).integers(0, N, len(src))
    dst = np.where(dst == src, (dst + 1) % N, dst)
    tn = TSampler(X, TK, seed=0, exact_blocks=True, device="cpu")
    jn = JSampler(X, JK, seed=0, exact_blocks=True)
    np.testing.assert_allclose(tn.prob_of(src, dst), jn.prob_of(src, dst),
                               rtol=RTOL)
    assert tn.evals == jn.evals
    u = 5
    probs = jn.prob_of(np.full(N, u), np.arange(N)).astype(np.float64)
    probs[u] = 0.0
    draws, _ = tn.sample(np.full(4000, u))
    stat, crit = _chi2_law(draws, probs)
    assert stat < crit, (stat, crit)


@pytest.mark.parametrize("level1", ["blocked", "hash"])
def test_default_and_hashed_sampler_match_reference_in_law(level1):
    """The default sampler (at n = 256 its 16 rows a block are the whole
    16-row block) and the hashed one: 4,000 draws from one source, port
    against reference by two-sample TV over equal-mass bins of the exact
    row, and the realized probabilities each side returns are those of its
    own ``prob_of`` (exact default: rtol 2e-4 against the reference's)."""
    u = 7
    row = _dense_row(u)
    row[u] = 0.0
    bins = _mass_bins(row)
    tn = TSampler(X, TK, seed=0, level1=level1, device="cpu")
    jn = JSampler(X, JK, seed=0, level1=level1)
    src = np.full(4000, u)
    a, pa = tn.sample(src)
    b, pb = jn.sample(src)
    assert tn.evals == jn.evals
    tv, tol = _tv_law(a, b, bins, 16)
    assert tv < tol, (tv, tol)
    assert np.isfinite(pa).all() and (pa > 0).all()
    if level1 == "blocked":
        np.testing.assert_allclose(pa, jn.prob_of(src, a), rtol=RTOL)


def test_walks_match_reference_in_law():
    """3-step walks of 4,000 walkers from one start: endpoints by
    two-sample TV over the 16 blocks of 16 consecutive indices."""
    tn = TSampler(X, TK, seed=0, device="cpu")
    jn = JSampler(X, JK, seed=0)
    starts = np.full(4000, 11)
    a, _ = tn.walk(starts, 3)
    b, _ = jn.walk(starts, 3)
    tv, tol = _tv_law(np.asarray(a), np.asarray(b), np.arange(N) // 16, 16)
    assert tv < tol, (tv, tol)
    assert tn.evals == jn.evals


@pytest.mark.parametrize("estimator", ["stratified", "hash", "exact"])
def test_sparsifiers_match_reference(estimator):
    """``spectral_sparsify`` (the default, hashed and exact estimators):
    the same counters as the reference's; the exact degrees equal its
    exact row sums less the self term (rtol 2e-4); the total weight
    within 3% of the reference's (an unbiased estimate of the same sum)."""
    kw = dict(seed=0)
    if estimator != "stratified":
        kw["estimator"] = estimator
    g = t_sparsify(X, TK, 500, device="cpu", **kw)
    r = j_sparsify(X, JK, 500, **kw)
    assert (g.kernel_evals, g.kde_queries, g.num_edges) == \
        (r.kernel_evals, r.kde_queries, r.num_edges)
    assert np.isfinite(g.weight).all()
    if estimator != "hash":
        want = np.asarray(j_make_estimator("exact", X, JK).query(
            jnp.asarray(X))) - 1.0
        np.testing.assert_allclose(g.degrees, want, rtol=RTOL)
    np.testing.assert_allclose(g.weight.sum(), r.weight.sum(), rtol=3e-2)


def test_exact_estimator_matches_reference():
    """``make_estimator("exact").query`` sums ``kernel.pairwise``: rtol
    2e-4 against the reference's, with its eval count."""
    te = t_make_estimator("exact", X, TK, device="cpu")
    je = j_make_estimator("exact", X, JK)
    got = te.query(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, np.asarray(je.query(jnp.asarray(X))),
                               rtol=RTOL)
    assert te.evals == je.evals == N * N


@pytest.mark.parametrize("estimator", ["exact", "rs"])
def test_lowrank_matches_reference(estimator):
    """``fkv_lowrank`` with exact and ``rs`` row norms: the reference's
    eval and query counts, orthonormal right factors; the exact row norms
    equal the reference's (rtol 2e-4), and the sampled rows follow them
    (chi-square of 2,000 draws)."""
    res = t_fkv(X, TK, 4, estimator=estimator, seed=0, device="cpu")
    ref = j_fkv(X, JK, 4, estimator=estimator, seed=0)
    assert (res.kernel_evals, res.kde_queries) == \
        (ref.kernel_evals, ref.kde_queries)
    np.testing.assert_allclose(res.u @ res.u.T, np.eye(4), atol=1e-6)
    if estimator == "exact":
        tr = TRowNorm(X, TK, estimator="exact", seed=0, device="cpu")
        jr = JRowNorm(X, JK, estimator="exact", seed=0)
        np.testing.assert_allclose(tr.row_norms_sq, jr.row_norms_sq,
                                   rtol=RTOL)
        stat, crit = _chi2_law(tr.sample(2000),
                               np.asarray(jr.row_norms_sq, np.float64))
        assert stat < crit, (stat, crit)
