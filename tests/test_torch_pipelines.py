"""The paper's two experiments on the port against the JAX reference:
``spectral_sparsify`` (Alg 5.1, exact level-1 reads) and ``fkv_lowrank``
(Alg 5.15, exact row norms).

The reference's CPU path draws blocks by inverse CDF and the port by
Gumbel-max, both exact samplers of the same law, so the drawn edges are
compared statistically (``tests/stats.py``, pinned seeds).  Everything
deterministic -- degrees, row norms, row indices, eval counters -- is
compared directly.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.core.kde.base import ExactBlockKDE as JExactBlockKDE
from repro.core.kernels_fn import gaussian as jgaussian
from repro.core.kernels_fn import laplacian as jlaplacian
from repro.core.lowrank import fit_left_factor as jfit_left_factor
from repro.core.lowrank import fkv_lowrank as jfkv
from repro.core.sampling.rownorm import RowNormSampler as JRowNormSampler
from repro.core.sampling.vertex import DegreeSampler as JDegreeSampler
from repro.core.sparsify import spectral_sparsify as jsparsify
from repro_torch.core.kde.base import ExactBlockKDE
from repro_torch.core.kernels_fn import gaussian, laplacian
from repro_torch.core.lowrank import (fit_left_factor, fkv_lowrank,
                                      projection_error)
from repro_torch.core.sampling.rownorm import RowNormSampler
from repro_torch.core.sampling.vertex import DegreeSampler
from repro_torch.core.sparsify import resparsify, spectral_sparsify

RTOL = 1e-4
SP_N, SP_T, SP_BATCH, SP_BW = 40, 40960, 1024, 3.0


@pytest.fixture(scope="module")
def sparsified():
    """One exact sparsifier run on each side over the same points."""
    rng = np.random.default_rng(stats.derive_seed("torch_pipelines", "sp"))
    x = rng.normal(0, 0.5, (SP_N, 5)).astype(np.float32)
    ref = jsparsify(x, jgaussian(SP_BW), num_edges=SP_T, estimator="exact",
                    exact_blocks=True, seed=0, batch=SP_BATCH)
    port = spectral_sparsify(x, gaussian(SP_BW), num_edges=SP_T,
                             estimator="exact", exact_blocks=True, seed=0,
                             batch=SP_BATCH, device="cpu")
    k = np.asarray(jax.jit(jgaussian(SP_BW).matrix)(jnp.asarray(x)),
                   np.float64)
    return x, ref, port, k


def _pair_counts(g):
    lo = np.minimum(g.src, g.dst)
    hi = np.maximum(g.src, g.dst)
    iu = np.triu_indices(g.n, 1)
    cell = np.full((g.n, g.n), -1)
    cell[iu] = np.arange(len(iu[0]))
    return np.bincount(cell[lo, hi], minlength=len(iu[0])), iu


def test_sparsify_counters_match_reference(sparsified):
    """kernel_evals and kde_queries are functions of static shapes: equal
    to the reference's and to the analytic formula."""
    _, ref, port, _ = sparsified
    n, bs = SP_N, max(int(np.sqrt(SP_N)), 16)
    drawn = -(-SP_T // SP_BATCH) * SP_BATCH
    assert port.kernel_evals == ref.kernel_evals \
        == n * n + drawn * (n + bs + 1)
    assert port.kde_queries == ref.kde_queries == n + drawn
    assert port.num_edges == ref.num_edges == SP_T
    assert port.status == 0


def test_sparsify_weights_match_reference(sparsified):
    """With exact degrees and exact level-1 reads every weight is
    total/(2t): the weight sums match the reference's and the exact
    kernel mass sum_{u<v} k(u, v) at rtol 1e-4."""
    _, ref, port, k = sparsified
    half = (k.sum() - SP_N) / 2.0
    assert port.weight.sum() == pytest.approx(ref.weight.sum(), rel=RTOL)
    assert port.weight.sum() == pytest.approx(half, rel=RTOL)
    assert np.all(np.isfinite(port.weight)) and np.all(port.weight > 0)
    sub = resparsify(port, 500, seed=1)
    assert sub.num_edges == 500 and sub.kernel_evals == port.kernel_evals


def test_sparsify_edge_law(sparsified):
    """The drawn unordered edges follow q_e = 2 k(u, v) / sum deg: Pearson
    chi-square of the port's edges against that law (alpha 1e-3), and the
    port's and reference's edge histograms agree in TV within the alpha
    1e-3 two-sample bound (``stats.tv_tolerance``)."""
    _, ref, port, k = sparsified
    counts, iu = _pair_counts(port)
    ref_counts, _ = _pair_counts(ref)
    kk = k[iu]
    expected = SP_T * kk / kk.sum()
    assert expected.min() > 5.0
    chi2 = stats.chi2_statistic(counts, expected)
    assert chi2 < stats.chi2_critical(len(kk) - 1, alpha=1e-3), chi2
    tv = stats.tv_distance(counts, ref_counts)
    assert tv < stats.tv_tolerance(len(kk), SP_T, SP_T), tv


def test_degrees_match_reference():
    """The Algorithm 4.3 preprocessing the sparsifier runs -- degrees from
    the exact level-1 structure -- at rtol 1e-4."""
    rng = np.random.default_rng(stats.derive_seed("torch_pipelines", "deg"))
    x = rng.normal(0, 0.7, (301, 19)).astype(np.float32)
    bs = max(int(np.sqrt(301)), 16)
    ref = JDegreeSampler(JExactBlockKDE(x, jgaussian(2.0), block_size=bs))
    port = DegreeSampler(ExactBlockKDE(x, gaussian(2.0), block_size=bs,
                                       device="cpu"))
    np.testing.assert_allclose(port.degrees, ref.degrees, rtol=RTOL)
    np.testing.assert_allclose(port.degrees_device.numpy(),
                               np.asarray(ref.degrees_device), rtol=RTOL)
    assert port.total == pytest.approx(ref.total, rel=RTOL)


@pytest.fixture(scope="module")
def lowrank():
    rng = np.random.default_rng(stats.derive_seed("torch_pipelines", "lra"))
    x = np.clip(rng.normal(0.3, 0.2, (256, 19)), 0, 1).astype(np.float32)
    bw = 3.0
    ref = jfkv(x, jlaplacian(bw), rank=5, num_rows=50, estimator="exact",
               seed=0, fit_cols=40)
    port = fkv_lowrank(x, laplacian(bw), rank=5, num_rows=50,
                       estimator="exact", seed=0, fit_cols=40, device="cpu")
    k = np.asarray(jax.jit(jlaplacian(bw).matrix)(jnp.asarray(x)),
                   np.float64)
    return x, bw, ref, port, k


def test_row_norms_match_reference(lowrank):
    """Squared row norms by exact KDE over cX at rtol 1e-4, against the
    reference's and against the dense ||K_i||^2."""
    x, bw, _, _, k = lowrank
    ref = JRowNormSampler(x, jlaplacian(bw), estimator="exact", seed=0)
    port = RowNormSampler(x, laplacian(bw), estimator="exact", seed=0,
                          device="cpu")
    np.testing.assert_allclose(port.row_norms_sq, ref.row_norms_sq,
                               rtol=RTOL)
    np.testing.assert_allclose(port.row_norms_sq, (k * k).sum(1), rtol=RTOL)
    idx = np.arange(0, 256, 9)
    np.testing.assert_allclose(port.rows(idx), ref.rows(idx), rtol=RTOL,
                               atol=1e-7)
    assert port.evals == ref.evals


def test_fkv_lowrank_matches_reference(lowrank):
    """Same row indices (same float64 prefix CDF and seed), same eval and
    query counts, and the same rank-5 projection error (rtol 1e-3: the
    factors agree up to eigenvector signs and f32 rounding); the CP17 fit
    reaches the same factored error (rtol 1e-3).  The standalone CP17 fit
    (no sampler: one pairwise sweep on the given device) reads the same
    columns and returns the reference's V at rtol 1e-4 and its cost."""
    x, bw, ref, port, k = lowrank
    np.testing.assert_array_equal(port.row_indices, ref.row_indices)
    assert (port.kernel_evals, port.kde_queries) == \
        (ref.kernel_evals, ref.kde_queries)
    e_port, e_ref = projection_error(k, port.u), projection_error(k, ref.u)
    assert e_port == pytest.approx(e_ref, rel=1e-3)
    fro = np.linalg.norm(port.approx() - k, "fro")
    assert fro == pytest.approx(np.linalg.norm(ref.approx() - k, "fro"),
                                rel=1e-3)
    u = port.u.astype(np.float64)
    v, extra = fit_left_factor(x, laplacian(bw), u, num_cols=40, seed=1,
                               device="cpu")
    v_ref, extra_ref = jfit_left_factor(x, jlaplacian(bw), u, num_cols=40,
                                        seed=1)
    assert extra == extra_ref == 256 * 40 and v.shape == (256, 5)
    np.testing.assert_allclose(v, v_ref, rtol=RTOL, atol=1e-6)


def test_pipelines_reject_options_outside_the_slice():
    """``mesh=`` is ported (the mesh slice; ``tests/
    test_torch_mesh_pipelines.py`` runs every pipeline on gloo ranks): it
    takes a ``DeviceMesh``, and anything else raises TypeError."""
    x = np.zeros((20, 3), np.float32)
    with pytest.raises(TypeError, match="DeviceMesh"):
        spectral_sparsify(x, gaussian(), num_edges=10, mesh=object(),
                          device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        fkv_lowrank(x, laplacian(), rank=2, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        RowNormSampler(torch.zeros(4, 2), laplacian(), mesh=object(),
                       device="cpu")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_edge_law_rejects_wrong_draws():
    """The edge-law check ``chip_smoke.py`` runs on the card's sparsifier
    output, here on the CPU path (n = 2048, t = 10n): it passes the true
    draws and fails two corruptions that keep every weight, and so the
    weight sum, unchanged -- each destination moved to the same offset in
    the next level-1 block (caught in index order), and each destination
    redrawn in its own block from k(u, .)^0.8 (caught in value order)."""
    cs = _chip_smoke()
    n = 2048
    rng = np.random.default_rng(stats.derive_seed("torch_pipelines", "law"))
    x = rng.normal(0, 0.25, (n, 16)).astype(np.float32)
    x[rng.random(n) < 0.5] += 1.0
    g = spectral_sparsify(x, gaussian(cs.SP_BW), num_edges=10 * n,
                          estimator="exact", exact_blocks=True, seed=0,
                          batch=cs.BATCH, device="cpu")
    tx, bn = torch.as_tensor(x), max(int(np.sqrt(n)), 16)
    data = dict(sp_x=tx, sp_bs=bn)
    deg = cs.exact_degrees(tx, 1.0 / cs.SP_BW)
    cs.edge_law(data, g, deg)

    shifted = dataclasses.replace(g, dst=(g.dst + bn) % n)
    with pytest.raises(AssertionError, match="index order"):
        cs.edge_law(data, shifted, deg)

    u, v = torch.as_tensor(g.src), torch.as_tensor(g.dst)
    cols = (v // bn * bn)[:, None] + torch.arange(bn)
    live = (cols < n) & (cols != u[:, None])
    cols = cols.clamp(max=n - 1)
    kv = torch.exp(-((tx[u][:, None, :] - tx[cols]) ** 2).sum(-1)
                   / cs.SP_BW ** 2)
    kv = torch.where(live, kv ** 0.8, 0.0)
    gen = torch.Generator().manual_seed(0)
    pick = torch.multinomial(kv, 1, generator=gen)[:, 0]
    flat = dataclasses.replace(g, dst=cols[torch.arange(len(u)), pick].numpy())
    with pytest.raises(AssertionError, match="value order"):
        cs.edge_law(data, flat, deg)
