"""The Table-1 graph applications of the port -- local clustering,
weighted triangles, arboricity, spectrum, top eigenvalue, the Laplacian
solve and spectral clustering -- against the JAX reference on the CPU.

The device programs behind them (``triangle_edge_scan``,
``noisy_power_scan``, ``laplacian_matvec``, ``laplacian_cg``,
``signed_endpoint_stat``) are fed the reference's noise, derived from its
keys with its own splits: the triangle scan reads level 1 with
``keys[0]`` and draws neighbor i with ``k_blk, k_in = split(keys[i])``;
the noisy power method's iteration i draws ``uniform(keys[i],
(num_samples,))``.  The public entry points draw from torch generators,
so they are held to the reference's analytic eval counters exactly and
to the dense oracles statistically; the host parts the reference computes
in numpy (Poisson walk counts, uniform pairs, the support, k-means, the
greedy peel, moment inversion) are the same numbers on both sides.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.core.cluster import local as jlocal
from repro.core.cluster import spectral as jspectral
from repro.core import eigen as jeigen
from repro.core.graph import arboricity as jarb
from repro.core.graph import triangles as jtri
from repro.core import laplacian as jlap
from repro.core import spectrum as jspec
from repro.core.kernels_fn import gaussian as jgaussian
from repro.core.sparsify import spectral_sparsify as jsparsify
from repro.data.synthetic_points import gaussian_clusters
from repro.kernels.kde_hash import ops as jhops
from repro.kernels.kde_sampler import ops as jops
from repro.kernels.kde_sampler import ref as jref
import repro_torch.core as tcore
from repro_torch.convert import hash_state_from_reference
from repro_torch.core.cluster import local as tlocal
from repro_torch.core.cluster import spectral as tspectral
from repro_torch.core import eigen as teigen
from repro_torch.core.graph import arboricity as tarb
from repro_torch.core.graph import triangles as ttri
from repro_torch.core import spectrum as tspec
from repro_torch.core.kernels_fn import gaussian
from repro_torch.core.sparsify import SparseGraph
from repro_torch.ft import guards as tguards
from repro_torch.kernels.kde_sampler import ops as tops
from repro_torch.kernels.kde_sampler import ref as tref

# ``repro_torch.core.laplacian`` is the kernel function (the package's
# public name), so the submodule is taken from the import system
tlap = importlib.import_module("repro_torch.core.laplacian")


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.fixture(scope="module")
def cloud():
    """The reference's ``cloud`` fixture (tests/test_fused_apps.py)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.35, (300, 5)).astype(np.float32)
    k = np.asarray(jgaussian(2.0).matrix(jnp.asarray(x)), np.float64)
    return x, k


@pytest.fixture(scope="module")
def clustered():
    """The reference's ``clustered`` fixture: two clusters, n = 400."""
    x, lab = gaussian_clusters(n=400, d=4, k=2, spread=0.3, sep=1.2, seed=3)
    return x, lab


@pytest.fixture(scope="module")
def sparsifier(cloud):
    """A reference sparsifier of the cloud (the same edge list feeds both
    packages' solvers)."""
    x, _ = cloud
    return jsparsify(x, jgaussian(2.0), num_edges=12000, estimator="exact",
                     exact_blocks=True, seed=0)


def _graph(g):
    return SparseGraph(g.n, g.src, g.dst, g.weight)


# --------------------------------------------------------------------- #
# the device programs against the reference's, on its noise
# --------------------------------------------------------------------- #
#: level-1 read of the triangle scan: (exact, level1)
TRI_READS = {"exact": (True, "blocked"), "stratified": (False, "blocked"),
             "hash": (False, "hash")}


@pytest.mark.parametrize("read", sorted(TRI_READS))
def test_triangle_edge_scan_matches_reference(cloud, read):
    """Oriented pairs bitwise and weights at rtol 2e-4 (the reference's
    own tolerance, tests/test_fused_apps.py), counter words equal: on the
    exact read against ``ref.triangle_batch_ref`` and the reference's
    program (and the port's oracle), on the stratified and hashed reads
    against the reference's program."""
    x, k = cloud
    exact, level1 = TRI_READS[read]
    n, bs, s, nf, m, draws = 300, 32, 8, 2, 64, 8
    nb = -(-n // bs)
    xj = jnp.asarray(x)
    x_sq = jnp.sum(xj * xj, axis=-1)
    deg = (k.sum(1) - 1.0).astype(np.float32)
    rng = np.random.default_rng(2)
    u = rng.integers(0, n, m)
    v = (rng.integers(0, n - 1, m) + 1 + np.arange(m)) % n
    v = np.where(v == u, (v + 1) % n, v)
    keys = jax.random.split(jax.random.PRNGKey(9), draws + 1)
    jstate = tstate = None
    if level1 == "hash":
        jstate, _ = jhops.build_hash_state(x, jgaussian(2.0), max_bucket=32,
                                           seed=11)
        tstate = hash_state_from_reference(jstate, device="cpu")
    cfg = dict(kind="gaussian", inv_bw=0.5, beta=1.0, block_size=bs,
               num_blocks=nb, n=n, s=s, exact=exact, level1=level1,
               num_far=nf)
    ju, jv, jw, jword = jops.triangle_edge_scan(
        xj, x_sq, jnp.asarray(u, jnp.int32), jnp.asarray(v, jnp.int32),
        jnp.asarray(deg), keys, jstate, pairwise=None, use_pallas=False,
        interpret=False, bm=128, **cfg)
    if level1 == "hash":
        l1 = _t(jax.random.randint(keys[0], (m, nb, nf), 0, bs),
                torch.int64)
    elif not exact:
        l1 = _t(jax.random.uniform(keys[0], (nb, bs)))
    else:
        l1 = None
    pairs = [jax.random.split(kk) for kk in keys[1:]]
    u_blk = torch.stack([_t(jax.random.uniform(a, (m,))) for a, _ in pairs])
    u_in = torch.stack([_t(jax.random.uniform(b, (m,))) for _, b in pairs])
    tx = torch.as_tensor(x)
    tu, tv = torch.as_tensor(u), torch.as_tensor(v)
    uu, vv, w_hat, word = tops.triangle_edge_scan(
        tx, (tx * tx).sum(-1), tu, tv, torch.as_tensor(deg),
        (l1, u_blk, u_in), tstate, **cfg)
    want = [(ju, jv, jw)]
    if exact:
        want.append(jref.triangle_batch_ref(
            xj, x_sq, jnp.asarray(u, jnp.int32), jnp.asarray(v, jnp.int32),
            jnp.asarray(deg), keys, "gaussian", 0.5, 1.0, bs, n))
        want.append(tref.triangle_batch_ref(
            tx, (tx * tx).sum(-1), tu, tv, torch.as_tensor(deg), u_blk,
            u_in, "gaussian", 0.5, 1.0, bs, n))
    for wu, wv, ww in want:
        np.testing.assert_array_equal(uu.numpy(), np.asarray(wu))
        np.testing.assert_array_equal(vv.numpy(), np.asarray(wv))
        np.testing.assert_allclose(w_hat.numpy(), np.asarray(ww), rtol=2e-4,
                                   atol=1e-7)
    np.testing.assert_array_equal(word.numpy(),
                                  np.asarray(jword).astype(np.int64))


def test_noisy_power_scan_matches_reference(cloud):
    """The noisy power method fed the reference's uniforms: the vector and
    the eigenvalue at rtol 1e-4, a clean status, and the same word."""
    _, k = cloud
    t, ns, iters = 96, 48, 10
    ksub = jnp.asarray(k[:t, :t], jnp.float32)
    v0 = jax.random.normal(jax.random.PRNGKey(5), (t,), jnp.float32)
    v0 = v0 / jnp.linalg.norm(v0)
    keys = jax.random.split(jax.random.PRNGKey(6), iters)
    lam, v, word = jops.noisy_power_scan(ksub, v0, keys, num_samples=ns)
    us = torch.stack([_t(jax.random.uniform(kk, (ns,))) for kk in keys])
    tlam, tv, tword = tops.noisy_power_scan(_t(ksub), _t(v0), us,
                                            num_samples=ns)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(float(tlam), float(lam), rtol=1e-4)
    np.testing.assert_array_equal(tword.numpy(),
                                  np.asarray(word).astype(np.int64))
    assert int(tword[0]) == 0
    rlam, rv = tref.noisy_power_ref(_t(ksub), _t(v0), us)
    np.testing.assert_array_equal(rv.numpy(), tv.numpy())
    with pytest.raises(ValueError, match="us must be"):
        tops.noisy_power_scan(_t(ksub), _t(v0), us, num_samples=ns + 1)


def test_laplacian_matvec_matches_reference(sparsifier):
    """L p over the COO edge list at rtol 1e-5 against the reference's
    program and ``SparseGraph.matvec`` (float64)."""
    g = sparsifier
    p = np.random.default_rng(3).standard_normal(g.n).astype(np.float32)
    want = jops.laplacian_matvec(
        jnp.asarray(g.src, jnp.int32), jnp.asarray(g.dst, jnp.int32),
        jnp.asarray(g.weight, jnp.float32), jnp.asarray(p), n=g.n)
    got = tops.laplacian_matvec(torch.as_tensor(g.src),
                                torch.as_tensor(g.dst),
                                _t(g.weight, torch.float32), _t(p), n=g.n)
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy(), _graph(g).matvec(
        p.astype(np.float64)), rtol=1e-4, atol=1e-4 * scale)


def _cg(g, b, tol, check_every, monkeypatch, iters=400):
    """The port's CG, reading ``done`` every ``check_every`` iterations,
    and the reference's on the same edge list."""
    monkeypatch.setattr(tops, "_CG_CHECK_EVERY", check_every)
    args = (jnp.asarray(g.src, jnp.int32), jnp.asarray(g.dst, jnp.int32),
            jnp.asarray(g.weight, jnp.float32), jnp.asarray(b, jnp.float32))
    sol, res, word = jops.laplacian_cg(*args, jnp.float32(tol), n=g.n,
                                       iters=iters)
    got = tops.laplacian_cg(
        torch.as_tensor(g.src), torch.as_tensor(g.dst),
        _t(g.weight, torch.float32), _t(b, torch.float32), tol, n=g.n,
        iters=iters)
    return got, (np.asarray(sol), float(res),
                 np.asarray(word).astype(np.int64))


def _rhs(n):
    b = np.random.default_rng(1).standard_normal(n)
    return b - b.mean()


@pytest.mark.parametrize("check_every", [1, 3, 8, 1000])
@pytest.mark.parametrize("tol", [1e-3, 1e-5])
def test_laplacian_cg_matches_reference(sparsifier, check_every, tol,
                                       monkeypatch):
    """The device CG against the reference's ``lax.while_loop`` program,
    stopping on the tolerance: the solution at rtol 1e-4, the residual,
    the iteration count and the status equal, whichever the host's
    reading period of ``done`` (the frozen iterations change nothing)."""
    g = sparsifier
    b = _rhs(g.n)
    (tsol, tres, tword), (sol, res, word) = _cg(g, b, tol, check_every,
                                                monkeypatch)
    assert int(tword[3]) == int(word[3]) < 400
    assert int(tword[0]) == int(word[0]) == 0
    scale = np.abs(sol).max()
    np.testing.assert_allclose(tsol.numpy(), sol, rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(float(tres), res, rtol=1e-3)


@pytest.mark.parametrize("check_every", [3, 8, 1000])
def test_laplacian_cg_plateau(sparsifier, check_every, monkeypatch):
    """At tol 1e-10 both loops stop on the f32 plateau (residual ~1e-7
    |b|, CG_NO_CONVERGE flagged): which iteration first sees
    non-positive curvature there depends on the order of the f32 sums,
    so the count is held to the port's own count with a read every
    iteration (the same arithmetic: equal bitwise) and the solution to the
    reference's at rtol 1e-4."""
    g = sparsifier
    b = _rhs(g.n)
    (tsol, tres, tword), (sol, _, word) = _cg(g, b, 1e-10, check_every,
                                              monkeypatch)
    (esol, eres, eword), _ = _cg(g, b, 1e-10, 1, monkeypatch)
    np.testing.assert_array_equal(tword.numpy(), eword.numpy())
    np.testing.assert_array_equal(tsol.numpy(), esol.numpy())
    assert float(tres) == float(eres) < 1e-6 * np.linalg.norm(b)
    assert int(tword[0]) == int(word[0]) == tguards.CG_NO_CONVERGE
    scale = np.abs(sol).max()
    np.testing.assert_allclose(tsol.numpy(), sol, rtol=1e-4,
                               atol=1e-4 * scale)


def test_signed_endpoint_stat_is_exact():
    """The collision statistic equals the numpy bincount oracle exactly
    (sums of +-1 are exact in f32), and the reference's program."""
    rng = np.random.default_rng(0)
    n = 120
    ends = rng.integers(0, n, size=5000)
    signs = np.where(rng.uniform(size=5000) < 0.5, 1.0, -1.0)
    got, word = tops.signed_endpoint_stat(
        torch.as_tensor(ends), _t(signs, torch.float32), n=n)
    c = np.zeros(n)
    np.add.at(c, ends, signs)
    assert float(got) == float((c * c).sum())
    want, jword = jops.signed_endpoint_stat(
        jnp.asarray(ends, jnp.int32), jnp.asarray(signs, jnp.float32), n=n)
    assert float(got) == float(want)
    np.testing.assert_array_equal(word.numpy(),
                                  np.asarray(jword).astype(np.int64))


# --------------------------------------------------------------------- #
# the public API: counters, decisions and oracles
# --------------------------------------------------------------------- #
def _cluster_cases(lab):
    i0, i1 = np.where(lab == 0)[0], np.where(lab == 1)[0]
    return [(int(i0[0]), int(i0[5]), True), (int(i1[1]), int(i1[7]), True),
            (int(i0[0]), int(i1[0]), False), (int(i0[3]), int(i1[2]), False)]


@pytest.mark.parametrize("case", range(4))
def test_same_cluster_test_decisions_and_counters(clustered, case):
    """The reference's four pairs (tests/test_fused_apps.py): the same
    decision, and ``kernel_evals`` = 6 walks (n + bs), the reference's
    own count."""
    x, lab = clustered
    n = x.shape[0]
    u, w, want_same = _cluster_cases(lab)[case]
    nb = tcore.NeighborSampler(x, gaussian(1.0), exact_blocks=True,
                               seed=case, device="cpu")
    res = tlocal.same_cluster_test(x, gaussian(1.0), u, w, walk_length=6,
                                   num_walks=400, sampler=nb, seed=case)
    assert res.same_cluster == want_same, (u, w, res.statistic)
    ref = jlocal.same_cluster_test(x, jgaussian(1.0), u, w, walk_length=6,
                                   num_walks=400, seed=case)
    assert res.kernel_evals == ref.kernel_evals
    rng = np.random.default_rng(case)
    walks = max(int(rng.poisson(400)), 1) + max(int(rng.poisson(400)), 1)
    assert res.kernel_evals == 6 * walks * (n + nb.block_size)
    assert nb.device_counters["evals"] == nb.evals


def test_l2_distance_statistic_is_the_references():
    rng = np.random.default_rng(4)
    a, b = rng.poisson(3.0, 50), rng.poisson(3.5, 50)
    assert tlocal.l2_distance_statistic(a, b, 150, 170) == \
        jlocal.l2_distance_statistic(a, b, 150, 170)


@pytest.mark.parametrize("estimator", ["exact", "stratified", "hash"])
def test_triangle_weight_counters_and_accuracy(clustered, estimator):
    """``kernel_evals`` equals the reference's for the same call, and the
    reference's formula on the exact and stratified reads
    (tests/test_fused_apps.py); the exact-read estimate within 20% of the
    dense oracle, as the reference's test holds it."""
    x, _ = clustered
    n, m, ns = x.shape[0], 400, 24
    res = ttri.estimate_triangle_weight(x, gaussian(1.0), m, ns,
                                        estimator=estimator, seed=0,
                                        device="cpu")
    ref = jtri.estimate_triangle_weight(x, jgaussian(1.0), m, ns,
                                        estimator=estimator, seed=0)
    assert res.kernel_evals == ref.kernel_evals
    bs = max(int(np.sqrt(n)), 16)
    nb = -(-n // bs)
    if estimator == "exact":
        assert res.kernel_evals == n * n + m * (n + 1) + ns * m * (bs + 1)
        truth = ttri.exact_triangle_weight(gaussian(1.0), x, device="cpu")
        assert abs(res.total_weight - truth) / truth < 0.2
    elif estimator == "stratified":
        assert res.kernel_evals == (n * nb * 16 + m * (nb * 16 + 1)
                                    + ns * m * (bs + 1))


@pytest.mark.parametrize("estimator", ["exact", "stratified"])
def test_arboricity_counters_and_accuracy(clustered, estimator):
    """``kernel_evals`` equals the reference's for the same call (and its
    formula on the exact read), and the exact-read density within 10% of
    the greedy oracle, as the reference's test holds it."""
    x, _ = clustered
    n, m, batch = x.shape[0], 8000, 512
    res = tarb.estimate_arboricity(x, gaussian(1.0), m, estimator=estimator,
                                   seed=0, batch=batch, device="cpu")
    ref = jarb.estimate_arboricity(x, jgaussian(1.0), m, estimator=estimator,
                                   seed=0, batch=batch)
    assert res.kernel_evals == ref.kernel_evals
    assert res.graph.num_edges == m
    if estimator == "exact":
        drawn = -(-m // batch) * batch
        bs = max(int(np.sqrt(n)), 16)
        assert res.kernel_evals == n * n + drawn * (n + bs + 1)
        truth = tarb.exact_arboricity(gaussian(1.0), x, device="cpu")
        assert abs(res.density - truth) / truth < 0.1


def test_spectrum_counters_and_moments(cloud):
    """``approximate_spectrum``'s count is the reference's (one walk of
    all sources), its moments are return frequencies, and the inversion
    and EMD are the reference's functions of them."""
    x, _ = cloud
    n = x.shape[0]
    length, srcs, wps = 6, 8, 16
    sp = tspec.approximate_spectrum(x, gaussian(2.0), length=length,
                                    num_sources=srcs, walks_per_source=wps,
                                    seed=0, device="cpu")
    ref = jspec.approximate_spectrum(x, jgaussian(2.0), length=length,
                                     num_sources=srcs, walks_per_source=wps,
                                     seed=0)
    assert sp.kernel_evals == ref.kernel_evals == \
        length * srcs * wps * (n + max(int(np.sqrt(n)), 16))
    assert sp.moments.shape == (length,)
    assert np.all((sp.moments >= 0) & (sp.moments <= 1))
    np.testing.assert_array_equal(tspec.invert_moments(ref.moments, n),
                                  ref.eigenvalues)
    exact = tspec.exact_spectrum(gaussian(2.0), x, device="cpu")
    np.testing.assert_allclose(exact, jspec.exact_spectrum(jgaussian(2.0), x),
                               atol=1e-5)
    assert tspec.emd_1d(sp.eigenvalues, exact) == pytest.approx(
        jspec.emd_1d(sp.eigenvalues, exact))


@pytest.mark.parametrize("method", ["power", "noisy_power"])
def test_top_eigenvalue_counters_and_bound(cloud, method):
    """Lemma 5.21: |n/t lambda_1(K_S) - lambda_1(K)| <= 2 n / sqrt(t), as
    the reference's test holds it; the counters are the reference's; the
    power method takes the reference's support and start vector (the
    same rng), so its eigenvalue matches at rtol 1e-5."""
    x, _ = cloud
    n, t, eps = 300, 150, 0.25
    truth = teigen.top_eigenvalue_exact(gaussian(2.0), x, device="cpu")
    assert truth == pytest.approx(jeigen.top_eigenvalue_exact(
        jgaussian(2.0), x), rel=1e-5)
    res = teigen.top_eigenvalue(x, gaussian(2.0), t=t, eps=eps,
                                method=method, seed=0, device="cpu")
    ref = jeigen.top_eigenvalue(x, jgaussian(2.0), t=t, eps=eps,
                                method=method, seed=0)
    assert abs(res.eigenvalue - truth) <= 2.0 * n / np.sqrt(t)
    assert res.kernel_evals == ref.kernel_evals == t * t
    assert res.matvec_sampled_evals == ref.matvec_sampled_evals
    np.testing.assert_array_equal(res.support, ref.support)
    if method == "power":
        assert res.eigenvalue == pytest.approx(ref.eigenvalue, rel=1e-5)


def test_laplacian_solve_and_dense_oracles(cloud, sparsifier):
    """``cg_laplacian`` on the reference's sparsifier: its residual under
    1e-4 |b| and the solution within 1e-3 of the dense pseudoinverse
    solve (the reference's test); the dense Laplacians equal the
    reference's; ``solve_kernel_laplacian`` end to end."""
    x, _ = cloud
    g = _graph(sparsifier)
    b = np.random.default_rng(1).standard_normal(g.n)
    b -= b.mean()
    sol, res = tlap.cg_laplacian(g, b, iters=400, device="cpu")
    assert res < 1e-4 * np.linalg.norm(b)
    direct = np.linalg.lstsq(g.laplacian_dense(), b, rcond=None)[0]
    direct -= direct.mean()
    assert np.linalg.norm(sol - direct) / np.linalg.norm(direct) < 1e-3
    for name in ("laplacian_dense", "normalized_laplacian_dense"):
        np.testing.assert_allclose(
            getattr(tlap, name)(gaussian(2.0), x, device="cpu"),
            getattr(jlap, name)(jgaussian(2.0), x), atol=1e-6)
    np.testing.assert_array_equal(tlap.project_ones(b), jlap.project_ones(b))
    sol2, g2 = tlap.solve_kernel_laplacian(x, gaussian(2.0), b, 4000,
                                           device="cpu")
    lap = g2.laplacian_dense()
    assert np.linalg.norm(lap @ sol2 - b) < 1e-2 * np.linalg.norm(b)


def test_spectral_cluster_is_the_references(clustered):
    """On the same sparsifier, ``spectral_cluster`` gives the reference's
    labels, embedding and eigenvalues (host numpy on both sides), and
    clusters the two-cluster mixture perfectly."""
    x, lab = clustered
    g = jsparsify(x, jgaussian(1.0), num_edges=10 * len(x), seed=0)
    res = tspectral.spectral_cluster(_graph(g), 2, seed=0)
    ref = jspectral.spectral_cluster(g, 2, seed=0)
    np.testing.assert_array_equal(res.labels, ref.labels)
    np.testing.assert_array_equal(res.embedding, ref.embedding)
    np.testing.assert_array_equal(res.eigenvalues, ref.eigenvalues)
    assert tspectral.cluster_accuracy(res.labels, lab, 2) == 1.0
    pts = np.random.default_rng(2).normal(size=(90, 3))
    np.testing.assert_array_equal(tspectral.kmeans(pts, 3, seed=1)[0],
                                  jspectral.kmeans(pts, 3, seed=1)[0])


def test_oracles_match_reference(clustered):
    """The dense oracles of triangles and arboricity (and the greedy peel
    they share) equal the reference's: the triangle sum through an f32
    matmul within 1e-5, the peel on the same float64 weights exactly."""
    x, _ = clustered
    tri = ttri.exact_triangle_weight(gaussian(1.0), x, device="cpu")
    assert tri == pytest.approx(jtri.exact_triangle_weight(jgaussian(1.0), x),
                                rel=1e-5)
    assert tarb.exact_arboricity(gaussian(1.0), x, device="cpu") == \
        pytest.approx(jarb.exact_arboricity(jgaussian(1.0), x), rel=1e-6)
    rng = np.random.default_rng(stats.derive_seed("torch_graph_apps", "peel"))
    src, dst = rng.integers(0, 40, 300), rng.integers(0, 40, 300)
    wgt = rng.exponential(size=300)
    assert tarb.greedy_densest_subgraph(40, src, dst, wgt) == \
        jarb.greedy_densest_subgraph(40, src, dst, wgt)
