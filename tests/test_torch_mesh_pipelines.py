"""The mesh pipelines, the draw's law, streaming and serving on
``torch.distributed``: the mirror of ``tests/test_distributed.py`` lines
203-337 and of the reference's streaming / serving mesh contracts.

Spawned gloo ranks (``torch_mesh_ranks``, no JAX in the ranks) run the
port on ``"cpu"`` meshes:

* ``pipelines`` (8 ranks): the KS test of ``tests/test_distributed.py:203``
  (n = 512, m = 4096, ``stats.ks_critical`` at alpha 1e-4) for the mesh
  sampler against k(u, .) / deg(u) and against the flat sampler, and every
  ``mesh=`` pipeline at the reference test's sizes: the eval counters
  equal the port's single-device counters and the reference's exactly,
  the accuracy stays inside the reference test's envelopes;
* ``streaming`` (4 ranks): ``patch_rows`` on both engines (zero
  collectives), then reads equal to a fresh build on the mutated data
  (queries and draws bitwise, hashed estimates at rtol 2e-5, patched
  degrees rtol 5e-4 and ``prob_of`` rtol 2e-5: PERF.md section 2's
  streaming limits); ``StreamingKernelGraph(mesh=)``; a mesh serving
  tenant whose groups are one all-reduce each and equal the engine's call
  on the concatenated frontier.

The reference side (its single-device pipelines' counters) runs in this
process while the ranks work.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
import torch_mesh_ranks as ranks

jax.config.update("jax_platforms", "cpu")


def _reference_counters(x):
    """The reference's single-device counters of the pipelines the ranks
    run (its mesh pipelines fail on this tree's JAX)."""
    from repro.core.eigen import top_eigenvalue
    from repro.core.graph.arboricity import estimate_arboricity
    from repro.core.graph.triangles import estimate_triangle_weight
    from repro.core.kernels_fn import gaussian
    from repro.core.lowrank import fkv_lowrank
    from repro.core.sparsify import spectral_sparsify
    from repro.core.spectrum import approximate_spectrum
    ker = gaussian(2.0)
    g = spectral_sparsify(x, ker, 3000, estimator="exact", exact_blocks=True,
                          seed=0)
    return {
        "sparsify": (g.kernel_evals, g.kde_queries),
        "sparsify_strat": spectral_sparsify(x, ker, 3000,
                                            seed=0).kernel_evals,
        "arboricity": estimate_arboricity(x, ker, 4000, estimator="exact",
                                          seed=0).kernel_evals,
        "triangles": estimate_triangle_weight(x, ker, 300, 16,
                                              estimator="exact",
                                              seed=0).kernel_evals,
        "lowrank": fkv_lowrank(x, ker, rank=6, num_rows=120,
                               seed=0).kernel_evals,
        "eigen": top_eigenvalue(x, ker, t=150, method="noisy_power",
                                seed=0).kernel_evals,
        "spectrum": approximate_spectrum(x, ker, length=5, num_sources=6,
                                         walks_per_source=8,
                                         seed=0).kernel_evals,
    }


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    data_seed = stats.derive_seed("distributed", "ks", "data")
    rng = np.random.default_rng(data_seed)
    x_ks = rng.normal(0, 0.5, (512, 6)).astype(np.float32)
    x = np.random.default_rng(0).normal(0, 0.35, (300, 5)).astype(
        np.float32)
    pl = dict(x_ks=x_ks, u0=17, x=x,
              engine_seed=stats.derive_seed("distributed", "ks", "engine"))
    wait = ranks.spawn_async("pipelines", 8,
                             tmp_path_factory.mktemp("meshp"), pl)
    ref = _reference_counters(x)
    return pl, wait(), ref


def test_mesh_draw_law_ks(pipeline_run):
    """The two-stage collective draw samples k(u, .) / deg(u): one-sample
    KS for the mesh and the flat sampler, and a two-sample KS between
    them, at ``stats.ks_critical(4096, alpha=1e-4)`` (the reference
    test's thresholds, its seeds)."""
    from repro.core.kernels_fn import gaussian
    pl, res, _ = pipeline_run
    n, m, u0 = 512, 4096, pl["u0"]
    k = np.asarray(gaussian(1.0).matrix(jnp.asarray(pl["x_ks"])), np.float64)
    p = k[u0].copy()
    p[u0] = 0.0
    p /= p.sum()
    cdf = np.cumsum(p)

    def ecdf_d(samples):
        counts = np.bincount(samples, minlength=n)
        return np.abs(np.cumsum(counts) / len(samples) - cdf).max()

    crit1 = stats.ks_critical(m, alpha=1e-4)
    crit2 = stats.ks_critical(m, m, alpha=1e-4)
    nb_s, nb_1 = res[0]["ks_mesh"], res[0]["ks_flat"]
    assert ecdf_d(nb_s) < crit1 and ecdf_d(nb_1) < crit1
    c_s, c_1 = (np.bincount(a, minlength=n) for a in (nb_s, nb_1))
    d2 = np.abs(np.cumsum(c_s) / m - np.cumsum(c_1) / m).max()
    assert d2 < crit2, d2
    for r in res[1:]:
        np.testing.assert_array_equal(r["ks_mesh"], nb_s)


@pytest.mark.parametrize("name", ["sparsify", "sparsify_strat", "arboricity",
                                  "triangles", "lowrank", "eigen",
                                  "spectrum", "cluster"])
def test_mesh_pipeline_counters_and_accuracy(pipeline_run, name):
    """Each ``mesh=`` pipeline on 8 ranks: eval counters equal to the
    port's single-device counters and the reference's exactly, the same
    replicated result on every rank, and the reference test's accuracy
    envelope (sparsifier Laplacian error < 0.5, arboricity within 15% and
    triangles within 30% of exact, the FKV projection error within 0.02
    ||K||_F^2 of optimal, the noisy eigenvalue within 1e-3 of the flat
    one)."""
    from repro_torch.core.graph.arboricity import exact_arboricity
    from repro_torch.core.graph.triangles import exact_triangle_weight
    from repro_torch.core.kernels_fn import gaussian as tgaussian
    from repro_torch.core.lowrank import optimal_error, projection_error
    pl, res, ref = pipeline_run
    mesh, flat = res[0][f"mesh_{name}"], res[0][f"flat_{name}"]
    assert mesh["evals"] == flat["evals"]
    if name == "sparsify":
        assert (mesh["evals"], mesh["kde_queries"]) == ref[name] \
            == (flat["evals"], flat["kde_queries"])
    elif name in ref:
        assert mesh["evals"] == ref[name]
    for r in res[1:]:
        for k, v in r[f"mesh_{name}"].items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(mesh[k]))
    x = pl["x"]
    ker = tgaussian(2.0)
    kmat = ker.matrix(torch.as_tensor(x)).numpy().astype(np.float64)
    if name == "sparsify":
        n = len(x)
        a = np.zeros((n, n))
        np.add.at(a, (mesh["src"], mesh["dst"]), mesh["weight"])
        np.add.at(a, (mesh["dst"], mesh["src"]), mesh["weight"])
        lap = np.diag(a.sum(1)) - a
        lt = np.diag(kmat.sum(1) - 1) - (kmat - np.eye(n))
        assert np.linalg.norm(lap - lt) / np.linalg.norm(lt) < 0.5
        assert mesh["status"] == 0
    elif name == "arboricity":
        tr = exact_arboricity(ker, x, device="cpu")
        assert abs(mesh["density"] - tr) / tr < 0.15
    elif name == "triangles":
        tt = exact_triangle_weight(ker, x, device="cpu")
        assert abs(mesh["total"] - tt) / tt < 0.3
    elif name == "lowrank":
        assert projection_error(kmat, mesh["u"]) < optimal_error(kmat, 6) \
            + 0.02 * np.linalg.norm(kmat) ** 2
    elif name == "eigen":
        assert abs(mesh["eigenvalue"] - flat["eigenvalue"]) \
            / abs(flat["eigenvalue"]) < 1e-3


@pytest.fixture(scope="module")
def stream_run(tmp_path_factory):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 0.6, (240, 5)).astype(np.float32)
    slots = np.array([3, 70, 130, 199])
    x_mut = x.copy()
    x_mut[slots] = x[[10, 65, 150, 181]]     # each a row of its own shard
    src = rng.integers(0, 240, 64)
    pl = dict(x=x, x_mut=x_mut, slots=slots, src=src, capacity=256,
              y=np.concatenate([x[:6] + 0.01, x_mut[slots]]),
              dead=np.array([20, 100]),
              new_rows=rng.normal(0, 0.6, (3, 5)).astype(np.float32))
    return pl, ranks.spawn("streaming", 4, tmp_path_factory.mktemp("meshs"),
                           pl)


def test_patch_rows_then_reads_equal_a_fresh_build(stream_run):
    """``ShardedBlocks.patch_rows`` and ``ShardedHashTable.patch_rows``
    realize no collective; afterwards the block engine's query and draw
    equal a fresh build's bitwise, and the hash table (moves within their
    shard's cells: spliced, no overflow) its NEAR counts bitwise and its
    estimates at rtol 2e-5."""
    _, res = stream_run
    r0 = res[0]
    for k in ("blocks_patch_cc", "hash_patch_cc"):
        assert sum(v for kk, v in r0[k].items()
                   if not kk.endswith("total")) == 0, r0[k]
    for a, b in zip(r0["blocks_patched"], r0["blocks_fresh"]):
        np.testing.assert_array_equal(a, b)
    (est, cnt, fill), (fest, fcnt) = r0["hash_patched"], r0["hash_fresh"]
    assert fill == 0
    np.testing.assert_array_equal(cnt, fcnt)
    np.testing.assert_allclose(est, fest, rtol=2e-5, atol=1e-9)
    for r in res[1:]:
        for k in ("blocks_patched", "hash_patched"):
            for a, b in zip(r[k], r0[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_streaming_mesh_sampler_and_graph(stream_run):
    """A mesh ``NeighborSampler`` + ``DegreeSampler`` on a
    ``DynamicDataset`` (updates, deletes, inserts): the patched degrees
    (``degree_delta``) within rtol 5e-4 of a fresh build's, ``prob_of``
    within rtol 2e-5, dead slots at degree 0; ``StreamingKernelGraph(
    mesh=)`` draws finite edges with one all-reduce a batch."""
    pl, res = stream_run
    (deg, prob, ins), (fdeg, fprob) = (res[0]["stream_patched"],
                                      res[0]["stream_fresh"])
    assert list(ins) == [240, 241, 242]
    live = deg > 0
    assert not live[pl["dead"]].any() and live[ins].all()
    np.testing.assert_allclose(deg, fdeg, rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(prob, fprob, rtol=2e-5, atol=1e-9)
    u, v, w, psums, flags = res[0]["skg"]
    assert len(u) == 256 and np.isfinite(w).all() and (w > 0).all()
    assert psums == 2 and flags == []
    for r in res[1:]:
        np.testing.assert_array_equal(r["skg"][0], u)


def test_mesh_serving_tenant(stream_run):
    """A mesh tenant's tick: the sample, prob_of and query groups are one
    all-reduce each, the two 3-step walks one a step (9 in all, no
    exchange), no request fails, and the sample group equals the engine's
    ``fused_sample`` on the concatenated frontier with the group's noise
    bitwise."""
    pl, res = stream_run
    r0 = res[0]
    assert r0["serve_errors"] == []
    cc = r0["serve_cc"]
    assert (cc["psum_total"], cc["ppermute_total"]) == (9, 0), cc
    nb, prob = r0["serve_replay"]
    got = r0["serve"]["sample"]
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]), nb)
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got]), prob)
    for p in r0["serve"]["prob_of"]:
        assert np.isfinite(p).all() and (p > 0).all()
    est = np.concatenate(r0["serve"]["query"])
    assert est.shape == (len(pl["y"]),) and (est > 1.0).all()
    for r in res[1:]:
        np.testing.assert_array_equal(
            np.concatenate([g[0] for g in r["serve"]["sample"]]), nb)
