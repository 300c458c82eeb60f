"""The port's depth-2 sampling programs and samplers against the JAX
reference, with explicit noise.

JAX threefry streams cannot be reproduced in torch, so the noise is drawn
on the reference side with its own key-split discipline and handed to the
port's explicit-noise program cores.  Indices must then match exactly;
floats at rtol 1e-4 (f32 rounding of sums taken in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.core.kde.base import ExactBlockKDE as JExactBlockKDE
from repro.core.kernels_fn import gaussian as jgaussian
from repro.core.kernels_fn import laplacian as jlaplacian
from repro.core.sampling.edge import NeighborSampler as JNeighborSampler
from repro.core.sampling.vertex import PrefixCDF as JPrefixCDF
from repro.kernels.kde_sampler import ops as jops
from repro.kernels.kde_sampler import ref as jref
from repro_torch.core.kernels_fn import gaussian, laplacian
from repro_torch.core.sampling.edge import EdgeSampler, NeighborSampler
from repro_torch.core.sampling.vertex import DegreeSampler, PrefixCDF
from repro_torch.kernels.kde_sampler import ops as tops
from repro_torch.kernels.kde_sampler import ref as tref

RTOL = 1e-4
# one compiled program per oracle call instead of op-by-op dispatch
_fused_edge_batch_ref = jax.jit(jref.fused_edge_batch_ref, static_argnums=(
    7, 8, 9, 10, 11, 12, 13))
_sample_from_sums = jax.jit(jref.sample_from_sums,
                            static_argnums=(6, 7, 8, 9, 10))
_masked_exact_sums_ref = jax.jit(jref.masked_exact_sums_ref,
                                 static_argnums=(4, 5, 6, 7, 8))
_block_views = jax.jit(jref.block_views, static_argnums=2)
_inverse_cdf_index = jax.jit(jref.inverse_cdf_index)
_level2_draw = jax.jit(jref.level2_draw)
KERNELS = {"gaussian": (jgaussian, gaussian, 1.5),
           "laplacian": (jlaplacian, laplacian, 2.5)}


def _graph(kind, n=300, d=5):
    rng = np.random.default_rng(stats.derive_seed("torch_sampling", kind, n))
    x = rng.normal(0, 0.5, (n, d)).astype(np.float32)
    jfn, tfn, bw = KERNELS[kind]
    jk, tk = jfn(bandwidth=bw), tfn(bandwidth=bw)
    k = np.asarray(jax.jit(jk.matrix)(jnp.asarray(x)), np.float64)
    deg = k.sum(1) - 1.0
    prefix = np.cumsum(deg)
    return dict(x=x, jk=jk, tk=tk, inv_bw=1.0 / bw, k=k, deg=deg,
                cdf=(prefix / prefix[-1]).astype(np.float32),
                degs=deg.astype(np.float32), total=float(prefix[-1]),
                bs=max(int(np.sqrt(n)), 16), n=n)


def _dev(g):
    xj = jnp.asarray(g["x"])
    tx = torch.as_tensor(g["x"])
    return xj, jnp.sum(xj * xj, -1), tx, (tx * tx).sum(-1)


@pytest.mark.parametrize("kind", ["gaussian", "laplacian"])
def test_fused_edge_batch_matches_ref_oracle(kind):
    """One Algorithm 5.1 edge batch: the port's explicit-noise core vs
    ``fused_edge_batch_ref`` (the documented oracle of the kernel path)
    with the reference's key-split noise: (u, v) identical, weights and
    probabilities at rtol 1e-4; a clean graph gives a clean word."""
    g = _graph(kind)
    n, bs = g["n"], g["bs"]
    nb = -(-n // bs)
    batch = 96
    key = jax.random.PRNGKey(stats.derive_seed("edge_batch", kind))
    xj, xj_sq, tx, tx_sq = _dev(g)
    want = _fused_edge_batch_ref(
        xj, xj_sq, jnp.asarray(g["cdf"]), jnp.asarray(g["degs"]),
        1.0 / g["total"], 1.0 / 1000, key, batch, kind, g["inv_bw"], 1.0,
        bs, nb, n)
    # the oracle's key discipline: k_u | (k_fwd -> k_rest -> k_g, k_in)
    k_u, k_fwd = jax.random.split(key)
    _, k_rest = jax.random.split(k_fwd)
    k_g, k_in = jax.random.split(k_rest)
    noise = [torch.as_tensor(np.array(a)) for a in (
        jax.random.uniform(k_u, (batch,)),
        jax.random.gumbel(k_g, (batch, nb)),
        jax.random.uniform(k_in, (batch,)))]
    *got, word = tops.fused_edge_batch(
        tx, tx_sq, torch.as_tensor(g["cdf"]), torch.as_tensor(g["degs"]),
        1.0 / g["total"], 1.0 / 1000, *noise, kind=kind, inv_bw=g["inv_bw"],
        beta=1.0, block_size=bs, num_blocks=nb, n=n, s=16, exact=True,
        pairwise=None)
    u, v, w, q_uv, q_vu = [a.numpy() for a in got]
    ru, rv, rw, rq_uv, rq_vu = [np.asarray(a) for a in want]
    np.testing.assert_array_equal(u, ru)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_allclose(w, rw, rtol=RTOL)
    np.testing.assert_allclose(q_uv, rq_uv, rtol=RTOL)
    np.testing.assert_allclose(q_vu, rq_vu, rtol=RTOL)
    assert int(word[0]) == 0
    # the torch oracle (same module as the port) agrees bit for bit
    tw = tref.fused_edge_batch_ref(
        tx, tx_sq, torch.as_tensor(g["cdf"]), torch.as_tensor(g["degs"]),
        1.0 / g["total"], 1.0 / 1000, *noise, kind, g["inv_bw"], 1.0, bs, n)
    np.testing.assert_array_equal(tw[1].numpy(), v)


def test_sample_from_block_sums_matches_reference():
    """The cached-sums depth-2 draw (inverse-CDF block draw + in-block
    draw) vs ``ref.sample_from_sums`` with the reference's key split:
    neighbors identical, realized probabilities at rtol 1e-4."""
    g = _graph("gaussian")
    n, bs = g["n"], g["bs"]
    nb = -(-n // bs)
    xj, xj_sq, tx, tx_sq = _dev(g)
    rng = np.random.default_rng(stats.derive_seed("from_sums"))
    src = rng.integers(0, n, 128).astype(np.int32)
    sums = np.array(_masked_exact_sums_ref(
        xj[src], xj, xj_sq, jnp.asarray(src // bs), "gaussian", g["inv_bw"],
        1.0, bs, n))
    key = jax.random.PRNGKey(11)
    views = _block_views(xj, xj_sq, bs)
    rnb, rprob = _sample_from_sums(xj, xj_sq, views, jnp.asarray(src),
                                   jnp.asarray(sums), key, "gaussian",
                                   g["inv_bw"], 1.0, bs, n)
    k_blk, k_in = jax.random.split(key)
    u_blk = torch.as_tensor(np.array(jax.random.uniform(k_blk, (128,))))
    u_in = torch.as_tensor(np.array(jax.random.uniform(k_in, (128,))))
    nb_, prob, word = tops.sample_from_block_sums(
        tx, tx_sq, torch.as_tensor(src.astype(np.int64)),
        torch.as_tensor(sums), u_blk, u_in, kind="gaussian",
        inv_bw=g["inv_bw"], beta=1.0, block_size=bs, n=n)
    np.testing.assert_array_equal(nb_.numpy(), np.asarray(rnb))
    np.testing.assert_allclose(prob.numpy(), np.asarray(rprob), rtol=RTOL)
    assert tuple(word[1:4].tolist()) == (128 * bs, 0, 128)
    assert nb == -(-n // bs)


def test_masked_sums_and_prob_of_programs_match_reference():
    """``masked_block_sums`` and ``prob_of_from_block_sums`` vs the
    reference programs (jnp path): sums / probabilities at rtol 1e-4 (atol
    1e-5 on the floored sums) and identical counter words."""
    g = _graph("laplacian")
    n, bs = g["n"], g["bs"]
    nb = -(-n // bs)
    xj, xj_sq, tx, tx_sq = _dev(g)
    rng = np.random.default_rng(stats.derive_seed("masked_prob"))
    src = rng.integers(0, n, 64).astype(np.int32)
    dst = rng.integers(0, n, 64).astype(np.int32)
    cfg = dict(kind="laplacian", inv_bw=g["inv_bw"], beta=1.0,
               block_size=bs, n=n)
    rbs, rw = jops.masked_block_sums(
        xj, xj_sq, jnp.asarray(src), jax.random.PRNGKey(0), pairwise=None,
        num_blocks=nb, s=bs, exact=True, **cfg)
    tsrc = torch.as_tensor(src.astype(np.int64))
    bsum, w = tops.masked_block_sums(tx, tx_sq, tsrc, num_blocks=nb, s=bs,
                                     exact=True, pairwise=None, **cfg)
    np.testing.assert_allclose(bsum.numpy(), np.asarray(rbs), rtol=RTOL,
                               atol=1e-5)
    assert w.tolist() == np.asarray(rw).astype(np.int64).tolist()
    rp, rw = jops.prob_of_from_block_sums(xj, xj_sq, jnp.asarray(src),
                                          jnp.asarray(dst), rbs,
                                          pairwise=None, **cfg)
    p, w = tops.prob_of_from_block_sums(
        tx, tx_sq, tsrc, torch.as_tensor(dst.astype(np.int64)), bsum, **cfg)
    np.testing.assert_allclose(p.numpy(), np.asarray(rp), rtol=RTOL)
    assert w.tolist() == np.asarray(rw).astype(np.int64).tolist()


def test_prob_of_reproduces_sample():
    """``prob_of`` on the frontier ``sample`` drew from returns the
    realized probabilities: from the cached level-1 sums and from a fresh
    sampler's own masked read (rtol 1e-4); the probabilities of each row
    sum to 1 over all destinations."""
    g = _graph("gaussian", n=200)
    rng = np.random.default_rng(stats.derive_seed("prob_of"))
    src = rng.integers(0, g["n"], 150)
    nbr = NeighborSampler(g["x"], g["tk"], exact_blocks=True, seed=1,
                          device="cpu")
    v, p = nbr.sample(src)
    assert np.all(v != src)
    np.testing.assert_allclose(nbr.prob_of(src, v), p, rtol=RTOL)
    fresh = NeighborSampler(g["x"], g["tk"], exact_blocks=True, seed=2,
                            device="cpu")
    np.testing.assert_allclose(fresh.prob_of(src, v), p, rtol=RTOL)
    # the law: q(. | s) over every destination sums to 1 and is exact
    s = int(src[0])
    allp = fresh.prob_of(np.full(g["n"], s), np.arange(g["n"]))
    row = g["k"][s].copy()
    row[s] = 0.0
    np.testing.assert_allclose(allp, row / row.sum(), rtol=1e-4, atol=1e-9)
    assert nbr.evals == 150 * (g["n"] + nbr.block_size) \
        + 150 * nbr.block_size
    assert nbr.device_counters["evals"] == nbr.evals


def test_edge_batches_counters_match_reference():
    """The same static shapes give the same device counter totals and the
    same analytic ``.evals`` on both sides; statuses are clean."""
    g = _graph("gaussian", n=150)
    t, batch = 700, 256
    ref = JNeighborSampler(g["x"], g["jk"], exact_blocks=True, seed=0)
    ref.edge_batches(jnp.asarray(g["cdf"]), jnp.asarray(g["degs"]),
                     g["total"], t, batch=batch)
    port = NeighborSampler(g["x"], g["tk"], exact_blocks=True, seed=0,
                           device="cpu")
    out = port.edge_batches(torch.as_tensor(g["cdf"]),
                            torch.as_tensor(g["degs"]), g["total"], t,
                            batch=batch)
    assert all(len(a) == t for a in out)
    assert port.evals == ref.evals
    assert port.device_counters.as_dict() == ref.device_counters.as_dict()
    assert port.status == ref.status == 0


def test_prefix_cdf_index_for_index():
    """Same float64 weights and seed: identical draws, probabilities and
    device CDF (float32 rounding of the same float64 prefix)."""
    rng = np.random.default_rng(stats.derive_seed("prefix"))
    w = rng.gamma(0.5, size=5000)
    ref, port = JPrefixCDF(w, seed=7), PrefixCDF(w, seed=7, device="cpu")
    for size in (1, 1000, 4096):
        np.testing.assert_array_equal(port.sample(size), ref.sample(size))
    idx = np.arange(0, 5000, 7)
    np.testing.assert_array_equal(port.prob(idx), ref.prob(idx))
    np.testing.assert_array_equal(port.cdf_device.numpy(),
                                  np.asarray(ref.cdf_device))
    np.testing.assert_array_equal(port.weights_device.numpy(),
                                  np.asarray(ref.weights_device))


def test_degree_sampler_matches_reference():
    """Algorithm 4.3 degrees through the exact block structure: rtol
    1e-4 against the reference's, and the draws of the two degree CDFs
    agree index for index wherever the float64 prefixes agree."""
    g = _graph("gaussian", n=257)
    ref = JExactBlockKDE(g["x"], g["jk"], block_size=16)
    from repro.core.sampling.vertex import DegreeSampler as JDegreeSampler
    from repro_torch.core.kde.base import ExactBlockKDE
    rd = JDegreeSampler(ref, seed=3)
    td = DegreeSampler(ExactBlockKDE(g["x"], g["tk"], block_size=16,
                                     device="cpu"), seed=3)
    np.testing.assert_allclose(td.degrees, rd.degrees, rtol=RTOL)
    np.testing.assert_allclose(td.degrees, g["deg"], rtol=RTOL)
    got, want = td.sample(2000), rd.sample(2000)
    assert np.mean(got == want) > 0.999
    es = EdgeSampler(td, NeighborSampler(g["x"], g["tk"], exact_blocks=True,
                                         device="cpu"))
    u, v, p = es.sample(64)
    np.testing.assert_allclose(p, g["k"][u, v] / g["total"], rtol=RTOL)


def test_inverse_cdf_and_zero_row_guard_match_reference():
    """``inverse_cdf_index`` (searchsorted right, then clip) and
    ``level2_draw``'s all-zero-row fallback give the reference's indices
    on boundary and degenerate inputs."""
    cdf = np.array([0.1, 0.1, 0.5, 0.5, 1.0], np.float32)
    u = np.array([0.0, 0.1, 0.3, 0.5, 0.99, 1.0, 1.5], np.float32)
    np.testing.assert_array_equal(
        tref.inverse_cdf_index(torch.as_tensor(cdf),
                               torch.as_tensor(u)).numpy(),
        np.asarray(_inverse_cdf_index(jnp.asarray(cdf), jnp.asarray(u))))
    kv = np.array([[0.0, 0.0, 0.0, 0.0], [0.2, 0.0, 0.5, 0.3]], np.float32)
    live = np.array([[True, False, True, True], [True, True, True, False]])
    cols = np.array([[4, 5, 6, 7], [8, 9, 10, 11]], np.int32)
    u2 = np.array([0.5, 0.75], np.float32)
    rnb, rpin = _level2_draw(jnp.asarray(kv), jnp.asarray(live),
                             jnp.asarray(cols), jnp.asarray(u2))
    nb, pin = tref.level2_draw(torch.as_tensor(kv), torch.as_tensor(live),
                               torch.as_tensor(cols.astype(np.int64)),
                               torch.as_tensor(u2))
    np.testing.assert_array_equal(nb.numpy(), np.asarray(rnb))
    np.testing.assert_allclose(pin.numpy(), np.asarray(rpin), rtol=1e-6)


def test_sampler_rejects_options_outside_the_slice():
    x = np.zeros((20, 2), np.float32)
    for kw in (dict(level1="hash", mesh=object()),
               dict(exact_blocks=True, mesh=object()),
               dict(data_axes=("data", "model"))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            NeighborSampler(x, gaussian(), device="cpu", **kw)
    # tree mode is ported; as in the reference it needs its tree
    with pytest.raises(ValueError, match="MultiLevelKDE"):
        NeighborSampler(x, gaussian(), device="cpu", exact_blocks=True,
                        mode="tree")
    # the bf16 policy is ported: it constructs on the L2 kinds, and the
    # laplacian raises the reference's ValueError at construction
    assert NeighborSampler(x, gaussian(), device="cpu", exact_blocks=True,
                           precision="bf16").precision == "bf16"
    with pytest.raises(ValueError, match="L2 kernels only"):
        NeighborSampler(x, laplacian(), device="cpu", exact_blocks=True,
                        precision="bf16")
    # as in the reference: a hashed level-1 read cannot be exact
    with pytest.raises(ValueError, match="pick one"):
        NeighborSampler(x, gaussian(), device="cpu", exact_blocks=True,
                        level1="hash")
