"""The paper's Section 7 experiments and the reference oracles the port
mirrors in torch, held against the JAX reference on the same inputs.

- the datasets ``nested``, ``rings`` and ``glove_like``: bitwise the
  reference's at several seeds and an odd n;
- the twins of ``tests/test_system.py``'s paper pipelines (Figure 4's
  sparsify-and-cluster on nested and rings, Figure 3's LRA on mnist_like
  and glove_like) at those tests' sizes and thresholds, with
  ``num_edges``, ``kernel_evals`` and ``kde_queries`` equal to the
  reference's on the same call;
- the pure-torch oracles (``rowsum_ref`` / ``blocksum_ref``,
  ``block_lse_ref`` / ``kde_attention_ref``, the sharded engine's
  ``sharded_*_ref`` and ``sharded_hashed_query_ref``) against their jnp
  twins fed the same inputs and the noise the reference derives from its
  key (ROADMAP.md section 3): floats within rtol 1e-4 / atol 1e-6,
  indices equal except at near-ties of the scores;
- ``PrefixCDF.probs_device`` bitwise the reference's.

The reference's ``median_bandwidth`` subsamples with ``jax.random`` above
2048 points (the port with a torch generator), so every dataset here is
below that size.  Everything runs on the CPU in this process; no process
group is started.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels_fn as jkf
from repro.core import lowrank as jlr
from repro.core import sparsify as jsp
from repro.core.sampling.vertex import PrefixCDF as JPrefixCDF
from repro.data import synthetic_points as jdata
from repro.kernels.kde_attention import ref as jattn
from repro.kernels.kde_hash import ops as jhops
from repro.kernels.kde_hash import ref as jhref
from repro.kernels.kde_rowsum import ref as jrs
from repro.kernels.kde_sampler import ref as jsr
from repro_torch.core.cluster import spectral as tspec
from repro_torch.core import kernels_fn as tkf
from repro_torch.core import lowrank as tlr
from repro_torch.core.laplacian import cg_laplacian
from repro_torch.core import sparsify as tsp
from repro_torch.core.sampling.vertex import PrefixCDF
from repro_torch.data import synthetic_points as tdata
from repro_torch.kernels.kde_attention import kernel as tattn_k
from repro_torch.kernels.kde_attention import ops as tattn_ops
from repro_torch.kernels.kde_attention import ref as tattn
from repro_torch.kernels.kde_hash import ref as thref
from repro_torch.kernels.kde_rowsum import kernel as trs_k
from repro_torch.kernels.kde_rowsum import ref as trs
from repro_torch.kernels.kde_sampler import ref as tsr

jax.config.update("jax_platforms", "cpu")

RTOL, ATOL = 1e-4, 1e-6
KINDS = ("gaussian", "exponential", "rational_quadratic", "laplacian")
#: the reference's oracles, jitted (op-by-op dispatch compiles every
#: primitive on its own)
_SH = ("kind", "inv_bw", "beta", "block_size", "blocks_per_shard",
       "num_shards", "n", "exact", "s", "pairwise")
_KW = ("kind", "inv_bw", "beta", "bn", "precision")
j_rowsum = jax.jit(jrs.rowsum_ref, static_argnames=_KW[:3] + _KW[4:])
j_blocksum = jax.jit(jrs.blocksum_ref, static_argnames=_KW)
j_block_lse = jax.jit(jattn.block_lse_ref,
                      static_argnames=("scale", "stride", "kv_valid", "bk"))
j_kde_attention = jax.jit(jattn.kde_attention_ref,
                          static_argnames=("top_p", "bk", "stride",
                                           "kv_valid"))
j_masked_sums = jax.jit(jsr.sharded_masked_sums_ref, static_argnames=_SH)
j_fused_sample = jax.jit(jsr.sharded_fused_sample_ref, static_argnames=_SH)
j_from_sums = jax.jit(jsr.sharded_sample_from_sums_ref, static_argnames=(
    "kind", "inv_bw", "beta", "block_size", "blocks_per_shard", "n",
    "pairwise"))
j_walk = jax.jit(jsr.sharded_walk_ref, static_argnames=_SH)
j_hashed_query = jax.jit(jhref.sharded_hashed_query_ref,
                         static_argnames=("kind", "inv_bw", "beta",
                                          "cell_width", "num_far", "n",
                                          "shard_size", "pairwise"))


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# --------------------------------------------------------------------- #
# the datasets
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["nested", "rings", "glove_like"])
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n", [301, 1000])
def test_datasets_equal_the_reference_bitwise(name, seed, n):
    """Same generator calls in the same order: the same points (and
    labels) bit for bit, an odd n included (nested / rings split it
    n // 2 and n - n // 2)."""
    got = getattr(tdata, name)(n=n, seed=seed)
    want = getattr(jdata, name)(n=n, seed=seed)
    if name == "glove_like":
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_dataset_defaults_match_the_reference():
    """The defaults the paper's runs take (nested n 5000, rings n 2500
    with radii 5 / 100, glove_like n 4000, d 200)."""
    import inspect
    for name in ("nested", "rings", "glove_like", "mnist_like",
                 "gaussian_clusters"):
        got = inspect.signature(getattr(tdata, name)).parameters
        want = inspect.signature(getattr(jdata, name)).parameters
        assert [(p.name, p.default) for p in got.values()] == \
            [(p.name, p.default) for p in want.values()], name


# --------------------------------------------------------------------- #
# the paper pipelines (tests/test_system.py:21-65)
# --------------------------------------------------------------------- #
def _counters(g):
    return g.num_edges, int(g.kernel_evals), int(g.kde_queries)


def test_paper_pipeline_end_to_end():
    """Nested (n 800) -> the exact sparsifier at 6% of all edges ->
    spectral clustering (accuracy > 0.97) -> a Laplacian solve on the
    sparsifier (finite); the counters equal the reference's."""
    x, lab = tdata.nested(n=800, seed=0)
    n = x.shape[0]
    budget = int(0.06 * n * (n - 1) / 2)
    g = tsp.spectral_sparsify(x, tkf.gaussian(bandwidth=0.3),
                              num_edges=budget, estimator="exact",
                              exact_blocks=True, seed=0, device="cpu")
    assert g.num_edges == budget
    acc = tspec.cluster_accuracy(tspec.spectral_cluster(g, 2, seed=0).labels,
                                 lab, 2)
    assert acc > 0.97, acc
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)
    b -= b.mean()
    sol, _ = cg_laplacian(g, b, iters=300, device="cpu")
    assert np.isfinite(sol).all()
    assert g.num_edges < 0.1 * n * n / 2
    ref = jsp.spectral_sparsify(x, jkf.gaussian(bandwidth=0.3),
                                num_edges=budget, estimator="exact",
                                exact_blocks=True, seed=0)
    assert _counters(g) == _counters(ref)


def test_rings_dataset_clusterable():
    """Rings (n 600) at 0.25 x the median bandwidth, 30,000 edges: cluster
    accuracy > 0.9; the counters equal the reference's (the median
    bandwidth too: n is below the subsample size)."""
    x, lab = tdata.rings(n=600, seed=0)
    bw = tkf.median_bandwidth(torch.as_tensor(x)) * 0.25
    jbw = jkf.median_bandwidth(jnp.asarray(x)) * 0.25
    np.testing.assert_allclose(bw, jbw, rtol=1e-6)
    g = tsp.spectral_sparsify(x, tkf.gaussian(bandwidth=bw),
                              num_edges=30000, estimator="exact",
                              exact_blocks=True, seed=0, device="cpu")
    res = tspec.spectral_cluster(g, 2, seed=1)
    assert tspec.cluster_accuracy(res.labels, lab, 2) > 0.9
    ref = jsp.spectral_sparsify(x, jkf.gaussian(bandwidth=jbw),
                                num_edges=30000, estimator="exact",
                                exact_blocks=True, seed=0)
    assert _counters(g) == _counters(ref)


@pytest.mark.parametrize("maker", ["mnist_like", "glove_like"])
def test_lra_on_paper_style_datasets(maker):
    """MNIST-like / GloVe-like (n 700) LRA with the paper's ``rs`` row
    norms, rank 8, 200 rows: relative Frobenius error < 0.35 and fewer
    than 0.7 n^2 kernel evaluations, ``kernel_evals`` equal to the
    reference's."""
    x = getattr(tdata, maker)(n=700)
    bw = tkf.median_bandwidth(torch.as_tensor(x), ord=1)
    ker = tkf.laplacian(bandwidth=bw)
    k = ker.matrix(torch.as_tensor(x)).double().numpy()
    res = tlr.fkv_lowrank(x, ker, rank=8, num_rows=200, estimator="rs",
                          seed=0, device="cpu")
    err = tlr.projection_error(k, res.u)
    fro2 = np.linalg.norm(k, "fro") ** 2
    assert err / fro2 < 0.35, err / fro2
    assert res.kernel_evals < 0.7 * k.size
    jker = jkf.laplacian(bandwidth=jkf.median_bandwidth(jnp.asarray(x),
                                                        ord=1))
    ref = jlr.fkv_lowrank(x, jker, rank=8, num_rows=200, estimator="rs",
                          seed=0)
    assert int(res.kernel_evals) == int(ref.kernel_evals)


# --------------------------------------------------------------------- #
# the kde_rowsum oracles
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [2, 3, 200])
def test_rowsum_and_blocksum_refs_match_the_reference(kind, d):
    """``rowsum_ref`` / ``blocksum_ref`` (bn 64 and the default 256 on n a
    multiple of it) against the jnp oracles; the rowsum kernel's plain
    version is ``rowsum_ref``."""
    rng = np.random.default_rng(d)
    q = rng.normal(0, 0.4, (23, d)).astype(np.float32)
    x = rng.normal(0, 0.4, (512, d)).astype(np.float32)
    inv_bw = 1.0 / (0.4 * d) if kind == "laplacian" else 1.0 / (0.5 * d ** .5)
    args = (kind, inv_bw, 0.7)
    _close(trs.rowsum_ref(_t(q), _t(x), *args),
           j_rowsum(jnp.asarray(q), jnp.asarray(x), *args))
    for bn in (64, 256):
        _close(trs.blocksum_ref(_t(q), _t(x), *args, bn=bn),
               j_blocksum(jnp.asarray(q), jnp.asarray(x), *args, bn=bn))
    assert trs.blocksum_ref.__defaults__ == jrs.blocksum_ref.__defaults__
    assert trs_k.rowsum_plain is trs.rowsum_ref


@pytest.mark.parametrize("kind", ["gaussian", "exponential",
                                  "rational_quadratic"])
def test_bf16_rowsum_and_blocksum_refs_on_dyadic_points(kind):
    """``precision="bf16"`` on dyadic coordinates (k / 8: exact in bf16
    and f32, so both sides read the same exp-table entries): the jnp
    oracle's values within rtol 1e-4."""
    rng = np.random.default_rng(5)
    q = (rng.integers(-8, 9, (17, 16)) / 8).astype(np.float32)
    x = (rng.integers(-8, 9, (256, 16)) / 8).astype(np.float32)
    args = (kind, 0.5, 1.0)
    _close(trs.rowsum_ref(_t(q), _t(x), *args, precision="bf16"),
           j_rowsum(jnp.asarray(q), jnp.asarray(x), *args,
                    precision="bf16"))
    _close(trs.blocksum_ref(_t(q), _t(x), *args, bn=64, precision="bf16"),
           j_blocksum(jnp.asarray(q), jnp.asarray(x), *args, bn=64,
                      precision="bf16"))


def test_blocksum_ref_takes_a_ragged_last_block():
    """Where the reference needs n a multiple of bn, the port sums the
    rows a ragged last block has: the first blocks equal the aligned
    call, the last one the sum over its rows."""
    rng = np.random.default_rng(2)
    q, x = _t(rng.normal(size=(5, 3)).astype(np.float32)), \
        _t(rng.normal(size=(70, 3)).astype(np.float32))
    got = trs.blocksum_ref(q, x, "gaussian", 1.0, bn=32)
    assert got.shape == (5, 3)
    torch.testing.assert_close(got[:, :2],
                               trs.blocksum_ref(q, x[:64], "gaussian", 1.0,
                                                bn=32))
    torch.testing.assert_close(got[:, 2],
                               trs.rowsum_ref(q, x[64:], "gaussian", 1.0))


# --------------------------------------------------------------------- #
# the kde_attention oracles
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("group,kv_valid", [(1, 200), (4, 97), (8, 256)])
def test_kde_attention_refs_match_the_reference(group, kv_valid):
    """``block_lse_ref`` and ``kde_attention_ref`` against the jnp oracles
    on the same cache: one definition each (the fused kernel's plain
    versions and ``ops.kde_attention_ref`` are the same objects)."""
    rng = np.random.default_rng(group)
    b, hkv, s, dh = 2, 2, 256, 32
    q = rng.normal(size=(b, hkv * group, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    kw = dict(bk=32, stride=4)
    _close(tattn.block_lse_ref(_t(q), _t(k), scale=dh ** -0.5,
                               kv_valid=kv_valid, **kw),
           j_block_lse(jnp.asarray(q), jnp.asarray(k), scale=dh ** -0.5,
                       kv_valid=kv_valid, **kw))
    got = tattn.kde_attention_ref(_t(q), _t(k), _t(v), top_p=3,
                                  kv_valid=kv_valid, **kw)
    want = j_kde_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           top_p=3, kv_valid=kv_valid, **kw)
    _close(got, want)
    assert tattn_ops.kde_attention_ref is tattn.kde_attention_ref
    assert tattn_k.kde_decode_plain is tattn.kde_attention_ref
    assert tattn_k.block_lse_plain is tattn.block_lse_ref


# --------------------------------------------------------------------- #
# the sharded engine's oracles
# --------------------------------------------------------------------- #
N_S, BS, P, W = 230, 16, 4, 40
BL = -(-(-(-N_S // P)) // BS)          # blocks a shard: ceil(ceil(n/P)/bs)


def _padded():
    rng = np.random.default_rng(11)
    x = rng.normal(0, 0.6, (N_S, 5)).astype(np.float32)
    pad = P * BL * BS - N_S
    xp = np.concatenate([x, np.full((pad, 5), 1e30, np.float32) + x[-1:]])
    src = rng.integers(0, N_S, W)
    return xp, src


def _u3(k, w):
    """The reference's draw split, (k_shard, k_blk, k_in) = split(k, 3),
    as (3, w) uniforms."""
    return np.stack([np.asarray(jax.random.uniform(kk, (w,)))
                     for kk in jax.random.split(k, 3)])


def _l1(k):
    """The stratified uniforms of every shard, fold_in(k, p)."""
    return np.concatenate([np.asarray(jax.random.uniform(
        jax.random.fold_in(k, p), (BL, BS))) for p in range(P)])


def _key_u(key, exact):
    """``sharded_fused_sample_ref``'s noise from the reference's key: its
    ``k_l1, k_rest = split(key)``."""
    k_l1, k_rest = jax.random.split(key)
    return (None if exact else _t(_l1(k_l1)), _t(_u3(k_rest, W)))


@pytest.mark.parametrize("kind", ["gaussian", "laplacian"])
@pytest.mark.parametrize("exact", [True, False])
def test_sharded_masked_sums_ref_matches_the_reference(kind, exact):
    """The local level-1 sums of every shard, concatenated (n = 230 on 4
    shards of 4 blocks of 16: sentinel rows, an all-sentinel block),
    exact and stratified (s 8) on the reference's fold_in uniforms."""
    xp, src = _padded()
    key = jax.random.PRNGKey(3)
    jxp = jnp.asarray(xp)
    args = (kind, 1.0, 1.0, BS, BL, P, N_S)
    want = j_masked_sums(
        jxp, jnp.sum(jxp * jxp, -1), jnp.asarray(src), key, *args,
        exact=exact, s=8)
    txp = _t(xp)
    got = tsr.sharded_masked_sums_ref(
        txp, torch.sum(txp * txp, -1), _t(src), None if exact else
        _t(_l1(key)), *args, exact=exact, s=8)
    _close(got, want)
    assert np.all(got.numpy()[:, -1] == 0.0)      # the all-sentinel block


@pytest.mark.parametrize("exact", [True, False])
def test_sharded_fused_sample_ref_matches_the_reference(exact):
    """One two-stage draw: neighbors equal, probabilities and sums within
    rtol 1e-4; ``sharded_sample_from_sums_ref`` alone on the reference's
    sums and ``split(k_rest, 3)`` uniforms likewise."""
    xp, src = _padded()
    jxp = jnp.asarray(xp)
    jsq = jnp.sum(jxp * jxp, -1)
    txp = _t(xp)
    tsq = torch.sum(txp * txp, -1)
    key = jax.random.PRNGKey(5)
    args = ("gaussian", 1.0, 1.0, BS, BL, P, N_S)
    rnb, rprob, rsums = j_fused_sample(
        jxp, jsq, jnp.asarray(src), key, *args, exact=exact, s=8)
    nb, prob, sums = tsr.sharded_fused_sample_ref(
        txp, tsq, _t(src), _key_u(key, exact), *args, exact=exact, s=8)
    np.testing.assert_array_equal(nb.numpy(), np.asarray(rnb))
    _close(prob, rprob)
    _close(sums, rsums)
    k = jax.random.PRNGKey(9)
    views = jsr.block_views(jxp, jsq, BS)
    rnb, rprob, rtot = j_from_sums(
        jxp, jsq, views, jnp.asarray(src), rsums, k, "gaussian", 1.0, 1.0,
        BS, BL, N_S)
    nb, prob, tot = tsr.sharded_sample_from_sums_ref(
        txp, tsq, tsr.block_views(txp, tsq, BS), _t(src),
        _t(np.asarray(rsums)), _t(_u3(k, W)), "gaussian", 1.0, 1.0, BS, BL,
        N_S)
    np.testing.assert_array_equal(nb.numpy(), np.asarray(rnb))
    _close(prob, rprob)
    _close(tot, rtot)


@pytest.mark.parametrize("exact", [True, False])
def test_sharded_walk_ref_matches_the_reference(exact):
    """Five walk steps: the endpoints equal the reference's, each step's
    noise derived from its key as the reference splits it."""
    xp, src = _padded()
    jxp, txp = jnp.asarray(xp), _t(xp)
    keys = jax.random.split(jax.random.PRNGKey(7), 5)
    args = ("gaussian", 1.0, 1.0, BS, BL, P, N_S)
    want = j_walk(jxp, jnp.sum(jxp * jxp, -1), jnp.asarray(src), keys,
                  *args, exact=exact, s=8)
    got = tsr.sharded_walk_ref(txp, torch.sum(txp * txp, -1), _t(src),
                               [_key_u(k, exact) for k in keys], *args,
                               exact=exact, s=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _shard_tables(xh, shard, w, overflow=False):
    """Every shard's host table (the reference's host build), as the
    reference's and the port's ``HashState``s; with ``overflow`` each
    shard also carries a streaming overflow region of 3 of its own rows
    and 2 free slots."""
    rng = np.random.default_rng(3)
    dims, shift = jhops.draw_grid(rng, xh.shape[1], 8, w)
    jst, tst = [], []
    for p in range(P):
        lo, hi = p * shard, min((p + 1) * shard, len(xh))
        rows = np.arange(lo, hi, dtype=np.int64)
        uniq, mem, cnt, _, tr = jhops.bucket_table(
            jhops.grid_keys(xh[rows], dims, shift, w), rows, 4, rng)
        k = len(uniq)
        ov = (np.array([lo + 1, -1, lo + 5, lo + 9, -1], np.int32)
              if overflow else None)
        jst.append(jhref.HashState(
            dims=jnp.asarray(dims), shift=jnp.asarray(shift),
            keys=jnp.asarray(uniq), members=jnp.asarray(mem[:k]),
            counts=jnp.asarray(cnt), point_bucket=None, self_stored=None,
            truncated=jnp.asarray(tr[:k]),
            overflow=None if ov is None else jnp.asarray(ov)))
        tst.append(thref.HashState(
            dims=_t(dims.astype(np.int64)), shift=_t(shift),
            keys=_t(uniq.astype(np.int64)), members=_t(mem[:k]),
            counts=_t(cnt.astype(np.int64)), point_bucket=None,
            self_stored=None, truncated=_t(tr[:k]),
            overflow=None if ov is None else _t(ov)))
    return jst, tst


@pytest.mark.parametrize("kind", ["gaussian", "laplacian"])
@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("num_far", [0, 8])
def test_sharded_hashed_query_ref_matches_the_reference(kind, overflow,
                                                        num_far):
    """The per-shard NEAR lookups and FAR draws (max_bucket 4: truncated
    buckets), with and without a streaming overflow region, FAR on and
    off: NEAR counts equal, estimates within rtol 1e-4; the FAR offsets
    are the reference's ``randint(fold_in(key, p), (m, num_far), 0,
    shard_size)``."""
    rng = np.random.default_rng(4)
    xh = rng.normal(0, 0.8, (250, 4)).astype(np.float32)
    yh = np.concatenate([xh[:24] + 0.05,
                         rng.normal(0, 0.8, (8, 4))]).astype(np.float32)
    shard = -(-len(xh) // P)
    pad = P * shard - len(xh)
    xp = np.concatenate([xh, np.full((pad, 4), 1e30, np.float32) + xh[-1:]])
    w = 2.0
    jst, tst = _shard_tables(xh, shard, w, overflow)
    assert any(bool(np.asarray(s.truncated).any()) for s in jst)
    key = jax.random.PRNGKey(11)
    off = None if num_far == 0 else np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(key, p), (len(yh), num_far), 0, shard))
        for p in range(P)])
    args = (kind, 1.0, 1.0, w, num_far, len(xh), shard)
    rest, rcnt = j_hashed_query(
        jnp.asarray(xp), jnp.asarray(yh), jst, key, *args)
    est, cnt = thref.sharded_hashed_query_ref(
        _t(xp), _t(yh), tst, None if off is None else _t(off), *args)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(rcnt))
    assert cnt.sum() > 0
    _close(est, rest)


# --------------------------------------------------------------------- #
# degree sampling
# --------------------------------------------------------------------- #
def test_probs_device_equals_the_reference_bitwise():
    """``PrefixCDF.probs_device``: w / sum w divided in float64 and rounded
    once to float32, bitwise the reference's, made once."""
    w = np.random.default_rng(1).gamma(0.5, size=4097)
    port = PrefixCDF(w, seed=0, device="cpu")
    got = port.probs_device
    assert got.dtype == torch.float32 and port.probs_device is got
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JPrefixCDF(w).probs_device))
