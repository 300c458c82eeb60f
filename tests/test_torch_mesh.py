"""The multi-device engines on ``torch.distributed`` against the reference's
oracles: the mirror of ``tests/test_distributed.py`` lines 26-248.

Eight spawned gloo ranks (``torch_mesh_ranks.engine``, no JAX in the
ranks) run the port on ``"cpu"`` meshes: the functional KDE API on a (4,
2) ``("data", "model")`` mesh and on ``("pod", "data")`` flattened over
all 8 shards, the block sums (aligned, ragged, ``own=``), the
``ShardedBlocks`` engine at n = 250 on an (8,) mesh fed the uniforms of
the reference's pure-jnp ``sharded_*_ref`` oracles (and the port's own torch
mirrors of them, fed the same uniforms), the counted collective
schedules, the sharded noisy power method and the sharded hash table.
The reference's own mesh pipelines fail on this tree's JAX (``jax.make_mesh``
defaults to Explicit axes), so the jnp oracles are the reference here.

Tolerances: ints bitwise; floats rtol 2e-5 / atol 1e-9 (the reference
test's); KDE queries rtol 1e-4; degrees rtol 1e-3 / atol 1e-3; block
sums rtol 1e-4 (the reference test's).  Every rank's replicated outputs
equal rank 0's bitwise.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.core.kernels_fn import gaussian
from repro.kernels.kde_hash import ops as jhops
from repro.kernels.kde_hash import ref as jhref
from repro.kernels.kde_sampler import ref as sref
from repro_torch.kernels.kde_hash import ref as thref
from repro_torch.kernels.kde_sampler import ref as tsref

jax.config.update("jax_platforms", "cpu")

KER = gaussian(1.0)
N_E, BS, P = 250, 16, 8


def _u3(k, w):
    """The reference's draw split: (k_shard, k_blk, k_in) = split(k, 3),
    as the port's (3, w) draw uniforms."""
    return np.stack([np.asarray(jax.random.uniform(kk, (w,)))
                     for kk in jax.random.split(k, 3)])


def _l1(k, bl):
    """The stratified subsample uniforms of every shard, fold_in(k, p)."""
    return np.concatenate([np.asarray(jax.random.uniform(
        jax.random.fold_in(k, p), (bl, BS))) for p in range(P)])


def _x_pad(x, shard):
    pad = P * shard - x.shape[0]
    xj = jnp.asarray(x)
    sent = jnp.full((pad, x.shape[1]), 1e30, jnp.float32) + xj[-1:]
    return jnp.concatenate([xj, sent])


def _payload():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.6, (256, 5)).astype(np.float32)
    pl = dict(x=x, y=rng.normal(0, 0.6, (16, 5)).astype(np.float32),
              y_blocks=rng.normal(0, 0.6, (8, 5)).astype(np.float32),
              y_ragged=rng.normal(0, 0.6, (6, 5)).astype(np.float32),
              own_src=rng.integers(0, 256, 24))
    xe = rng.normal(0, 0.6, (N_E, 5)).astype(np.float32)
    src = rng.integers(0, N_E, 64)
    pl.update(xe=xe, src=src)
    key = jax.random.PRNGKey(3)
    k_l1, k_rest = jax.random.split(key)
    bl = 2                                  # ceil(250 / 8) = 32 = 2 blocks
    pl["u_exact"] = pl["u_strat"] = _u3(k_rest, 64)
    pl["l1_strat"] = _l1(k_l1, bl)
    wkeys = jax.random.split(jax.random.PRNGKey(7), 5)
    pl["walk_u"] = [_u3(jax.random.split(k)[1], 64) for k in wkeys]
    kd = np.asarray(KER.matrix(jnp.asarray(xe)), np.float64)
    degs = (kd.sum(1) - 1).astype(np.float32)
    pl["degs"] = degs
    pl["cdf"] = (np.cumsum(degs) / degs.sum()).astype(np.float32)
    ksub = np.asarray(KER.matrix(jnp.asarray(xe[:96])), np.float32)
    pkeys = jax.random.split(jax.random.PRNGKey(4), 6)
    pl.update(ksub=ksub, v0=np.full(96, 1 / np.sqrt(96.0), np.float32),
              power_u=np.stack([np.asarray(jax.random.uniform(k, (16,)))
                                for k in pkeys]))
    xh = rng.normal(0, 0.8, (500, 4)).astype(np.float32)
    pl.update(xh=xh, yh=np.concatenate(
        [xh[:24] + 0.05, rng.normal(0, 0.8, (8, 4))]).astype(np.float32))
    hkey = jax.random.PRNGKey(11)
    pl["fidx"] = np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(hkey, p), (32, 8), 0, 63)) for p in range(P)])
    refs = dict(key=key, wkeys=wkeys, pkeys=pkeys, hkey=hkey, bl=bl)
    return pl, refs


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    pl, refs = _payload()
    res = ranks.spawn("engine", P, tmp_path_factory.mktemp("mesh"), pl)
    return pl, refs, res


def _same_on_every_rank(res, key):
    def eq(a, b):
        if isinstance(a, (tuple, list)):
            for u, v in zip(a, b):
                eq(u, v)
        elif isinstance(a, dict):
            for k in a:
                eq(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for r in res[1:]:
        eq(r[key], res[0][key])


def test_kde_query_and_degrees_on_two_2d_meshes(mesh_run):
    """``sharded_kde_query`` on a (4, 2) ("data", "model") mesh against the
    exact sums (one all-reduce), ``degree_preprocessing`` on it and on
    ("pod", "data") flattened over all 8 shards (the regression of
    ``tests/test_distributed.py:50``: P - 1 exchanges of the ring, one
    all-gather, no all-reduce)."""
    pl, _, res = mesh_run
    r0 = res[0]
    want = np.asarray(KER.pairwise(jnp.asarray(pl["y"]),
                                   jnp.asarray(pl["x"])).sum(1))
    np.testing.assert_allclose(r0["kde_query"], want, rtol=1e-4)
    assert r0["kde_query_cc"]["psum_total"] == 1
    wd = np.asarray(KER.matrix(jnp.asarray(pl["x"])).sum(1)) - 1.0
    for k in ("degrees_dm", "degrees_pd"):
        np.testing.assert_allclose(r0[k], wd, rtol=1e-3, atol=1e-3)
    cc = r0["degrees_pd_cc"]
    assert (cc["ppermute_total"], cc["psum_total"], cc["all_gather"]) \
        == (P - 1, 0, 1), cc
    for k in ("kde_query", "degrees_dm", "degrees_pd"):
        _same_on_every_rank(res, k)


def test_block_sums_aligned_ragged_and_own(mesh_run):
    """``sharded_block_sums`` with aligned shards (4 blocks of 16 a
    shard), ragged ones (5 blocks a 64-row shard: blocks of 13, sentinel
    padded), and with ``own=`` on the (8,) mesh: bitwise the port's
    single-device ``masked_block_sums`` and the reference's jnp oracle at
    the reference test's tolerance."""
    pl, _, res = mesh_run
    r0 = res[0]
    kv = np.asarray(KER.pairwise(jnp.asarray(pl["y_blocks"]),
                                 jnp.asarray(pl["x"])))
    np.testing.assert_allclose(r0["blocks_aligned"],
                               kv.reshape(8, 16, 16).sum(-1), rtol=1e-4)
    kv = np.asarray(KER.pairwise(jnp.asarray(pl["y_ragged"]),
                                 jnp.asarray(pl["x"])))
    want = np.zeros((6, 20))
    for p in range(4):
        for b in range(5):
            lo = p * 64 + b * 13
            hi = min(p * 64 + min((b + 1) * 13, 64), 256)
            if lo < hi:
                want[:, p * 5 + b] = kv[:, lo:hi].sum(1)
    np.testing.assert_allclose(r0["blocks_ragged"], want, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(r0["blocks_own"], r0["blocks_own_flat"])
    src = pl["own_src"]
    xj = jnp.asarray(pl["x"])
    jw = np.asarray(sref.masked_exact_sums_ref(
        xj[src], xj, jnp.sum(xj * xj, -1), jnp.asarray(src // 16),
        "gaussian", 1.0, 1.0, 16, 256))
    np.testing.assert_allclose(r0["blocks_own"], jw, rtol=2e-5, atol=1e-9)
    for k in ("blocks_aligned", "blocks_ragged", "blocks_own"):
        _same_on_every_rank(res, k)


@pytest.mark.parametrize("exact", [True, False])
def test_fused_sample_matches_the_sharded_oracle(mesh_run, exact):
    """``ShardedBlocks.fused_sample`` at n = 250 (ragged: 6 sentinel rows,
    the last shard's second block all-sentinel) on the exact and the
    stratified read, fed the uniforms of ``sharded_fused_sample_ref``:
    neighbors bitwise, probabilities and the level-1 sums at rtol 2e-5,
    one all-reduce and no exchange, a clean word, and the exact read's
    sums bitwise the port's single-device ``masked_block_sums`` (pads 0)."""
    pl, refs, res = mesh_run
    r0 = res[0]
    tag = "exact" if exact else "strat"
    bl = refs["bl"]
    xp = _x_pad(pl["xe"], bl * BS)
    np.testing.assert_array_equal(r0["x_pad"], np.asarray(xp))
    rnb, rprob, rsums = sref.sharded_fused_sample_ref(
        xp, jnp.sum(xp * xp, -1), jnp.asarray(pl["src"]), refs["key"],
        "gaussian", 1.0, 1.0, BS, bl, P, N_E, exact=exact, s=8)
    nb, prob, sums, cw, cc = r0[f"fused_{tag}"]
    np.testing.assert_array_equal(nb, np.asarray(rnb))
    np.testing.assert_allclose(prob, np.asarray(rprob), rtol=2e-5, atol=1e-9)
    np.testing.assert_allclose(sums, np.asarray(rsums), rtol=2e-5, atol=1e-9)
    assert int(cw[0]) == 0 and int(cw[7]) == 1
    assert (cc["psum_total"], cc["ppermute_total"]) == (1, 0)
    if exact:
        sd = r0["masked_exact_flat"]
        np.testing.assert_array_equal(r0["masked_exact"][:, :sd.shape[1]],
                                      sd)
        assert np.all(r0["masked_exact"][:, sd.shape[1]:] == 0.0)
    _same_on_every_rank(res, f"fused_{tag}")


def test_walk_matches_the_sharded_oracle(mesh_run):
    """``walk_scan`` (5 exact steps) against ``sharded_walk_ref`` fed its
    uniforms: endpoints bitwise, no fallback, a clean word, one
    all-reduce a step (the reference's jaxpr counts the scan body once;
    the port counts every realized call: ROADMAP.md section 3)."""
    pl, refs, res = mesh_run
    bl = refs["bl"]
    xp = _x_pad(pl["xe"], bl * BS)
    rend = sref.sharded_walk_ref(xp, jnp.sum(xp * xp, -1),
                                 jnp.asarray(pl["src"]), refs["wkeys"],
                                 "gaussian", 1.0, 1.0, BS, bl, P, N_E,
                                 exact=True)
    end, cw, fb = res[0]["walk"]
    np.testing.assert_array_equal(end, np.asarray(rend))
    assert int(cw[0]) == 0 and int(fb) == 0 and int(cw[7]) == 5
    cc = res[0]["walk_cc"]
    assert (cc["psum_total"], cc["ppermute_total"]) == (5, 0)
    _same_on_every_rank(res, "walk")


def test_one_all_reduce_per_batch(mesh_run):
    """The counted schedule: exactly one all-reduce and zero exchanges a
    draw batch, a walk step, an edge batch, a triangle batch and a
    ``prob_of`` read; the edge scan's word counts one a batch."""
    res = mesh_run[2]
    for rank in res:
        for name, cc in rank["schedule"].items():
            assert (cc["psum_total"], cc["ppermute_total"],
                    cc["all_gather"]) == (1, 0, 0), (name, cc)
        assert rank["edge_word_psums"] == 3


def test_noisy_power_matches_the_oracle(mesh_run):
    """``sharded_noisy_power``: iterations + 1 all-reduces, the
    eigenvalue and vector of ``noisy_power_ref`` on the same uniforms
    (the partial matvecs reorder the sums: rtol 1e-4)."""
    pl, refs, res = mesh_run
    lam, v, cw = res[0]["power"]
    rlam, rv = sref.noisy_power_ref(jnp.asarray(pl["ksub"]),
                                    jnp.asarray(pl["v0"]), refs["pkeys"], 16)
    np.testing.assert_allclose(lam, float(rlam), rtol=1e-4)
    np.testing.assert_allclose(v, np.asarray(rv), rtol=1e-4, atol=1e-5)
    assert res[0]["power_cc"]["psum_total"] == 7 and int(cw[7]) == 7
    assert int(cw[3]) == 6 * 16
    _same_on_every_rank(res, "power")


def test_sharded_hash_query_matches_the_oracle(mesh_run):
    """``ShardedHashTable``: every shard's host table equals the one the
    reference's host build makes (same RNG order), and ``query`` equals
    ``sharded_hashed_query_ref`` given the oracle's FAR indices -- NEAR
    counts bitwise, estimates at rtol 2e-5 -- with one all-reduce a
    batch."""
    pl, refs, res = mesh_run
    (keys, members, counts, trunc, dims, shift, cw_, shard, x_pad) = \
        res[0]["hash_tables"]
    xh = pl["xh"]
    rng = np.random.default_rng(3)
    w = jhops.default_cell_width(KER)
    rdims, rshift = jhops.draw_grid(rng, 4, 8, w)
    np.testing.assert_array_equal(dims, rdims)
    np.testing.assert_array_equal(shift, rshift)
    states = []
    for p in range(P):
        lo, hi = p * shard, min((p + 1) * shard, len(xh))
        rows = np.arange(lo, hi, dtype=np.int64)
        uniq, mem, cnt, _, tr = jhops.bucket_table(
            jhops.grid_keys(xh[rows], rdims, rshift, w), rows, 64, rng)
        k = len(uniq)
        np.testing.assert_array_equal(keys[p, :k], uniq)
        np.testing.assert_array_equal(members[p, :k], mem[:k])
        np.testing.assert_array_equal(counts[p, :k], cnt)
        states.append(jhref.HashState(
            dims=jnp.asarray(dims), shift=jnp.asarray(shift),
            keys=jnp.asarray(keys[p]), members=jnp.asarray(members[p]),
            counts=jnp.asarray(counts[p]), point_bucket=None,
            self_stored=None, truncated=jnp.asarray(trunc[p])))
    rest, rcnt = jhref.sharded_hashed_query_ref(
        jnp.asarray(x_pad), jnp.asarray(pl["yh"]), states, refs["hkey"],
        "gaussian", 1.0, 1.0, w, 8, len(xh), shard)
    est, cnt, hw = res[0]["hash"]
    np.testing.assert_array_equal(cnt, np.asarray(rcnt))
    assert cnt.sum() > 0
    np.testing.assert_allclose(est, np.asarray(rest), rtol=2e-5, atol=1e-9)
    assert res[0]["hash_cc"]["psum_total"] == 1 and int(hw[7]) == 1
    _same_on_every_rank(res, "hash")


def _padded_sq(res):
    xp = torch.as_tensor(res[0]["x_pad"])
    return xp, torch.sum(xp * xp, -1)


@pytest.mark.parametrize("exact", [True, False])
def test_fused_sample_matches_the_torch_oracle(mesh_run, exact):
    """``ShardedBlocks.fused_sample`` against the port's single-process
    ``sharded_fused_sample_ref`` on the ranks' uniforms: neighbors
    bitwise, probabilities and sums at rtol 2e-5."""
    pl, refs, res = mesh_run
    tag = "exact" if exact else "strat"
    xp, xsq = _padded_sq(res)
    key_u = (None if exact else torch.as_tensor(pl["l1_strat"]),
             torch.as_tensor(pl[f"u_{tag}"]))
    rnb, rprob, rsums = tsref.sharded_fused_sample_ref(
        xp, xsq, torch.as_tensor(pl["src"]), key_u, "gaussian", 1.0, 1.0,
        BS, refs["bl"], P, N_E, exact=exact, s=8)
    nb, prob, sums, _, _ = res[0][f"fused_{tag}"]
    np.testing.assert_array_equal(nb, rnb.numpy())
    np.testing.assert_allclose(prob, rprob.numpy(), rtol=2e-5, atol=1e-9)
    np.testing.assert_allclose(sums, rsums.numpy(), rtol=2e-5, atol=1e-9)


def test_walk_matches_the_torch_oracle(mesh_run):
    """``walk_scan``'s 5 exact steps against the port's
    ``sharded_walk_ref`` on the same draw uniforms: endpoints bitwise."""
    pl, refs, res = mesh_run
    xp, xsq = _padded_sq(res)
    rend = tsref.sharded_walk_ref(
        xp, xsq, torch.as_tensor(pl["src"]),
        [(None, torch.as_tensor(u)) for u in pl["walk_u"]], "gaussian", 1.0,
        1.0, BS, refs["bl"], P, N_E, exact=True)
    np.testing.assert_array_equal(res[0]["walk"][0], rend.numpy())


def test_sharded_hash_query_matches_the_torch_oracle(mesh_run):
    """``ShardedHashTable.query`` against the port's
    ``sharded_hashed_query_ref`` on the ranks' own shard tables and FAR
    offsets: NEAR counts bitwise, estimates at rtol 2e-5."""
    pl, _, res = mesh_run
    (keys, members, counts, trunc, dims, shift, cw_, shard, x_pad) = \
        res[0]["hash_tables"]
    states = [thref.HashState(
        dims=torch.as_tensor(np.asarray(dims, np.int64)),
        shift=torch.as_tensor(shift),
        keys=torch.as_tensor(keys[p].astype(np.int64)),
        members=torch.as_tensor(members[p]),
        counts=torch.as_tensor(counts[p].astype(np.int64)),
        point_bucket=None, self_stored=None,
        truncated=torch.as_tensor(trunc[p])) for p in range(P)]
    rest, rcnt = thref.sharded_hashed_query_ref(
        torch.as_tensor(x_pad), torch.as_tensor(pl["yh"]), states,
        torch.as_tensor(pl["fidx"]), "gaussian", 1.0, 1.0, cw_, 8,
        len(pl["xh"]), shard)
    est, cnt, _ = res[0]["hash"]
    np.testing.assert_array_equal(cnt, rcnt.numpy())
    np.testing.assert_allclose(est, rest.numpy(), rtol=2e-5, atol=1e-9)
