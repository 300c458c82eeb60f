"""The stratified level-1 read (the reference's default sparsifier), the
Theorem 4.12 rejection rounds and the sub-linear row-norm estimators of
the LRA (``rs``, ``stratified``) on the port, against the JAX reference
on the CPU.

The reference draws its noise from keys; the tests derive the same
uniforms from those keys with the reference's own splits and hand them to
the port's explicit-noise programs:

- ``k_l1, k_rest = split(key)``, then ``uniform(k_l1, (B, bs))`` for the
  subsample of a stratified read and ``k_blk, k_in = split(k_rest)`` for
  the block and in-block draws;
- ``k_u, k_fwd = split(key)`` in front of that for an edge batch;
- ``split(key, 2 * rounds + 1)`` for the rejection rounds.

Indices then match exactly (except where an inverse-CDF uniform falls
within 1e-5 of a block boundary), floats within the stated tolerance, and
counter words slot for slot.  ``RSKDE`` draws its subsample on the host
with numpy, so both packages read the same rows.
"""
import ast
import dataclasses
import importlib
import importlib.util
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.core.kde.base import RSKDE as JRSKDE
from repro.core.kde.base import make_estimator as jmake_estimator
from repro.core.kernels_fn import gaussian as jgaussian
from repro.core.kernels_fn import laplacian as jlaplacian
from repro.core.kernels_fn import rational_quadratic as jrq
from repro.core.lowrank import countsketch_lowrank as jcountsketch
from repro.core.lowrank import fkv_lowrank as jfkv
from repro.core.sampling.edge import NeighborSampler as JNeighborSampler
from repro.core.sampling.rownorm import RowNormSampler as JRowNormSampler
from repro.core.sparsify import incidence_row_norms as jincidence
from repro.core.sparsify import spectral_sparsify as jsparsify
from repro.ft import guards as jguards
from repro.kernels.kde_sampler import ops as jops
import repro_torch.core as tcore
from repro_torch.core.kde.base import RSKDE, make_estimator
from repro_torch.core.kernels_fn import gaussian, laplacian
from repro_torch.core.kernels_fn import rational_quadratic
from repro_torch.core.lowrank import (countsketch_lowrank, fkv_lowrank,
                                      projection_error)
from repro_torch.core.sampling.edge import NeighborSampler
from repro_torch.core.sampling.rownorm import RowNormSampler
from repro_torch.core.sparsify import incidence_row_norms, spectral_sparsify
from repro_torch.ft import guards as tguards
from repro_torch.kernels.kde_sampler import ops as tops

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4
TIE = 1e-5
#: (reference kernel, port kernel) at a bandwidth that keeps every block's
#: mass well above the floor at the test sizes
KERNELS = {"gaussian": (jgaussian(bandwidth=1.5), gaussian(bandwidth=1.5)),
           "laplacian": (jlaplacian(bandwidth=2.5), laplacian(bandwidth=2.5)),
           "rational_quadratic": (jrq(beta=0.7, bandwidth=1.5),
                                  rational_quadratic(beta=0.7,
                                                     bandwidth=1.5))}
#: n a multiple of the block size (the reference's tail-free path) and n
#: with a 3-row tail block, fewer rows than s: the subsample then takes
#: invalid slots, which both sides mask
BS, S = 16, 8
SIZES = {"tail_free": 320, "ragged": 291}


def _points(label, n, d=5):
    rng = np.random.default_rng(stats.derive_seed("torch_stratified", label))
    return rng.normal(0, 0.5, (n, d)).astype(np.float32)


def _cfg(kind, n, bs=BS):
    jk, _ = KERNELS[kind]
    return dict(kind=kind, inv_bw=1.0 / jk.bandwidth, beta=jk.beta,
                block_size=bs, num_blocks=-(-n // bs), n=n)


def _both(x):
    xj, tx = jnp.asarray(x), torch.as_tensor(x)
    return xj, jnp.sum(xj * xj, -1), tx, (tx * tx).sum(-1)


def _t(a, dtype=None):
    out = torch.as_tensor(np.array(a))
    return out if dtype is None else out.to(dtype)


def _u(key, shape):
    return _t(jax.random.uniform(key, shape))


def _step_noise(key, w, nb, bs):
    """A stratified step's noise from ``key`` by the reference's splits."""
    k_l1, k_rest = jax.random.split(key)
    k_blk, k_in = jax.random.split(k_rest)
    return _u(k_l1, (nb, bs)), _u(k_blk, (w,)), _u(k_in, (w,))


def _near_tie(bs, u):
    """Rows whose block uniform lies within TIE of a cumulative boundary:
    f32 sums taken in another order may draw the neighbouring block."""
    c = np.cumsum(np.asarray(bs, np.float64), axis=1)
    tot = c[:, -1:]
    return (np.abs(np.asarray(u, np.float64)[:, None] * tot - c)
            <= TIE * tot).any(axis=1)


def _word(a):
    return np.asarray(a).astype(np.int64).tolist()


# --------------------------------------------------------------------- #
# programs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", sorted(SIZES))
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_masked_stratified_sums_match_reference(kind, layout):
    """``masked_block_sums(exact=False)``: the subsampled block sums, own
    block corrected and floored, at rtol 1e-4 (atol 1e-5 on the floored
    sums); the counter words equal."""
    n = SIZES[layout]
    x = _points(layout, n)
    xj, xj_sq, tx, tx_sq = _both(x)
    cfg = _cfg(kind, n)
    src = np.random.default_rng(1).integers(0, n, 64).astype(np.int32)
    key = jax.random.PRNGKey(stats.derive_seed("masked", kind, layout))
    rbs, rw = jops.masked_block_sums(xj, xj_sq, jnp.asarray(src), key,
                                     pairwise=None, s=S, exact=False, **cfg)
    bs, w = tops.masked_block_sums(
        tx, tx_sq, _t(src, torch.int64), _u(key, (cfg["num_blocks"], BS)),
        s=S, exact=False, pairwise=None, **cfg)
    np.testing.assert_allclose(bs.numpy(), np.asarray(rbs), rtol=RTOL,
                               atol=1e-5)
    assert _word(w) == _word(rw)
    assert int(w[1]) == 64 * cfg["num_blocks"] * S


@pytest.mark.parametrize("kind", ["gaussian", "laplacian"])
def test_stratified_fused_sample_matches_reference(kind):
    """One stratified depth-2 step: neighbors equal except at near-ties,
    realized probabilities and level-1 sums at rtol 2e-4, words equal."""
    n = SIZES["ragged"]
    x = _points("fused", n)
    xj, xj_sq, tx, tx_sq = _both(x)
    cfg = _cfg(kind, n)
    w = 96
    src = np.random.default_rng(2).integers(0, n, w).astype(np.int32)
    key = jax.random.PRNGKey(stats.derive_seed("fused", kind))
    rnb, rp, rbs, rw = jops.fused_sample(
        xj, xj_sq, jnp.asarray(src), key, pairwise=None, s=S, exact=False,
        use_pallas=False, interpret=False, bm=128, **cfg)
    noise = _step_noise(key, w, cfg["num_blocks"], BS)
    nb, p, bs, word = tops.fused_sample(tx, tx_sq, _t(src, torch.int64),
                                        *noise, s=S, exact=False,
                                        pairwise=None, **cfg)
    keep = ~_near_tie(rbs, noise[1].numpy())
    assert keep.sum() > w - 3
    np.testing.assert_array_equal(nb.numpy()[keep], np.asarray(rnb)[keep])
    np.testing.assert_allclose(p.numpy()[keep], np.asarray(rp)[keep],
                               rtol=2e-4)
    np.testing.assert_allclose(bs.numpy(), np.asarray(rbs), rtol=2e-4,
                               atol=1e-5)
    assert _word(word) == _word(rw)


@pytest.mark.parametrize("kind", ["gaussian", "laplacian"])
def test_stratified_fused_edge_batch_matches_reference(kind):
    """One Algorithm 5.1 edge batch on the stratified read, fed the
    reference's noise (``k_u, k_fwd``; ``k_l1, k_rest``; ``k_blk,
    k_in``): u equal, v equal except at near-ties, weights and both
    probabilities at rtol 2e-4, words equal."""
    n = SIZES["ragged"]
    x = _points("edge", n)
    xj, xj_sq, tx, tx_sq = _both(x)
    cfg = _cfg(kind, n)
    batch = 96
    deg = np.random.default_rng(3).uniform(1.0, 3.0, n)
    prefix = np.cumsum(deg)
    cdf = (prefix / prefix[-1]).astype(np.float32)
    degs = deg.astype(np.float32)
    key = jax.random.PRNGKey(stats.derive_seed("edge", kind))
    *want, rword = jops.fused_edge_batch(
        xj, xj_sq, jnp.asarray(cdf), jnp.asarray(degs), 1.0 / prefix[-1],
        1e-3, key, batch=batch, pairwise=None, s=S, exact=False,
        use_pallas=False, interpret=False, bm=128, **cfg)
    k_u, k_fwd = jax.random.split(key)
    noise = _step_noise(k_fwd, batch, cfg["num_blocks"], BS)
    *got, word = tops.fused_edge_batch(
        tx, tx_sq, torch.as_tensor(cdf), torch.as_tensor(degs),
        1.0 / prefix[-1], 1e-3, _u(k_u, (batch,)), *noise, s=S, exact=False,
        pairwise=None, **cfg)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # the forward step's block draw reads the sums of the u frontier
    rbs, _ = jops.masked_block_sums(xj, xj_sq, want[0], jax.random.split(
        k_fwd)[0], pairwise=None, s=S, exact=False, **cfg)
    keep = ~_near_tie(rbs, noise[1].numpy())
    assert keep.sum() > batch - 3
    np.testing.assert_array_equal(got[1].numpy()[keep],
                                  np.asarray(want[1])[keep])
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a.numpy()[keep], np.asarray(b)[keep],
                                   rtol=2e-4)
    assert _word(word) == _word(rword)


def _exact_noise(key, rounds, w):
    """``fused_sample_exact``'s noise from the reference's ``split(key,
    2 rounds + 1)``: round 0's (u_blk, u_in), then per round r the
    proposal's pair from keys[2r + 1] and u_acc from keys[2r + 2]."""
    keys = jax.random.split(key, 2 * rounds + 1)
    pairs = [jax.random.split(keys[0])] + [jax.random.split(keys[2 * r + 1])
                                           for r in range(rounds)]
    u_blk = np.stack([np.array(jax.random.uniform(k[0], (w,)))
                      for k in pairs])
    u_in = np.stack([np.array(jax.random.uniform(k[1], (w,)))
                     for k in pairs])
    u_acc = np.array([np.array(jax.random.uniform(keys[2 * r + 2], (w,)))
                      for r in range(rounds)], np.float32).reshape(rounds, w)
    return _t(u_blk), _t(u_in), _t(u_acc)


@pytest.mark.parametrize("rounds", [0, 1, 8])
def test_fused_sample_exact_matches_reference(rounds):
    """Theorem 4.12 rounds on the same cached stratified sums: neighbors,
    counter word (evals (rounds+1) w bs + rounds w, draws (rounds+1) w,
    retries = fallbacks) and fallback count equal the reference's at
    slack 2; round 0 keeps every proposal and flags REJECT_EXHAUSTED."""
    n = SIZES["ragged"]
    x = _points("exact", n)
    xj, xj_sq, tx, tx_sq = _both(x)
    cfg = _cfg("gaussian", n)
    w = 128
    src = np.random.default_rng(4).integers(0, n, w).astype(np.int32)
    rbs, _ = jops.masked_block_sums(xj, xj_sq, jnp.asarray(src),
                                    jax.random.PRNGKey(5), pairwise=None,
                                    s=S, exact=False, **cfg)
    key = jax.random.PRNGKey(stats.derive_seed("exact", rounds))
    l2 = {k: cfg[k] for k in ("kind", "inv_bw", "beta", "block_size", "n")}
    rcur, rword, rfb = jops.fused_sample_exact(
        xj, xj_sq, jnp.asarray(src), rbs, key, pairwise=None, rounds=rounds,
        slack=2.0, **l2)
    cur, word, fb = tops.fused_sample_exact(
        tx, tx_sq, _t(src, torch.int64), _t(rbs),
        *_exact_noise(key, rounds, w), rounds=rounds, slack=2.0, **l2)
    np.testing.assert_array_equal(cur.numpy(), np.asarray(rcur))
    assert _word(word) == _word(rword)
    assert int(fb) == int(rfb)
    assert int(word[4]) == int(fb)
    if rounds == 0:
        assert int(fb) == w and int(word[0]) & tguards.REJECT_EXHAUSTED


def test_fused_sample_exact_refuses_noise_of_other_rounds():
    x = _points("exact", 64)
    _, _, tx, tx_sq = _both(x)
    u = torch.rand(3, 8)
    with pytest.raises(ValueError, match="u_acc"):
        tops.fused_sample_exact(tx, tx_sq, torch.arange(8), torch.ones(8, 4),
                                u, u, u, rounds=2, slack=2.0,
                                kind="gaussian", inv_bw=1.0, beta=1.0,
                                block_size=16, n=64)


# --------------------------------------------------------------------- #
# the sampler
# --------------------------------------------------------------------- #
def test_stratified_prob_of_reproduces_sample():
    """``NeighborSampler`` with the reference's defaults (stratified,
    s = 16): ``prob_of`` on the frontier ``sample`` drew reads the cached
    random sums -- no second level-1 read -- and returns the realized
    probabilities; a frontier's probabilities over every destination sum
    to 1."""
    n = 400
    x = _points("prob_of", n)
    src = np.random.default_rng(6).integers(0, n, 150)
    nbr = NeighborSampler(x, gaussian(1.5), seed=1, device="cpu")
    assert not nbr.exact_blocks and nbr.blocks.samples_per_block == 16
    v, p = nbr.sample(src)
    assert np.all(v != src) and np.all(p > 0)
    before = nbr.evals
    np.testing.assert_allclose(nbr.prob_of(src, v), p, rtol=1e-5)
    assert nbr.evals - before == 150 * nbr.block_size
    nb, s, bs = nbr.num_blocks, 16, nbr.block_size
    assert nbr.evals == 150 * (nb * s + bs) + 150 * bs
    assert nbr.device_counters["evals"] == nbr.evals
    one = np.full(n, src[0])
    allp = nbr.prob_of(one, np.arange(n))
    assert allp.sum() == pytest.approx(1.0, rel=1e-5)


def test_stratified_edge_batches_counters_match_reference():
    """Edge batches on the stratified read (s = 8): the same analytic
    ``.evals`` and device counter totals as the reference's for the same
    static shapes; clean statuses."""
    n, t, batch = 150, 700, 256
    x = _points("edge_batches", n)
    deg = np.random.default_rng(7).uniform(1.0, 3.0, n)
    prefix = np.cumsum(deg)
    cdf = (prefix / prefix[-1]).astype(np.float32)
    degs = deg.astype(np.float32)
    ref = JNeighborSampler(x, jgaussian(1.5), samples_per_block=8, seed=0)
    ref.edge_batches(jnp.asarray(cdf), jnp.asarray(degs), prefix[-1], t,
                     batch=batch)
    port = NeighborSampler(x, gaussian(1.5), samples_per_block=8, seed=0,
                           device="cpu")
    out = port.edge_batches(torch.as_tensor(cdf), torch.as_tensor(degs),
                            prefix[-1], t, batch=batch)
    assert all(len(a) == t for a in out)
    drawn = 3 * batch
    assert port.evals == ref.evals == drawn * (
        port.num_blocks * 8 + port.block_size + 1)
    assert port.device_counters.as_dict() == ref.device_counters.as_dict()
    assert port.status == ref.status == 0


def test_sample_exact_destination_law():
    """``sample_exact`` (rounds 8, slack 2) on a stratified sampler at
    n = 512: each source's destinations follow k(u, .)/deg(u) by Pearson
    chi-square (alpha 1e-3, cells expecting < 5 pooled); the draws and
    fallbacks are counted and the evals follow the reference's formula."""
    n, reps, rounds = 512, 2500, 8
    x = _points("sample_exact", n)
    k = np.asarray(jax.jit(jgaussian(1.5).matrix)(jnp.asarray(x)),
                   np.float64)
    sources = np.array([3, 200, 511])
    src = np.repeat(sources, reps)
    nbr = NeighborSampler(x, gaussian(1.5), seed=9, device="cpu")
    v = nbr.sample_exact(src, rounds=rounds, slack=2.0)
    w = len(src)
    assert nbr.exact_draws == w and nbr.exact_fallbacks < 0.01 * w
    bs, nb = nbr.block_size, nbr.num_blocks
    assert nbr.evals == w * nb * 16 + (rounds + 1) * w * bs + rounds * w
    for i, u in enumerate(sources):
        got = np.bincount(v[i * reps:(i + 1) * reps], minlength=n)
        row = k[u].copy()
        row[u] = 0.0
        assert got[u] == 0
        live = np.arange(n) != u
        c, e = got[live], (reps * row / row.sum())[live]
        small = e < 5.0
        counts = np.append(c[~small], c[small].sum())
        exp = np.append(e[~small], e[small].sum())
        chi2 = stats.chi2_statistic(counts, exp)
        assert chi2 < stats.chi2_critical(len(counts) - 1), (u, chi2)


@pytest.mark.parametrize("args", [(5, 100, 8, 2.0), (50, 100, 8, 2.0),
                                  (100, 100, 0, 2.0), (1, 2000, 2, 1.0)])
def test_warn_fallback_rate_matches_reference(args):
    """Both packages warn on exactly the same fallback rates."""
    def warned(fn):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fn(*args, context="probe")
        return [str(r.message) for r in rec]
    assert warned(tguards.warn_fallback_rate) == \
        warned(jguards.warn_fallback_rate)


# --------------------------------------------------------------------- #
# the sparsifier
# --------------------------------------------------------------------- #
SP_N, SP_T, SP_BATCH, SP_BW = 40, 40960, 1024, 3.0


@pytest.fixture(scope="module")
def sparsified():
    """The reference's default call on each side: n = 40 is three level-1
    blocks of at most 16 rows, so s = 16 reads every row and the law of the
    drawn edges is the exact one."""
    x = _points("sparsify", SP_N)
    ref = jsparsify(x, jgaussian(SP_BW), SP_T)
    port = spectral_sparsify(x, gaussian(SP_BW), SP_T, device="cpu")
    k = np.asarray(jax.jit(jgaussian(SP_BW).matrix)(jnp.asarray(x)),
                   np.float64)
    return x, ref, port, k


def test_default_sparsify_counters_match_reference(sparsified):
    """kernel_evals = n B s + drawn (B s + bs + 1) and kde_queries = n +
    drawn, equal to the reference's; no status flag."""
    _, ref, port, _ = sparsified
    n, bs, nb, s = SP_N, 16, 3, 16
    drawn = -(-SP_T // SP_BATCH) * SP_BATCH
    assert port.kernel_evals == ref.kernel_evals \
        == n * nb * s + drawn * (nb * s + bs + 1)
    assert port.kde_queries == ref.kde_queries == n + drawn
    assert port.status == 0


def test_default_sparsify_edge_law(sparsified):
    """The drawn unordered edges follow q_e = 2 k(u, v) / sum deg (Pearson
    chi-square, alpha 1e-3), agree with the reference's edges in TV within
    the alpha 1e-3 two-sample bound, and the weights sum to the kernel
    mass at rtol 1e-4."""
    _, ref, port, k = sparsified
    iu = np.triu_indices(SP_N, 1)
    cell = np.full((SP_N, SP_N), -1)
    cell[iu] = np.arange(len(iu[0]))

    def counts(g):
        return np.bincount(cell[np.minimum(g.src, g.dst),
                                np.maximum(g.src, g.dst)],
                           minlength=len(iu[0]))
    kk = k[iu]
    expected = SP_T * kk / kk.sum()
    assert expected.min() > 5.0
    chi2 = stats.chi2_statistic(counts(port), expected)
    assert chi2 < stats.chi2_critical(len(kk) - 1, alpha=1e-3), chi2
    tv = stats.tv_distance(counts(port), counts(ref))
    assert tv < stats.tv_tolerance(len(kk), SP_T, SP_T), tv
    assert port.weight.sum() == pytest.approx(kk.sum(), rel=RTOL)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_default_sparsify_block_law():
    """At n = 2048 (s = 16 of 45 rows a block, so the level-1 read is an
    estimate) the check ``chip_smoke.py``'s stratified phase applies:
    sources by chi-square per level-1 block against the degrees the run
    drew them from, destinations by their in-block PITs (level 2 is
    exact); a source law that ignores the degrees fails it."""
    cs = _chip_smoke()
    n, bw = 2048, 1.0
    x = _points("block_law", n, d=8)
    g = spectral_sparsify(x, gaussian(bw), 10 * n, batch=1024,
                          device="cpu")
    bn = max(int(np.sqrt(n)), 16)
    cs.hash_edge_law(torch.as_tensor(x), bn, g, bw)
    uniform_src = dataclasses.replace(
        g, src=np.random.default_rng(0).integers(0, n, g.num_edges))
    with pytest.raises(AssertionError, match="sources"):
        cs.hash_edge_law(torch.as_tensor(x), bn, uniform_src, bw)


def test_default_sparsify_spectral_error():
    """The spectral error at the bound tool's config (n 1024, d 8,
    N(0, 0.35^2), gaussian at bandwidth 3.0, t = 16n) is within
    ``chip_smoke.STRAT_SPEC_BOUND``, 1.5x the reference's worst seed."""
    cs = _chip_smoke()
    n = cs.SPEC_N
    x = np.random.default_rng(0).normal(
        0, cs.SPEC_SIGMA, (n, cs.SPEC_D)).astype(np.float32)
    g = spectral_sparsify(x, gaussian(cs.SPEC_BW), 16 * n, seed=0,
                          device="cpu")
    k = np.asarray(jax.jit(jgaussian(cs.SPEC_BW).matrix)(jnp.asarray(x)),
                   np.float64)
    np.fill_diagonal(k, 0.0)
    lap = np.diag(k.sum(1)) - k
    err = cs.spectral_error(g.laplacian_dense(), lap)
    assert err <= cs.STRAT_SPEC_BOUND, err


@pytest.mark.parametrize("estimator,exact_blocks", [
    ("exact", False), ("rs", False), ("stratified", True),
    ("exact_block", False)])
def test_mixed_pairings_counters_match_reference(estimator, exact_blocks):
    """Degrees by a standalone estimator when the sampler's read does not
    implement it, as the reference builds it: the same kernel_evals and
    kde_queries."""
    x = _points("pairings", SP_N)
    t = 2048
    ref = jsparsify(x, jgaussian(SP_BW), t, estimator, 0, 1024,
                    exact_blocks)
    port = spectral_sparsify(x, gaussian(SP_BW), t, estimator, 0, 1024,
                             exact_blocks, device="cpu")
    assert (port.kernel_evals, port.kde_queries) == \
        (ref.kernel_evals, ref.kde_queries)
    assert port.status & tguards.FATAL == 0


def test_incidence_row_norms_match_reference():
    """2 k(u, v) over the upper triangle, as the reference's."""
    x = _points("incidence", 30)
    for jk, tk in KERNELS.values():
        np.testing.assert_allclose(incidence_row_norms(tk, x, device="cpu"),
                                   jincidence(jk, x), rtol=1e-6)


# --------------------------------------------------------------------- #
# the LRA's row-norm estimators
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["gaussian", "laplacian"])
def test_rskde_matches_reference(kind):
    """``RSKDE`` reads the reference's rows (one numpy generator, the same
    draws): queries at rtol 1e-5, the same evals, the same generator
    state after them; ``make_estimator("rs")`` has the reference's budget
    ceil(1 / (tau eps^2)) = 80, clamped to n."""
    jk, tk = KERNELS[kind]
    x = _points("rs", 300, d=7)
    y = _points("rs_q", 50, d=7)
    ref = JRSKDE(x, jk, num_samples=64, seed=5)
    port = RSKDE(x, tk, 64, 5, device="cpu")
    for _ in range(2):
        np.testing.assert_allclose(port.query(torch.as_tensor(y)).numpy(),
                                   np.asarray(ref.query(jnp.asarray(y))),
                                   rtol=1e-5)
    assert port.evals == ref.evals == 2 * 50 * 64
    assert port._rng.bit_generator.state == ref._rng.bit_generator.state
    for n in (300, 50):
        est = make_estimator("rs", x[:n], tk, seed=1, device="cpu")
        assert est.num_samples == jmake_estimator("rs", x[:n], jk,
                                                  seed=1).num_samples \
            == min(80, n)


@pytest.fixture(scope="module")
def lowrank_points():
    rng = np.random.default_rng(stats.derive_seed("torch_stratified", "lra"))
    return np.clip(rng.normal(0.3, 0.2, (256, 19)), 0, 1).astype(np.float32)


def test_rs_row_norms_match_reference(lowrank_points):
    """Squared row norms by the ``rs`` estimator over cX: the reference's
    at rtol 1e-5, the same evals (n x 80)."""
    x, bw = lowrank_points, 3.0
    ref = JRowNormSampler(x, jlaplacian(bw), estimator="rs", seed=0)
    port = RowNormSampler(x, laplacian(bw), estimator="rs", seed=0,
                          device="cpu")
    np.testing.assert_allclose(port.row_norms_sq, ref.row_norms_sq,
                               rtol=1e-5)
    assert port.evals == ref.evals == 256 * 80


def test_hash_row_norms_match_reference_counters(lowrank_points):
    """``RowNormSampler(estimator="hash")``: the reference's evals (the
    NEAR counts follow the bucket layout, built bit for bit on both
    sides), and squared row norms within 10% of the exact ones on average
    (the FAR samples come from each package's own generator)."""
    x, bw = lowrank_points, 3.0
    ref = JRowNormSampler(x, jlaplacian(bw), estimator="hash", seed=0)
    port = RowNormSampler(x, laplacian(bw), estimator="hash", seed=0,
                          device="cpu")
    exact = RowNormSampler(x, laplacian(bw), device="cpu")
    assert port.evals == ref.evals
    rel = np.abs(port.row_norms_sq / exact.row_norms_sq - 1.0)
    assert rel.mean() <= 0.1, rel.mean()


def test_fkv_lowrank_rs_matches_reference(lowrank_points):
    """``fkv_lowrank(estimator="rs")``: the reference's row indices and
    kernel_evals (n 80 + rows n), and its projection error within 1e-3
    relative."""
    x, bw = lowrank_points, 3.0
    ref = jfkv(x, jlaplacian(bw), rank=5, num_rows=50, estimator="rs",
               seed=0)
    port = fkv_lowrank(x, laplacian(bw), rank=5, num_rows=50,
                       estimator="rs", seed=0, device="cpu")
    np.testing.assert_array_equal(port.row_indices, ref.row_indices)
    assert port.kernel_evals == ref.kernel_evals == 256 * 80 + 50 * 256
    k = np.asarray(jax.jit(jlaplacian(bw).matrix)(jnp.asarray(x)),
                   np.float64)
    assert projection_error(k, port.u) == pytest.approx(
        projection_error(k, ref.u), rel=1e-3)


def test_fkv_lowrank_stratified_counters_and_row_norms():
    """``estimator="stratified"`` at n = 1024 (block size 256, B = 4, s =
    16): kernel_evals n B s + rows n, equal to the reference's; the
    estimated squared row norms within 10% of the exact ones on average
    (mean relative error), and their total, ||K||_F^2, within 10%.  A
    single row can miss by more: when its own point falls in its block's
    subsample, k(x, x)^2 = 1 is scaled by bs / s = 16 (31% on the worst
    row here; the reference's estimator does the same)."""
    rng = np.random.default_rng(stats.derive_seed("torch_stratified",
                                                  "lra_strat"))
    x = np.clip(rng.normal(0.3, 0.2, (1024, 19)), 0, 1).astype(np.float32)
    bw = 3.0
    port = fkv_lowrank(x, laplacian(bw), rank=5, num_rows=50,
                       estimator="stratified", seed=0, device="cpu")
    ref = jfkv(x, jlaplacian(bw), rank=5, num_rows=50,
               estimator="stratified", seed=0)
    assert port.kernel_evals == ref.kernel_evals == 1024 * 4 * 16 + 50 * 1024
    est = RowNormSampler(x, laplacian(bw), estimator="stratified", seed=0,
                         device="cpu")
    exact = RowNormSampler(x, laplacian(bw), device="cpu")
    rel = np.abs(est.row_norms_sq / exact.row_norms_sq - 1.0)
    assert rel.mean() <= 0.1, rel.mean()
    assert est.total == pytest.approx(exact.total, rel=0.1)


def test_countsketch_lowrank_matches_reference():
    """The same numpy draws: the reference's U within 1e-10."""
    a = np.random.default_rng(8).normal(size=(60, 60))
    k = a @ a.T
    np.testing.assert_allclose(countsketch_lowrank(k, 5, 32, seed=3),
                               jcountsketch(k, 5, 32, seed=3), rtol=0,
                               atol=1e-10)


# --------------------------------------------------------------------- #
# the package's public names
# --------------------------------------------------------------------- #
def _reference_exports():
    """(port module, name) of every name ``repro/core/__init__.py`` imports
    whose module the port has and defines it."""
    tree = ast.parse((ROOT / "src/repro/core/__init__.py").read_text())
    out = []
    for node in tree.body:
        if not isinstance(node, ast.ImportFrom):
            continue
        mod = node.module.replace("repro.", "repro_torch.", 1)
        if not (ROOT / "src" / (mod.replace(".", "/") + ".py")).exists():
            continue
        port = importlib.import_module(mod)
        out += [(mod, a.name) for a in node.names if hasattr(port, a.name)]
    return out


@pytest.mark.parametrize("mod,name", _reference_exports(),
                         ids=[n for _, n in _reference_exports()])
def test_ported_names_import_from_the_package(mod, name):
    """Every ported public name of ``repro.core`` is exported by
    ``repro_torch.core`` too, as the same object."""
    assert getattr(tcore, name) is getattr(importlib.import_module(mod),
                                           name)
