"""Random walks (Algorithm 4.16) and the grouped draws of the port against
the JAX reference on the CPU.

The reference draws its noise from keys; the tests derive the same
uniforms from those keys with the reference's own splits and hand them to
the port's explicit-noise programs:

- a walk splits its key into one key a step, and draws the walk-resident
  subsample from ``fold_in(keys[0], 97)``;
- a step on the cached layout: ``_, k_rest = split(k)``, ``k_blk, k_in =
  split(k_rest)``; on a hashed read the FAR offsets come from ``k_l1`` of
  ``k_l1, k_rest = split(k)``; on the exact read the port draws the block
  by Gumbel-max (the reference's kernel path): ``k_g, k_in =
  split(k_rest)``;
- with rejection rounds: ``k_l1, k_rs = split(k)``, then
  ``split(k_rs, 2 rounds + 1)``.

Indices then match exactly except at near-ties, and counter words slot
for slot.  The public API draws from a torch generator, so its walks are
held to the Markov law statistically and its counters to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.core.kernels_fn import gaussian as jgaussian
from repro.core.sampling.edge import NeighborSampler as JNeighborSampler
from repro.core.sampling.walks import random_walks as jrandom_walks
from repro.kernels import tuning as jtuning
from repro.kernels.kde_hash import ops as jhops
from repro.kernels.kde_sampler import ops as jops
from repro.kernels.kde_sampler import ref as jref
from repro_torch.convert import hash_state_from_reference
from repro_torch.core.kernels_fn import gaussian
from repro_torch.core.sampling.edge import NeighborSampler
from repro_torch.core.sampling.walks import endpoint_counts, random_walks
from repro_torch.kernels import tuning
from repro_torch.kernels.kde_sampler import ops as tops
from repro_torch.kernels.kde_sampler import ref as tref

BW, D = 1.5, 5
TIE = 1e-5


def _points(label, n, d=D):
    rng = np.random.default_rng(stats.derive_seed("torch_walks", label))
    return rng.normal(0, 0.5, (n, d)).astype(np.float32)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# --------------------------------------------------------------------- #
# the walk layout and the grouped draws
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n,bs,s", [(4096, 64, 16), (65536, 256, 16),
                                    (1048576, 1024, 16), (2000, 20, 16),
                                    (1990, 20, 16), (300, 17, 8)])
def test_walk_layout_is_the_references(n, bs, s):
    """The walk-resident layout and its cache width are the reference's,
    whose numbers fix the eval counters."""
    nb = -(-n // bs)
    assert tops.walk_layout(n, bs, nb, s) == jops.walk_layout(n, bs, nb, s)
    assert tops.walk_cache_samples(nb, s) == jops.walk_cache_samples(nb, s)
    assert tuning.walk_block_size(n, bs) == jtuning.walk_block_size(n, bs)
    assert tuning.walk_samples_per_block(nb, s) == \
        jtuning.walk_samples_per_block(nb, s)


def _near_tie(vals, u, rtol=TIE):
    """Rows where u * total lies within rtol * total of a partial sum of
    ``vals`` (flat order): the inverse CDF may take either side there."""
    c = np.cumsum(np.asarray(vals, np.float64), axis=1)
    t = np.asarray(u, np.float64) * c[:, -1]
    return (np.abs(c - t[:, None]) <= rtol * c[:, -1:]).any(axis=1)


@pytest.mark.parametrize("m", [64, 97, 120, 1024])
def test_grouped_draws_match_reference(m):
    """``grouped_inverse_cdf``, ``choose_block_grouped`` and
    ``level2_draw_grouped`` (with all-zero rows falling back to uniform
    over the live columns) take the reference's index on every row but
    near-ties, and agree with the flat search there too."""
    rng = np.random.default_rng(stats.derive_seed("torch_walks", "grp", m))
    w = 600
    vals = rng.exponential(size=(w, m)).astype(np.float32)
    vals[rng.uniform(size=(w, m)) < 0.3] = 0.0
    vals[:5] = 0.0                                  # dead rows
    live = rng.uniform(size=(w, m)) < 0.9
    live[:, 0] = True
    u = rng.uniform(size=w).astype(np.float32)
    g = tref.cdf_group(m)
    assert g == jref.cdf_group(m)
    use = np.where(vals.sum(1, keepdims=True) > 0, vals,
                   live.astype(np.float32))
    tie = _near_tie(use, u)
    assert tie.mean() < 0.05

    got = tref.grouped_inverse_cdf(_t(use), _t(u), g)
    want = jref.grouped_inverse_cdf(jnp.asarray(use), jnp.asarray(u), g)
    np.testing.assert_array_equal(got[0].numpy()[~tie],
                                  np.asarray(want[0])[~tie])
    flat = (u[:, None] * np.cumsum(use, 1)[:, -1:]
            > np.cumsum(use, 1)).sum(1).clip(0, m - 1)
    np.testing.assert_array_equal(got[0].numpy()[~tie], flat[~tie])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6)

    ok = vals.sum(1) > 0
    blk, pb = tref.choose_block_grouped(_t(vals[ok]), _t(u[ok]), g)
    jkey = jax.random.PRNGKey(3)
    jb, jp = jref.choose_block_grouped(jnp.asarray(vals[ok]), jkey, g)
    ju = np.asarray(jax.random.uniform(jkey, (int(ok.sum()),)))
    blk2, pb2 = tref.choose_block_grouped(_t(vals[ok]), _t(ju), g)
    t2 = _near_tie(vals[ok], ju)
    np.testing.assert_array_equal(blk2.numpy()[~t2], np.asarray(jb)[~t2])
    np.testing.assert_allclose(pb2.numpy()[~t2], np.asarray(jp)[~t2],
                               rtol=1e-5)
    assert torch.all(pb > 0)

    cols = np.arange(m)[None, :] + 10000 * np.arange(w)[:, None]
    kv = np.where(live, vals, 0.0).astype(np.float32)
    use2 = np.where(kv.sum(1, keepdims=True) > 0, kv,
                    live.astype(np.float32))
    t3 = _near_tie(use2, u)
    nb_, pin = tref.level2_draw_grouped(_t(kv), _t(live), _t(cols), _t(u), g)
    jn, jpin = jref.level2_draw_grouped(jnp.asarray(kv), jnp.asarray(live),
                                        jnp.asarray(cols), jnp.asarray(u), g)
    np.testing.assert_array_equal(nb_.numpy()[~t3], np.asarray(jn)[~t3])
    np.testing.assert_allclose(pin.numpy()[~t3], np.asarray(jpin)[~t3],
                               rtol=1e-5)
    assert np.all(live[np.arange(w), nb_.numpy() % 10000])


# --------------------------------------------------------------------- #
# walk_scan against the reference's program, fed its noise
# --------------------------------------------------------------------- #
#: n, block size, s, level-1 read, exact read, rejection rounds.  The
#: walk-layout cases have B s > WALK_CACHE_COLS, so the walk-resident
#: layout (64-row strata) differs from the sampler's (20-row blocks); at
#: n = 1990 its tail stratum has 6 rows, fewer than s_eff = 16.
WALKS = {
    "stratified": (400, 20, 8, "blocked", False, 0),
    "stratified_walk_layout": (2000, 20, 16, "blocked", False, 0),
    "stratified_walk_layout_ragged": (1990, 20, 16, "blocked", False, 0),
    "stratified_walk_layout_rounds": (2000, 20, 16, "blocked", False, 4),
    "exact_rounds": (400, 20, 8, "blocked", True, 4),
    "exact": (400, 20, 8, "blocked", True, 0),
    "hash": (400, 20, 8, "hash", False, 0),
    "hash_rounds": (400, 20, 8, "hash", False, 3),
}
NUM_FAR, W, T_STEPS = 2, 32, 4


def _u(key, shape):
    return _t(jax.random.uniform(key, shape))


def _step_noise(k, *, w, nb, bs, level1, exact, rounds, cached):
    """One step's noise, derived from the step key as the reference
    splits it (module note)."""
    if rounds:
        k_l1, k_rs = jax.random.split(k)
        ks = jax.random.split(k_rs, 2 * rounds + 1)
        pairs = [jax.random.split(ks[0])] + [jax.random.split(ks[2 * r + 1])
                                             for r in range(rounds)]
        l1 = (_t(jax.random.randint(k_l1, (w, nb, NUM_FAR), 0, bs),
                 torch.int64) if level1 == "hash" else None)
        return (l1, torch.stack([_u(a, (w,)) for a, _ in pairs]),
                torch.stack([_u(b, (w,)) for _, b in pairs]),
                torch.stack([_u(ks[2 * r + 2], (w,)) for r in range(rounds)]))
    k_l1, k_rest = jax.random.split(k)
    k_a, k_in = jax.random.split(k_rest)
    if cached:
        return _u(k_a, (w,)), _u(k_in, (w,))
    if level1 == "hash":
        return (_t(jax.random.randint(k_l1, (w, nb, NUM_FAR), 0, bs),
                   torch.int64), _u(k_a, (w,)), _u(k_in, (w,)))
    return _t(jax.random.gumbel(k_a, (w, nb))), _u(k_in, (w,))


def _gumbel_walk_oracle(xj, starts, keys, *, bs, n):
    """The reference's kernel-path walk (Gumbel-max block draw over the
    exact masked sums, then the exact level-2 row and in-block draw) on
    its jnp oracles, step by step."""
    x_sq = jnp.sum(xj * xj, -1)
    views = jref.block_views(xj, x_sq, bs)
    cur, path = jnp.asarray(starts, jnp.int32), []
    for k in keys:
        _, k_rest = jax.random.split(k)
        k_g, k_in = jax.random.split(k_rest)
        bsum = jref.masked_exact_sums_ref(xj[cur], xj, x_sq, cur // bs,
                                          "gaussian", 1.0 / BW, 1.0, bs, n)
        g = jax.random.gumbel(k_g, bsum.shape)
        blk = jnp.argmax(jnp.log(bsum) + g, axis=1).astype(jnp.int32)
        kv, live, cols = jref.level2_row(xj, x_sq, views, cur, blk,
                                         "gaussian", 1.0 / BW, 1.0, bs, n)
        cur, _ = jref.level2_draw(kv, live, cols, jax.random.uniform(
            k_in, (cur.shape[0],)))
        path.append(cur)
    return np.asarray(cur), np.stack([np.asarray(p) for p in path])


@pytest.mark.parametrize("case", sorted(WALKS))
def test_walk_scan_matches_reference(case):
    """Endpoints, path and counter word of ``walk_scan`` equal the
    reference's on every read (the exact read against its kernel path's
    Gumbel-max draws on the jnp oracles; its word against the jnp
    program's, which counts the same static shapes), and
    ``record_path=False`` gives the same endpoints."""
    n, bs, s, level1, exact, rounds = WALKS[case]
    nb = -(-n // bs)
    x = _points(case, n)
    xj = jnp.asarray(x)
    starts = np.random.default_rng(
        stats.derive_seed("torch_walks", case, "starts")).integers(0, n, W)
    keys = jax.random.split(jax.random.PRNGKey(
        stats.derive_seed("torch_walks", case, "key")), T_STEPS)
    jstate = tstate = None
    if level1 == "hash":
        jstate, _ = jhops.build_hash_state(x, jgaussian(BW), max_bucket=32,
                                           seed=11)
        tstate = hash_state_from_reference(jstate, device="cpu")
    cfg = dict(kind="gaussian", inv_bw=1.0 / BW, beta=1.0, block_size=bs,
               num_blocks=nb, n=n, s=s, exact=exact, rounds=rounds,
               slack=2.0, level1=level1, num_far=NUM_FAR)
    end, path, word, fb = jops.walk_scan(
        xj, jnp.sum(xj * xj, -1), jnp.asarray(starts, jnp.int32), keys,
        jstate, pairwise=None, use_pallas=False, interpret=False,
        bm=32 if level1 == "hash" else 128, record_path=True, **cfg)
    cached = tops.walk_cached(level1, exact)
    cache_u = None
    if cached:
        wbs, w_blocks, _ = tops.walk_layout(n, bs, nb, s)
        cache_u = _u(jax.random.fold_in(keys[0], 97), (w_blocks, wbs))
    steps = [_step_noise(k, w=W, nb=nb, bs=bs, level1=level1, exact=exact,
                         rounds=rounds, cached=cached) for k in keys]
    tx = torch.as_tensor(x)
    args = (tx, (tx * tx).sum(-1), torch.as_tensor(starts),
            (cache_u, steps), tstate)
    t_end, t_path, t_word, t_fb = tops.walk_scan(*args, record_path=True,
                                                 pairwise=None, **cfg)
    if exact and not rounds:
        end, path = _gumbel_walk_oracle(xj, starts, keys, bs=bs, n=n)
    np.testing.assert_array_equal(t_path.numpy(), np.asarray(path))
    np.testing.assert_array_equal(t_end.numpy(), np.asarray(end))
    np.testing.assert_array_equal(t_word.numpy(),
                                  np.asarray(word).astype(np.int64))
    assert int(t_fb) == int(fb) == int(t_word[4])
    t_end2, no_path, t_word2, _ = tops.walk_scan(*args, record_path=False,
                                                 pairwise=None, **cfg)
    assert no_path is None
    np.testing.assert_array_equal(t_end2.numpy(), t_end.numpy())
    np.testing.assert_array_equal(t_word2.numpy(), t_word.numpy())


# --------------------------------------------------------------------- #
# the public API
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def graph():
    """The reference's walk-law graph (tests/test_sampling.py)."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 0.5, (400, 5)).astype(np.float32)
    k = gaussian(BW).matrix(torch.as_tensor(x)).double().numpy()
    return x, k


#: sampler options and whether the walk is rejection-exact
LAW_READS = {"exact_blocks": (dict(exact_blocks=True), False),
             "stratified_exact": (dict(samples_per_block=8), True),
             "hash_exact": (dict(level1="hash"), True)}


@pytest.mark.parametrize("read", sorted(LAW_READS))
def test_walk_endpoints_follow_the_markov_chain(graph, read):
    """Theorem 4.15: 20,000 walks of 3 steps from vertex 0 end by
    e_0 M^3 (M = D^-1 K off the diagonal) within the reference's TV bound
    3 sqrt(n / 20000) (tests/test_sampling.py), on the exact read and, with
    the rejection rounds, on the stratified and hashed reads."""
    x, k = graph
    koff = k.copy()
    np.fill_diagonal(koff, 0)
    m = koff / koff.sum(1, keepdims=True)
    p_true = np.linalg.matrix_power(m.T, 3) @ np.eye(len(k))[0]
    opts, exact = LAW_READS[read]
    nb = NeighborSampler(x, gaussian(BW), seed=0, device="cpu", **opts)
    ends = random_walks(nb, np.zeros(20000, np.int64), 3, exact=exact)
    emp = np.bincount(ends, minlength=len(k)) / 20000
    assert 0.5 * np.abs(emp - p_true).sum() < 3.0 * np.sqrt(len(k) / 20000)


#: sampler options of the counter cases; the walk-layout one has B s >
#: 1024, so its per-step count is the walk layout's
COUNT_READS = {
    "exact_blocks": (400, dict(exact_blocks=True)),
    "stratified": (400, dict(samples_per_block=8)),
    "stratified_walk_layout": (2000, dict(block_size=20)),
    "hash": (400, dict(level1="hash")),
}


@pytest.mark.parametrize("exact", [False, True], ids=["plain", "rounds"])
@pytest.mark.parametrize("read", sorted(COUNT_READS))
def test_walk_counters_match_reference(read, exact):
    """``evals`` after a walk equals the reference sampler's after the
    same walk (the same analytic count, including the walk layout's), and
    the device words fold to the same evals and draws."""
    n, opts = COUNT_READS[read]
    x = _points("count_" + read, n)
    starts = np.arange(24, dtype=np.int64) * 7 % n
    port = NeighborSampler(x, gaussian(BW), seed=1, device="cpu", **opts)
    ref = JNeighborSampler(x, jgaussian(BW), seed=1, **opts)
    ends, path = port.walk(starts, 5, exact=exact, rounds=3,
                           record_path=True)
    ref.walk(starts, 5, exact=exact, rounds=3)
    assert port.evals == ref.evals
    assert port.device_counters["evals"] == port.evals
    assert port.device_counters["draws"] == ref.device_counters["draws"]
    assert port.device_counters["l1_reads"] == \
        ref.device_counters["l1_reads"]
    assert path.shape == (5, 24) and np.array_equal(path[-1], ends)
    if exact:
        assert port.exact_draws == ref.exact_draws == 24 * 5
        assert port.exact_fallbacks == port.device_counters["retries"]


def test_random_walks_record_path_and_same_endpoints(graph):
    """``random_walks`` prepends the starts to the path; every step moves
    to another vertex; ``record_path=False`` on a sampler of the same seed
    gives the same endpoints (the same noise), as in the reference."""
    x, _ = graph
    starts = np.arange(48, dtype=np.int64)
    a = NeighborSampler(x, gaussian(BW), exact_blocks=True, seed=9,
                        device="cpu")
    ends, path = random_walks(a, starts, 6, record_path=True)
    assert path.shape == (7, 48)
    np.testing.assert_array_equal(path[0], starts)
    np.testing.assert_array_equal(path[-1], ends)
    assert np.all(path[1:] != path[:-1])
    b = NeighborSampler(x, gaussian(BW), exact_blocks=True, seed=9,
                        device="cpu")
    np.testing.assert_array_equal(random_walks(b, starts, 6), ends)
    z, zp = random_walks(b, starts, 0, record_path=True)
    np.testing.assert_array_equal(z, starts)
    assert zp.shape == (1, 48)
    ref = JNeighborSampler(x, jgaussian(BW), exact_blocks=True, seed=9)
    rz, rzp = jrandom_walks(ref, starts, 0, record_path=True)
    np.testing.assert_array_equal(zp, rzp)
    counts = endpoint_counts(b, 3, 2, 500, len(x))
    assert counts.shape == (len(x),) and counts.sum() == 500


@pytest.mark.parametrize("case", ["stratified_walk_layout_rounds", "exact",
                                  "hash"])
def test_walk_scan_reads_nothing_on_the_host(case, monkeypatch):
    """No step of ``walk_scan`` reads a tensor's value on the host (no
    ``.item()``, ``bool(tensor)``, ``int(tensor)`` or numpy copy), so a
    walk on the card queues all its steps without a synchronisation: the
    same program runs with those reads made to raise."""
    n, bs, s, level1, exact, rounds = WALKS[case]
    nb = -(-n // bs)
    x = torch.as_tensor(_points(case, n))
    state = None
    if level1 == "hash":
        state = hash_state_from_reference(jhops.build_hash_state(
            x.numpy(), jgaussian(BW), max_bucket=32, seed=11)[0],
            device="cpu")
    gen = torch.Generator().manual_seed(5)
    cfg = dict(kind="gaussian", inv_bw=1.0 / BW, beta=1.0, block_size=bs,
               num_blocks=nb, n=n, s=s, exact=exact, level1=level1,
               num_far=NUM_FAR)
    noise = tops.draw_walk_noise(T_STEPS, W, nb, gen, "cpu", rounds=rounds,
                                 **{k: cfg[k] for k in ("level1", "exact",
                                                        "num_far", "n", "s",
                                                        "block_size")})
    starts = torch.randint(0, n, (W,), generator=gen)

    def refuse(*_):
        raise AssertionError("host read of a tensor inside walk_scan")

    for name in ("item", "__bool__", "__int__", "__float__", "numpy",
                 "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    end, path, word, fb = tops.walk_scan(x, (x * x).sum(-1), starts, noise,
                                         state, rounds=rounds, slack=2.0,
                                         pairwise=None, **cfg)
    monkeypatch.undo()
    assert path.shape == (T_STEPS, W) and torch.equal(path[-1], end)
    assert int(word[4]) == int(fb)
