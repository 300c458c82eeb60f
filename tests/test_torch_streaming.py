"""The port's streaming engine (``core/dataset.py``, the patch-on-read
consumers, the hashed overflow region, ``StreamingKernelGraph``) against
the JAX reference on the same numpy inputs and the same mutation
sequences (``_mutate`` is tests/test_streaming.py's).

The dataset, the journal's coalesced batches and the patched hash layout
are host numpy on both sides: bitwise.  Patched level-1 sums and
``prob_of`` (exact read) at the reference test's rtol 2e-5 / atol 1e-7,
degrees and row norms at rtol 5e-4 / atol 5e-5.  Randomized reads (FAR
draws, stratified subsamples) are compared where their noise is shared
(the reference's FAR draws fed to the port's explicit-noise query) or
through their counters, which are functions of the layouts and shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dataset import DynamicDataset as JDynamicDataset
from repro.core.dataset import coalesce_mutations as jcoalesce
from repro.core.kernels_fn import gaussian as jgaussian
from repro.core.sampling.edge import NeighborSampler as JNeighborSampler
from repro.core.sampling.rownorm import RowNormSampler as JRowNormSampler
from repro.core.sampling.vertex import DegreeSampler as JDegreeSampler
from repro.core.streaming import StreamingKernelGraph as JStreamingGraph
from repro.ft import guards as jguards
from repro.kernels.kde_hash import ops as jhops
from repro.kernels.kde_sampler import ref as jref
from repro_torch.core.dataset import DynamicDataset, coalesce_mutations
from repro_torch.core.kde.hashed import HashedKDE
from repro_torch.core.kernels_fn import gaussian
from repro_torch.core.sampling.edge import NeighborSampler
from repro_torch.core.sampling.rownorm import RowNormSampler
from repro_torch.core.sampling.vertex import (DegreeSampler,
                                              streaming_degrees)
from repro_torch.core.streaming import StreamingKernelGraph
from repro_torch.ft import guards as tguards
from repro_torch.kernels.kde_hash import ops as thops
from repro_torch.kernels.kde_hash import ref as thref
from repro_torch.kernels.kde_sampler import ops as tops
from repro_torch.kernels.kde_sampler import ref as tref

_patch_ref = jax.jit(jref.patch_block_sums_ref, static_argnums=(5, 6, 7, 8))
_delta_ref = jax.jit(jref.degree_delta_ref, static_argnums=(8, 9, 10))


def _x0(n=192, d=6, seed=0):
    return np.random.default_rng(seed).normal(0, 0.7, (n, d)).astype(
        np.float32)


def _pair(x0, **kw):
    """The same dataset on both sides (the port's on the CPU)."""
    return JDynamicDataset(x0, **kw), DynamicDataset(x0, device="cpu", **kw)


def _mutate(ds, rng, n_ins=5, dele=(40, 44), upd=(50, 52), keep=()):
    """One standard interleaving: insert a few, delete a range (minus any
    ``keep`` slots a test still holds as a frontier), move two."""
    ins = rng.normal(0, 0.7, size=(n_ins, ds.d)).astype(np.float32)
    slots = ds.insert_rows(ins)
    dead = np.setdiff1d(np.arange(*dele), np.asarray(keep, np.int64))
    ds.delete_rows(dead)
    us = np.setdiff1d(np.arange(*upd), dead)
    ds.update_rows(us, rng.normal(0, 0.7, size=(len(us), ds.d))
                   .astype(np.float32))
    return slots


def _mutate_both(jds, tds, seed, **kw):
    _mutate(jds, np.random.default_rng(seed), **kw)
    _mutate(tds, np.random.default_rng(seed), **kw)


def _same_dataset(jds, tds):
    np.testing.assert_array_equal(tds.x_pad.numpy(), np.asarray(jds.x_pad))
    np.testing.assert_array_equal(tds.live_host, jds.live_host)
    np.testing.assert_array_equal(tds.live_dev.numpy(),
                                  np.asarray(jds.live_dev))
    assert tds.epoch == jds.epoch and tds.capacity == jds.capacity


def _same_coalesced(jds, tds, epoch):
    jb, tb = jds.mutations_since(epoch), tds.mutations_since(epoch)
    assert (jb is None) == (tb is None)
    if jb is None:
        return
    for a, b in zip(coalesce_mutations(tb), jcoalesce(jb)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# the dataset
# --------------------------------------------------------------------- #
def test_dataset_matches_reference_bitwise():
    """The same mutation sequence gives the same padded rows (sentinels
    included), liveness, epochs and coalesced journal slices as the
    reference -- through journal overflow, ``compact`` and a capacity
    growth."""
    x0 = _x0()
    jds, tds = _pair(x0, capacity=256, journal_limit=4)
    _same_dataset(jds, tds)
    for i in range(3):
        _mutate_both(jds, tds, i, dele=(40 + 4 * i, 44 + 4 * i),
                     upd=(70 + 2 * i, 72 + 2 * i))
        _same_dataset(jds, tds)
        for e in range(tds.epoch + 1):
            _same_coalesced(jds, tds, e)
    assert tds.mutations_since(0) is None           # past journal_limit
    np.testing.assert_array_equal(tds.live_slots(), jds.live_slots())
    np.testing.assert_array_equal(tds.live_x()[0].numpy(),
                                  np.asarray(jds.live_x()[0]))
    assert tds.is_live([0, 1]) and not tds.is_live([40])
    tds.compact()
    jds.compact()
    _same_dataset(jds, tds)
    assert tds.mutations_since(tds.epoch - 1) is None
    big = np.random.default_rng(9).normal(0, 1, (80, 6)).astype(np.float32)
    np.testing.assert_array_equal(tds.insert_rows(big), jds.insert_rows(big))
    _same_dataset(jds, tds)                         # grown: doubled
    with pytest.raises(ValueError, match="not live"):
        tds.delete_rows([tds.capacity - 1])
    with pytest.raises(ValueError, match="duplicate"):
        tds.update_rows([1, 1], big[:2])


def test_coalesce_telescopes():
    """Old side = first touch, new side = last touch (the middle hop
    cancels), as the reference's."""
    ds = DynamicDataset(_x0(), capacity=256, device="cpu")
    first = ds.x_pad[5].numpy().copy()
    x0 = _x0()
    ds.update_rows(np.array([5]), x0[10:11] + 1.0)
    ds.update_rows(np.array([5]), x0[10:11] + 2.0)
    ds.delete_rows(np.array([9]))
    slots, old_x, new_x, old_live, new_live = \
        coalesce_mutations(ds.mutations_since(0))
    assert list(slots) == [5, 9]
    np.testing.assert_array_equal(old_x[0], first)
    np.testing.assert_array_equal(new_x[0], x0[10] + 2.0)
    assert old_live[0] and new_live[0] and old_live[1] and not new_live[1]
    # the journal's host copies are not views of the scattered tensor
    assert ds.mutations_since(0)[0].old_x[0, 0] == first[0]


def test_dead_slots_carry_zero_mass():
    """A deleted slot sits at the sentinel: its squared norm is inf and
    every kernel value against it is exactly 0 in every read."""
    ds = DynamicDataset(_x0(), capacity=256, device="cpu")
    ds.delete_rows(np.array([7, 100]))
    assert torch.isinf(ds.x_sq_pad[7]) and torch.isinf(ds.x_sq_pad[200])
    kv = tref.kv_matrix(ds.x_pad[:4], ds.x_pad, ds.x_sq_pad, "gaussian",
                        1.0, 1.0)
    assert float(kv[:, 7].abs().max()) == 0.0
    assert torch.isfinite(kv).all()


# --------------------------------------------------------------------- #
# patch programs against the reference's oracles
# --------------------------------------------------------------------- #
def _delta_inputs(seed=0):
    x0 = _x0(seed=seed)
    jds, tds = _pair(x0, capacity=256)
    e0 = tds.epoch
    _mutate_both(jds, tds, seed)
    slots, old_x, new_x, old_live, new_live = \
        coalesce_mutations(tds.mutations_since(e0))
    return jds, tds, slots, old_x, new_x, old_live, new_live


def test_patch_block_sums_matches_reference_oracle():
    jds, tds, slots, old_x, new_x, _, _ = _delta_inputs(1)
    rng = np.random.default_rng(2)
    src = np.arange(16)
    bs = (rng.random((16, 16)) * 3.0 + 0.5).astype(np.float32)
    want = _patch_ref(jnp.asarray(bs), jnp.asarray(np.asarray(jds.x_pad)[src]),
                      jnp.asarray(slots), jnp.asarray(old_x),
                      jnp.asarray(new_x), "gaussian", 1.0, 1.0, 16)
    got, word = tops.patch_block_sums(
        torch.as_tensor(bs), tds.x_pad, torch.as_tensor(src),
        torch.as_tensor(slots.astype(np.int64)), torch.as_tensor(old_x),
        torch.as_tensor(new_x), kind="gaussian", inv_bw=1.0, beta=1.0,
        block_size=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-7)
    assert int(word[1]) == 2 * 16 * len(slots)


def _delta(tds, degs, slots, old_x, new_x, old_live, new_live):
    return tops.degree_delta(
        torch.as_tensor(degs), tds.x_pad, tds.x_sq_pad,
        torch.as_tensor(slots.astype(np.int64)), torch.as_tensor(old_x),
        torch.as_tensor(new_x), torch.as_tensor(old_live),
        torch.as_tensor(new_live), kind="gaussian", inv_bw=1.0, beta=1.0)


def test_degree_delta_matches_reference_oracle_and_is_stable(monkeypatch):
    """``degree_delta`` equals the reference's ``degree_delta_ref`` (rtol
    5e-4 / atol 5e-5) and the fresh ``live_degrees_ref`` of the mutated
    dataset; two calls are bitwise equal, and a chunked sweep (8 columns
    a chunk) agrees with the one-chunk sweep, itself bitwise stable."""
    jds, tds, slots, old_x, new_x, old_live, new_live = _delta_inputs(3)
    x_old = DynamicDataset(_x0(seed=3), capacity=256, device="cpu")
    degs = tref.live_degrees_ref(
        x_old.x_pad, x_old.x_sq_pad, x_old.live_dev, "gaussian", 1.0,
        1.0).numpy()
    want = _delta_ref(jnp.asarray(degs), jds.x_pad, jds.x_sq_pad,
                      jnp.asarray(slots), jnp.asarray(old_x),
                      jnp.asarray(new_x), jnp.asarray(old_live),
                      jnp.asarray(new_live), "gaussian", 1.0, 1.0)
    args = (tds, degs, slots, old_x, new_x, old_live, new_live)
    got, word = _delta(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                               atol=5e-5)
    fresh = tref.live_degrees_ref(tds.x_pad, tds.x_sq_pad, tds.live_dev,
                                  "gaussian", 1.0, 1.0)
    np.testing.assert_allclose(got.numpy(), fresh.numpy(), rtol=5e-4,
                               atol=5e-5)
    assert int(word[1]) == 2 * len(slots) * 256
    assert float(got[41]) == 0.0                # deleted: no degree mass
    torch.testing.assert_close(_delta(*args)[0], got, rtol=0, atol=0)
    monkeypatch.setattr(tops, "DELTA_BUDGET", 8 * len(slots))
    chunked = _delta(*args)[0]
    torch.testing.assert_close(_delta(*args)[0], chunked, rtol=0, atol=0)
    np.testing.assert_allclose(chunked.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------- #
# the hashed layout: live rows, overflow region, patches
# --------------------------------------------------------------------- #
HKW = dict(max_bucket=8, seed=5, overflow_cap=16)


def _hash_pair(jds, tds, **kw):
    kw = {**HKW, **kw}
    jstate, jw = jhops.build_hash_state(jds.x_pad, jgaussian(1.0),
                                        live=jds.live_host, **kw)
    tstate, tw = thops.build_hash_state(tds.x_pad, gaussian(1.0),
                                        live=tds.live_host, device="cpu",
                                        **kw)
    assert jw == tw
    return jstate, tstate, tw


def _same_state(tstate, jstate):
    for name in ("members", "counts", "point_bucket", "self_stored",
                 "overflow", "keys", "truncated"):
        np.testing.assert_array_equal(
            getattr(tstate, name).numpy(),
            np.asarray(getattr(jstate, name)).astype(
                getattr(tstate, name).numpy().dtype), err_msg=name)


def test_hash_patcher_matches_reference():
    """``build_hash_state(live=, overflow_cap=)`` and ``HashPatcher``:
    after deletes, an update into the same cell, inserts into existing
    cells and isolated inserts (the overflow region), the patched member
    table, counts, per-point buckets, self-stored flags and overflow equal
    the reference's patched state; then ``hashed_query`` on the patched
    states under the reference's FAR draw: estimates at rtol 2e-4, NEAR
    counts exactly, FAR samples that hit overflow rows among them."""
    x0 = _x0()
    jds, tds = _pair(x0, capacity=256)
    jstate, tstate, w = _hash_pair(jds, tds)
    _same_state(tstate, jstate)
    jp, tp = jhops.HashPatcher(jstate, w), thops.HashPatcher(tstate, w)
    e0 = tds.epoch
    iso = (x0[:6] + 37.0 + np.arange(6)[:, None] * 5.0).astype(np.float32)
    for ds in (jds, tds):
        ds.delete_rows(np.arange(40, 56))
        ds.update_rows(np.array([3]), np.asarray(ds.x_pad[3:4]))
        ds.insert_rows(x0[100:104] + 0.01)
        ds.insert_rows(iso)
    batch = coalesce_mutations(tds.mutations_since(e0))
    jstate = jp.apply(jstate, *jcoalesce(jds.mutations_since(e0)))
    tstate = tp.apply(tstate, *batch)
    _same_state(tstate, jstate)
    assert (tp.flags, tp.needs_rebuild, tp.exact_parity) == \
        (jp.flags, jp.needs_rebuild, jp.exact_parity)
    assert tp.overflow_fill == jp.overflow_fill >= 6
    m, nf, n = 64, 32, tds.n
    y = np.concatenate([x0[:40], iso, x0[104:122]]).astype(np.float32)
    key = jax.random.PRNGKey(123)
    cfg = dict(kind="gaussian", inv_bw=1.0, beta=1.0, cell_width=w,
               num_far=nf, n=n)
    je, jc, _ = jhops.hashed_query(jds.x_pad, jnp.asarray(y), jstate, key,
                                   pairwise=None, **cfg)
    fidx = torch.as_tensor(np.asarray(
        jax.random.randint(key, (m, nf), 0, n)).astype(np.int32))
    te, tc, word = thops.hashed_query(tds.x_pad, torch.as_tensor(y), tstate,
                                      fidx, **cfg)
    assert bool(thref._far_hits_overflow(fidx, tstate).any())
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=2e-4,
                               atol=1e-5)
    assert int(word[6]) == m * HKW["overflow_cap"]


def test_hash_patcher_saturates_like_reference():
    """An overflow region of 2 slots and 3 isolated inserts: both sides
    flag ``OVERFLOW_SATURATED`` and ask for a rebuild, leaving the state
    untouched."""
    x0 = _x0()
    jds, tds = _pair(x0, capacity=256)
    jstate, tstate, w = _hash_pair(jds, tds, overflow_cap=2)
    jp, tp = jhops.HashPatcher(jstate, w), thops.HashPatcher(tstate, w)
    before = tstate.members.clone()
    for ds in (jds, tds):
        ds.insert_rows((x0[:3] + 50.0 + np.arange(3)[:, None] * 9.0)
                       .astype(np.float32))
    jp.apply(jstate, *jcoalesce(jds.mutations_since(0)))
    tp.apply(tstate, *coalesce_mutations(tds.mutations_since(0)))
    assert tp.needs_rebuild and jp.needs_rebuild
    assert tp.flags == jp.flags == tguards.OVERFLOW_SATURATED
    assert torch.equal(tstate.members, before)


def test_hashed_patch_parity_same_noise():
    """A patched ``HashedKDE(dataset=)`` state answers like a fresh
    ``build_hash_state`` at the new epoch under the same FAR draw (counts
    bitwise, estimates at rtol 1e-6), without a rebuild; an isolated
    insert lands in the overflow region and reports its own unit mass."""
    x0 = _x0()
    ds = DynamicDataset(x0, capacity=256, device="cpu")
    est = HashedKDE(x0, gaussian(1.0), seed=5, max_bucket=64,
                    num_far_samples=32, dataset=ds, overflow_cap=64)
    ds.delete_rows(np.arange(40, 56))
    ds.update_rows(np.array([3]), ds.x_pad[3:4].numpy())
    est._sync()
    assert est.rebuilds == 0
    state2, _ = thops.build_hash_state(ds.x_pad, gaussian(1.0),
                                       max_bucket=64, seed=5,
                                       live=ds.live_host, overflow_cap=64,
                                       device="cpu")
    y = torch.as_tensor(x0[:16])
    fidx = torch.randint(0, ds.n, (16, 32), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    cfg = {k: v for k, v in est._cfg.items() if k != "pairwise"}
    e1, c1, _ = thops.hashed_query(ds.x_pad, y, est.state, fidx, **cfg)
    e2, c2, _ = thops.hashed_query(ds.x_pad, y, state2, fidx, **cfg)
    torch.testing.assert_close(c1, c2, rtol=0, atol=0)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-6)
    iso = (x0[:1] + 37.0).astype(np.float32)
    ds.insert_rows(iso)
    q = est.query(torch.as_tensor(iso))
    assert abs(float(q[0]) - 1.0) < 1e-2, q
    assert est.rebuilds == 0 and est._patcher.overflow_fill == 1


@pytest.mark.parametrize("checks", ["1", "0"])
def test_hashed_saturation_raises_or_compacts(monkeypatch, checks):
    """Isolated inserts past the overflow region's capacity: the patch
    sets ``OVERFLOW_SATURATED``, an ``EstimationError`` under
    ``REPRO_CHECKS=1``; without checks the layout compacts (a rebuild at
    the new epoch) and answers, as the reference's ``HashedKDE._sync``."""
    monkeypatch.setenv("REPRO_CHECKS", checks)
    x0 = _x0()
    ds = DynamicDataset(x0, capacity=256, device="cpu")
    est = HashedKDE(None, gaussian(1.0), seed=5, dataset=ds,
                    overflow_cap=2)
    iso = (x0[:3] + 50.0 + np.arange(3)[:, None] * 9.0).astype(np.float32)
    ds.insert_rows(iso)
    if checks == "1":
        with pytest.raises(tguards.EstimationError,
                           match="OVERFLOW_SATURATED"):
            est.query(torch.as_tensor(iso))
        return
    q = est.query(torch.as_tensor(iso))
    assert est.rebuilds == 1 and est.status & tguards.OVERFLOW_SATURATED
    np.testing.assert_allclose(q.numpy(), 1.0, atol=1e-2)


def test_hashed_bf16_copy_follows_the_mutations():
    """A bf16 streaming hash estimator re-rounds the mutated rows into its
    bf16 copy on every patch, so the copy equals the rounded current rows
    (a stale copy would read the moved points' old coordinates)."""
    x0 = _x0()
    ds = DynamicDataset(x0, capacity=256, device="cpu")
    est = HashedKDE(None, gaussian(1.0), seed=5, dataset=ds,
                    precision="bf16")
    ds.update_rows(np.arange(10), x0[100:110] + 0.37)
    ds.delete_rows(np.arange(20, 30))
    ds.insert_rows(x0[:4] - 0.21)
    est.query(torch.as_tensor(x0[:4]))
    want = tref.round_bf16(ds.x_pad).to(torch.bfloat16)
    assert torch.equal(est.state.x_bf16.view(torch.int16),
                       want.view(torch.int16))


# --------------------------------------------------------------------- #
# consumers against the reference's consumers
# --------------------------------------------------------------------- #
def test_neighbor_prob_of_patch_matches_reference():
    """``prob_of`` on the patched exact-block cache equals the reference's
    patched sampler and a fresh port sampler (rtol 2e-5 / atol 1e-7), with
    the same ``evals``; after ``compact`` (a journal gap) the sampler
    rebuilds and answers like a fresh one."""
    x0 = _x0()
    jds, tds = _pair(x0, capacity=256)
    kw = dict(seed=3, exact_blocks=True, block_size=16)
    jn = JNeighborSampler(jds.x_pad, jgaussian(1.0), dataset=jds, **kw)
    tn = NeighborSampler(tds.x_pad, gaussian(1.0), dataset=tds, device="cpu",
                         **kw)
    src = np.arange(16)
    jv, _ = jn.sample(src)
    tv, _ = tn.sample(src)
    keep = np.union1d(np.asarray(jv), tv)
    _mutate_both(jds, tds, 4, dele=(40, 48), keep=keep)
    p_t = tn.prob_of(src, tv)
    p_j = np.asarray(jn.prob_of(src, tv))
    fresh = NeighborSampler(tds.x_pad, gaussian(1.0), device="cpu", **kw)
    np.testing.assert_allclose(p_t, p_j, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(p_t, fresh.prob_of(src, tv), rtol=2e-5,
                               atol=1e-7)
    assert tn.evals == jn.evals
    for ds in (jds, tds):
        ds.compact()
    live = tds.live_slots()[:16]
    q_t = tn.prob_of(live, np.roll(live, 1))
    q_j = np.asarray(jn.prob_of(live, np.roll(live, 1)))
    np.testing.assert_allclose(q_t, q_j, rtol=2e-5, atol=1e-7)
    fresh = NeighborSampler(tds.x_pad, gaussian(1.0), device="cpu", **kw)
    np.testing.assert_allclose(q_t, fresh.prob_of(live, np.roll(live, 1)),
                               rtol=2e-5, atol=1e-7)


def test_degree_sampler_patch_and_gap_match_reference():
    """``DegreeSampler(dataset=)`` over the exact-block structure: after
    three batches (one coalesced ``degree_delta``) the degrees equal the
    reference's and a fresh recompute (rtol 5e-4 / atol 5e-5), dead slots
    exactly 0, draws on live slots, the same ``evals``; past the journal
    limit both rebuild their estimator as a ``StratifiedKDE`` with the
    exact-block structure's block size and samples a block (ROADMAP.md
    §3), and the degrees match again."""
    x0 = _x0()
    jds, tds = _pair(x0, capacity=256, journal_limit=4)
    kw = dict(seed=5, exact_blocks=True, block_size=16)
    jn = JNeighborSampler(jds.x_pad, jgaussian(1.0), dataset=jds, **kw)
    tn = NeighborSampler(tds.x_pad, gaussian(1.0), dataset=tds, device="cpu",
                         **kw)
    jd = JDegreeSampler(jn.blocks, seed=7, dataset=jds)
    td = DegreeSampler(tn.blocks, seed=7, dataset=tds)
    np.testing.assert_allclose(td.degrees, jd.degrees, rtol=5e-4, atol=5e-5)
    _mutate_both(jds, tds, 10, dele=(60, 62), upd=(70, 72))
    u = td.sample(256)
    jd.sample(8)
    assert tds.is_live(u) and td.rebuilds == jd.rebuilds == 0
    np.testing.assert_allclose(td.degrees, jd.degrees, rtol=5e-4, atol=5e-5)
    assert tn.evals == jn.evals
    np.testing.assert_allclose(td.degrees, streaming_degrees(tn.blocks, tds),
                               rtol=5e-4, atol=5e-5)
    assert td.degrees[60] == 0.0 and td.degrees[61] == 0.0
    for i in range(2):                          # past journal_limit
        _mutate_both(jds, tds, 20 + i, dele=(80 + 2 * i, 82 + 2 * i),
                     upd=(90 + 2 * i, 92 + 2 * i))
    td.sample(8)
    jd.sample(8)
    assert td.rebuilds == jd.rebuilds == 1
    est, jest = td._estimator, jd._estimator
    assert type(est).__name__ == type(jest).__name__ == "StratifiedKDE"
    assert (est.block_size, est.samples_per_block) == \
        (jest.block_size, jest.samples_per_block) == (16, 16)
    np.testing.assert_allclose(td.degrees, jd.degrees, rtol=5e-4, atol=5e-5)
    assert tds.is_live(td.sample(64))


def test_rownorm_patch_and_gap_match_reference():
    """``RowNormSampler(dataset=)``: the patched squared row norms equal
    the reference's and a fresh sampler's (rtol 5e-4 / atol 5e-5), draws
    land on live rows, the sketch rows are finite; a journal gap rebuilds
    (``rebuilds``) and matches again."""
    x0 = _x0()
    jds, tds = _pair(x0, capacity=256, journal_limit=3)
    jr = JRowNormSampler(None, jgaussian(1.0), estimator="exact", seed=1,
                         dataset=jds)
    tr = RowNormSampler(None, gaussian(1.0), estimator="exact", seed=1,
                        dataset=tds)
    _mutate_both(jds, tds, 6)
    idx = tr.sample(128)
    jr.sample(4)
    assert tds.is_live(idx)
    np.testing.assert_allclose(tr.row_norms_sq, jr.row_norms_sq, rtol=5e-4,
                               atol=5e-5)
    fresh = RowNormSampler(None, gaussian(1.0), estimator="exact", seed=1,
                           dataset=tds)
    np.testing.assert_allclose(tr.row_norms_sq, fresh.row_norms_sq,
                               rtol=5e-4, atol=5e-5)
    assert tr.evals == jr.evals
    assert np.isfinite(tr.sketch_rows(idx[:8])).all()
    for i in range(2):                          # past journal_limit
        _mutate_both(jds, tds, 7 + i, dele=(60 + 4 * i, 64 + 4 * i),
                     upd=(70 + 2 * i, 72 + 2 * i))
    tr.sample(4)
    jr.sample(4)
    assert tr.rebuilds == jr.rebuilds == 1
    np.testing.assert_allclose(tr.row_norms_sq, jr.row_norms_sq, rtol=5e-4,
                               atol=5e-5)
    with pytest.raises(ValueError, match="dense estimator"):
        RowNormSampler(None, gaussian(1.0), estimator="hash", dataset=tds)


def test_epoch_stale_raises_under_checks(monkeypatch):
    monkeypatch.setenv("REPRO_CHECKS", "1")
    ds = DynamicDataset(_x0(), capacity=256, device="cpu")
    nbr = NeighborSampler(ds.x_pad, gaussian(1.0), dataset=ds, seed=3,
                          exact_blocks=True, block_size=16)
    ds.delete_rows(np.array([11]))
    with pytest.raises(tguards.EstimationError, match="EPOCH_STALE"):
        nbr.sample(np.array([11]))     # externally-held stale frontier
    assert nbr.status & tguards.EPOCH_STALE
    v, _ = nbr.sample(np.array([0, 1]))   # a live frontier still serves
    assert ds.is_live(v)


def test_robust_estimator_epoch_sync_matches_reference():
    """tests/test_streaming.py's epoch sync with a NEAR-only hash stage
    (deterministic, so the values compare): after a far cluster is
    inserted the wrapper answers at the new epoch (the cluster's mass),
    drops its built stages, serves the live rows only, and its values and
    counters equal the reference's."""
    x0 = _x0()
    jds, tds = _pair(x0, capacity=400)
    kw = dict(seed=0, stages=("hash", "exact"),
              stage_kw={"hash": {"num_far_samples": 0}})
    jr = jguards.RobustEstimator(jds, jgaussian(1.0), **kw)
    tr = tguards.RobustEstimator(tds, gaussian(1.0), **kw)
    q = np.concatenate([x0[:2], x0[:1] + 25.0]).astype(np.float32)
    np.testing.assert_allclose(tr.query(torch.as_tensor(q)).numpy(),
                               np.asarray(jr.query(jnp.asarray(q))),
                               rtol=1e-5)
    rng = np.random.default_rng(3)
    cluster = (x0[:1] + 25.0 + 0.05 * rng.normal(size=(40, 6))).astype(
        np.float32)
    for ds in (jds, tds):
        ds.insert_rows(cluster)
    v = tr.query(torch.as_tensor(cluster[:3])).numpy()
    # at coordinates near 25, |q|^2 + |x|^2 - 2 q.x cancels ~7500 down to
    # ~0.03 in f32 on both sides: each kernel value moves by up to a few
    # ulp(7500) ~ 2e-3 of itself with the order of the three sums
    np.testing.assert_allclose(v, np.asarray(jr.query(
        jnp.asarray(cluster[:3]))), rtol=2e-3)
    # stale stages would answer ~0 (no cluster rows); a fresh NEAR-only
    # hash stage reads at least the query's own row, and its cluster
    assert v.min() >= 1.0 - 1e-6 and v.max() > 10.0
    assert tr.stage_rebuilds == jr.stage_rebuilds >= 1
    assert tr.n == tds.num_live == jr.n
    assert (tr.escalations, tr.retries) == (jr.escalations, jr.retries)


def test_walk_stream_bitwise_after_patch():
    """The same seed, no draws before the mutation: the patched sampler
    and a fresh one over the mutated dataset consume identical noise over
    identical coordinates, so walk endpoints and paths are equal."""
    ds = DynamicDataset(_x0(), capacity=256, device="cpu")
    kw = dict(seed=9, exact_blocks=True, block_size=16)
    nbr = NeighborSampler(ds.x_pad, gaussian(1.0), dataset=ds, **kw)
    _mutate(ds, np.random.default_rng(8))
    starts = np.array([0, 1, 2, 3, 20, 21])
    end1, path1 = nbr.walk(starts, 4, record_path=True)
    fresh = NeighborSampler(ds.x_pad, gaussian(1.0), device="cpu", **kw)
    end2, path2 = fresh.walk(starts, 4, record_path=True)
    np.testing.assert_array_equal(end1, end2)
    np.testing.assert_array_equal(path1, path2)
    assert ds.is_live(end1)


def test_streaming_graph_end_to_end_matches_reference():
    """tests/test_streaming.py's end-to-end drive on both packages
    (hashed level 1): every draw on a live slot, finite probabilities,
    the same status report and the same eval counters (realized NEAR reads
    of the same layouts, the patches, the draws' shapes); dead slots carry
    degree exactly 0."""
    x0 = _x0()
    kw = dict(capacity=256, level1="hash", seed=11,
              hash_opts=dict(max_bucket=64))
    jg = JStreamingGraph(x0, jgaussian(1.0), **kw)
    tg = StreamingKernelGraph(x0, gaussian(1.0), device="cpu", **kw)
    rng = np.random.default_rng(12)
    ins = rng.normal(0, 0.7, size=(6, 6)).astype(np.float32)
    upd = rng.normal(0, 0.7, size=(2, 6)).astype(np.float32)
    for g in (jg, tg):
        g.insert(ins)
        g.delete(np.arange(5))
        g.update(np.array([30, 31]), upd)
    u = tg.sample_vertices(64)
    v, q = tg.sample_neighbors(u)
    jg.sample_neighbors(jg.sample_vertices(64))
    assert tg.dataset.is_live(u) and tg.dataset.is_live(v)
    assert np.isfinite(q).all()
    e = tg.sample_edges(128)
    jg.sample_edges(128)
    assert len(e[0]) == 128 and tg.dataset.is_live(e[0]) \
        and tg.dataset.is_live(e[1])
    end, _ = tg.walk(u[:8], 3)
    jg.walk(u[:8], 3)
    assert tg.dataset.is_live(end)
    assert tg.status_report() == jg.status_report()
    assert tg.nbr.evals == jg.nbr.evals
    assert tg.nbr.hash_estimator.evals == jg.nbr.hash_estimator.evals
    d = tg.degrees()
    assert d[0] == 0.0 and (d[tg.dataset.live_slots()] > 0).all()
