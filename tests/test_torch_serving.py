"""The port's multi-tenant serving layer (``repro_torch.core.serving``,
DESIGN.md §13), its batched programs and the graph-serving modes of
``launch.serve``, against the port's single-request programs and the
reference on the CPU.

* Each batched program, lane by lane, IS the single-request program fed
  the lane's noise: equal bitwise over 2-3 stacked tenants on the exact,
  stratified and hashed reads (the plain versions of the tenant-axis
  kernels give each row the sums of a call on its tenant alone).
* Against the reference's batched programs (``use_pallas=False``): the
  exact ``batched_prob_of`` / ``batched_kde_query`` within rtol 2e-4, the
  hashed query's NEAR counts exactly (the layouts come across through
  ``convert.hash_state_from_reference``), every (R, WIDTH) counter word
  exactly.
* The port's and the reference's servables on one scripted stream (4
  tenants, ``max_resident`` 2, mixed ops, a mutation between ticks, a
  frontier of dead rows, a malformed payload) agree on every tick's
  stats, ``report()`` apart from timing and the requests that carry an
  ``EstimationError`` under ``REPRO_CHECKS=1``; exact tenants' served
  probabilities equal the reference's ``prob_of`` of the same pairs; the
  stratified and hashed draws pass a TV test against the reference's.

The reference keys threefry per request; the port draws each request's
noise from a CPU generator seeded with its seed (ROADMAP.md section 3), so
draws are compared in law, probabilities and counters exactly.
"""
import argparse
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.core import serving as jserving
from repro.core.kernels_fn import gaussian as jgaussian
from repro.core.sampling.edge import NeighborSampler as JNeighborSampler
from repro.kernels.kde_hash import ops as jhops
from repro.kernels.kde_sampler import ops as jops
from repro_torch.convert import hash_state_from_reference
from repro_torch.core.kernels_fn import gaussian
from repro_torch.core.sampling.edge import NeighborSampler
from repro_torch.core.serving import (DEFAULT_BUCKETS, REQUEST_OPS,
                                      KernelGraphServable, shape_bucket)
from repro_torch.ft import guards as tg
from repro_torch.kernels.kde_hash import ops as thops
from repro_torch.kernels.kde_rowsum import kernel as rk
from repro_torch.kernels.kde_sampler import kernel as sk
from repro_torch.kernels.kde_sampler import ops as tops
from repro_torch.obs import export as texport

N, D, BS = 192, 4, 16
READS = {"exact": dict(exact_blocks=True),
         "stratified": dict(),
         "hash": dict(level1="hash")}


def _data(label, shift=0.0, n=N, d=D):
    rng = np.random.default_rng(stats.derive_seed("torch-serving", label))
    return (rng.normal(0, 0.6, size=(n, d)) + shift).astype(np.float32)


def _tenant_data(read: str, t: int):
    """Tenant t's rows.  Hashed tenants stack only with equal bucket
    counts, so their rows are one set permuted and moved by whole grid
    cells (2 cell widths a tenant in every coordinate: the same codes
    shifted, the same bucket count) under one layout seed."""
    if read != "hash":
        return _data(f"{read}-{t}", 0.3 * t)
    x = _data("hash-base")
    perm = np.random.default_rng(t).permutation(N)
    return x[perm] + np.float32(4.0 * t)


def _samplers(read: str, tenants: int = 3):
    return [NeighborSampler(_tenant_data(read, t), gaussian(1.0),
                            block_size=BS, seed=11 if read == "hash" else t,
                            device="cpu", **READS[read])
            for t in range(tenants)]


def _arena(nbrs):
    xa = torch.stack([s.x for s in nbrs])
    xa_sq = torch.stack([s.x_sq for s in nbrs])
    hs = (thops.stack_hash_states([s._hstate for s in nbrs])
          if nbrs[0]._hstate is not None else None)
    return xa, xa_sq, hs


def _gens(seeds):
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def _stack(parts):
    from repro_torch.core.serving import _stack
    return _stack(parts, torch.device("cpu"))


TIDX = np.array([0, 2, 1, 0, 2])
W = 16


def _srcs(nbr0, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, N, W) for _ in TIDX]).astype(np.int64)


# ------------------------------------------------------------------- #
# the tenant-axis plain versions and the row layout
# ------------------------------------------------------------------- #
def test_shape_bucket_equals_the_reference():
    for w in range(1, 1001):
        assert shape_bucket(w) == jserving.shape_bucket(w), w
    for w in (1, 3, 5, 9, 17, 100):
        assert shape_bucket(w, (2, 6)) == jserving.shape_bucket(w, (2, 6))
    assert DEFAULT_BUCKETS == jserving.DEFAULT_BUCKETS
    assert REQUEST_OPS == jserving.REQUEST_OPS


@pytest.mark.parametrize("bm", [64, 128])
def test_tenant_layout_orders_and_pads_by_tenant(bm):
    t = np.array([2, 0, 2, 1, 0, 2] * 30)
    pos, base, inv = sk.tenant_layout(t, 100, bm)
    assert len(pos) == len(base) * bm and base.dtype == np.int32
    # each tile holds one tenant's rows, padded with its first row
    for i, b in enumerate(base):
        assert set(t[pos[i * bm:(i + 1) * bm]]) == {b // 100}
    assert np.array_equal(pos[inv], np.arange(len(t)))
    assert sorted(set(base.tolist())) == [0, 100, 200]


@pytest.mark.parametrize("d", [4, 8, 19])
def test_tenant_axis_plain_versions_equal_per_tenant_calls(d):
    """masked_blocksum / sample_block / blocksum with ``tile_base`` on the
    arena equal the calls on each tenant's rows alone, bitwise."""
    rng = np.random.default_rng(d)
    xa = torch.as_tensor(rng.normal(size=(3, 150, d)).astype(np.float32))
    t = np.array([1, 0, 1, 2, 2, 1] * 9)
    src = torch.as_tensor(rng.integers(0, 150, len(t)))
    q = xa[torch.as_tensor(t), src]
    own = src // 32
    g = torch.as_tensor(rng.gumbel(size=(len(t), 5)).astype(np.float32))
    kw = dict(kind="gaussian", inv_bw=1.0, beta=1.0, bn=32)
    for fn, extra, bm in (
            (sk.masked_blocksum_plain, (own,), sk.tile_rows(d)),
            (sk.sample_block_plain, (own, g), sk.tile_rows(d)),
            (rk.blocksum_plain, (), rk.blocksum_tile_rows(d))):
        got = tops.tenant_launch(fn, q, xa, torch.as_tensor(t), *extra,
                                 bm=bm, **kw)
        for ti in range(3):
            rows = torch.as_tensor(np.where(t == ti)[0])
            want = fn(q[rows], xa[ti], *[a[rows] for a in extra], **kw)
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.equal(a[rows], b), (fn.__name__, ti)


def test_tenant_axis_refuses_a_wrong_tile_count():
    xa = torch.zeros((2, 64, 8))
    q = torch.zeros((130, 8))
    with pytest.raises(ValueError, match="tile_base"):
        rk.blocksum_plain(q, xa, "gaussian", 1.0, bn=32,
                          tile_base=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="arena"):
        sk.masked_blocksum_plain(q, xa[0], torch.zeros(130, dtype=torch.long),
                                 "gaussian", 1.0, bn=32,
                                 tile_base=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="f32 instances only"):
        rk.blocksum_plain(q, xa, "gaussian", 1.0, bn=32, precision="bf16",
                          tile_base=torch.zeros(2, dtype=torch.int32))


# ------------------------------------------------------------------- #
# batched programs == single-request programs, lane by lane
# ------------------------------------------------------------------- #
def _equal(a, b, what):
    assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), what


@pytest.mark.parametrize("read", sorted(READS))
def test_batched_fused_sample_is_the_single_program(read):
    nbrs = _samplers(read)
    xa, xa_sq, hs = _arena(nbrs)
    cfg = nbrs[0]._cfg
    src = _srcs(nbrs[0])
    noises = [tops.draw_sample_noise(W, cfg["num_blocks"], g, "cpu",
                                     **nbrs[0]._noise_cfg)
              for g in _gens(range(len(TIDX)))]
    nb, prob, bs, cw = tops.batched_fused_sample(
        xa, xa_sq, TIDX, torch.as_tensor(src), _stack(noises), hs, **cfg)
    for r, ti in enumerate(TIDX):
        s = nbrs[ti]
        want = tops.fused_sample(s.x, s.x_sq, torch.as_tensor(src[r]),
                                 *noises[r], hstate=s._hstate, **s._cfg)
        for a, b, what in zip((nb[r], prob[r], bs[r], cw[r]), want,
                              ("nb", "prob", "bs", "word")):
            _equal(a, b, (read, r, what))


@pytest.mark.parametrize("read", sorted(READS))
def test_batched_walk_scan_is_the_single_program(read):
    nbrs = _samplers(read)
    xa, xa_sq, hs = _arena(nbrs)
    cfg = nbrs[0]._cfg
    src = _srcs(nbrs[0], 1)[:, :8]
    noises = [tops.draw_walk_noise(4, 8, cfg["num_blocks"], g, "cpu",
                                   n=cfg["n"], s=cfg["s"], rounds=0,
                                   **nbrs[0]._noise_cfg)
              for g in _gens(range(7, 7 + len(TIDX)))]
    end, path, cw, fb = tops.batched_walk_scan(
        xa, xa_sq, TIDX, torch.as_tensor(src), _stack(noises), hs,
        rounds=0, slack=2.0, record_path=True, **cfg)
    for r, ti in enumerate(TIDX):
        s = nbrs[ti]
        e0, p0, w0, f0 = tops.walk_scan(s.x, s.x_sq, torch.as_tensor(src[r]),
                                        noises[r], s._hstate, rounds=0,
                                        slack=2.0, record_path=True,
                                        **s._cfg)
        _equal(end[r], e0, (read, r, "end"))
        _equal(path[r], p0, (read, r, "path"))
        _equal(cw[r], w0, (read, r, "word"))
        assert int(fb[r]) == int(f0)


@pytest.mark.parametrize("read", ["exact", "stratified"])
def test_batched_walk_rejection_rounds_are_the_single_program(read):
    nbrs = _samplers(read)
    xa, xa_sq, hs = _arena(nbrs)
    cfg = nbrs[0]._cfg
    src = _srcs(nbrs[0], 2)[:, :8]
    noises = [tops.draw_walk_noise(3, 8, cfg["num_blocks"], g, "cpu",
                                   n=cfg["n"], s=cfg["s"], rounds=2,
                                   **nbrs[0]._noise_cfg)
              for g in _gens(range(20, 20 + len(TIDX)))]
    end, _, cw, fb = tops.batched_walk_scan(
        xa, xa_sq, TIDX, torch.as_tensor(src), _stack(noises), hs,
        rounds=2, slack=50.0, **cfg)
    assert int(fb.sum()) > 0          # the rounds do reject here
    for r, ti in enumerate(TIDX):
        s = nbrs[ti]
        e0, _, w0, f0 = tops.walk_scan(s.x, s.x_sq, torch.as_tensor(src[r]),
                                       noises[r], s._hstate, rounds=2,
                                       slack=50.0, record_path=False,
                                       **s._cfg)
        _equal(end[r], e0, (read, r, "end"))
        _equal(cw[r], w0, (read, r, "word"))
        assert int(fb[r]) == int(f0)


@pytest.mark.parametrize("read", sorted(READS))
def test_batched_prob_of_is_the_single_program(read):
    nbrs = _samplers(read)
    xa, xa_sq, hs = _arena(nbrs)
    cfg = nbrs[0]._cfg
    src, dst = _srcs(nbrs[0], 3), _srcs(nbrs[0], 4)
    noises = [tops._level1_noise(W, cfg["num_blocks"], g, "cpu",
                                 **nbrs[0]._noise_cfg)
              for g in _gens(range(30, 30 + len(TIDX)))]
    prob, cw = tops.batched_prob_of(
        xa, xa_sq, TIDX, torch.as_tensor(src), torch.as_tensor(dst),
        _stack(noises), hs, **cfg)
    for r, ti in enumerate(TIDX):
        s = nbrs[ti]
        sr = torch.as_tensor(src[r])
        bs, w1 = tops.masked_block_sums(s.x, s.x_sq, sr, noises[r],
                                        s._hstate, **s._cfg)
        p0, w2 = tops.prob_of_from_block_sums(
            s.x, s.x_sq, sr, torch.as_tensor(dst[r]), bs, **s._l2_cfg)
        _equal(prob[r], p0, (read, r, "prob"))
        # the reference's lane word: the level-1 read's and prob's, one word
        assert int(cw[r, 0]) == (int(w1[0]) | int(tg.result_status(p0)))
        assert torch.equal(cw[r, 1:], (w1 + w2)[1:])


@pytest.mark.parametrize("read", sorted(READS))
def test_batched_query_is_the_single_program(read):
    nbrs = _samplers(read)
    xa, xa_sq, hs = _arena(nbrs)
    cfg = nbrs[0]._cfg
    rng = np.random.default_rng(9)
    y = torch.as_tensor(np.stack([_data(f"q{r}", 0.3 * t, n=8)
                                  for r, t in enumerate(TIDX)]))
    if read == "hash":
        hq = nbrs[0].hash_estimator
        noises = [thops.draw_query_noise(8, hq._cfg["num_far"],
                                         hq._cfg["n"], g, "cpu")
                  for g in _gens(range(40, 45))]
        est, cnt, cw = thops.batched_hashed_query(
            xa, TIDX, y, hs, _stack(noises), **hq._cfg)
        for r, ti in enumerate(TIDX):
            h = nbrs[ti].hash_estimator
            e0, c0, w0 = thops.hashed_query(h.x, y[r], h.state, noises[r],
                                            **h._cfg)
            _equal(est[r], e0, (r, "est"))
            _equal(cnt[r], c0, (r, "cnt"))
            _equal(cw[r], w0, (r, "word"))
        return
    exact = cfg["exact"]
    noises = None if exact else [
        torch.rand((cfg["num_blocks"], BS), generator=g)
        for g in _gens(range(40, 45))]
    keys = ("kind", "inv_bw", "beta", "pairwise", "block_size",
            "num_blocks", "n", "s", "exact", "precision")
    est, cw = tops.batched_kde_query(
        xa, xa_sq, TIDX, y, None if exact else _stack(noises),
        **{k: cfg[k] for k in keys})
    for r, ti in enumerate(TIDX):
        s = nbrs[ti]
        c = {k: s._cfg[k] for k in ("kind", "inv_bw", "beta", "block_size",
                                    "num_blocks", "n", "precision")}
        if exact:
            bs, w0 = tops.exact_block_sums(y[r], s.x, s.x_sq, **c)
        else:
            bs, w0 = tops.stratified_block_sums(y[r], s.x, s.x_sq,
                                                noises[r], s=s._cfg["s"],
                                                **c)
        e0 = bs.sum(-1)
        _equal(est[r], e0, (read, r, "est"))
        st = int(w0[0]) | int(tg.sums_status(bs, tops.FLOOR)) | \
            int(tg.result_status(e0))
        assert int(cw[r, 0]) == st and torch.equal(cw[r, 1:], w0[1:])


def test_stack_hash_states_refuses_mismatched_layouts():
    a = _samplers("hash", 1)[0]._hstate
    b = a._replace(members=a.members[:, :-1].contiguous())
    with pytest.raises(ValueError, match="separate batch groups"):
        thops.stack_hash_states([a, b])
    c = a._replace(overflow=torch.full((4,), -1, dtype=torch.int32))
    with pytest.raises(ValueError, match="separate batch groups"):
        thops.stack_hash_states([a, c])
    with pytest.raises(ValueError, match="at least one"):
        thops.stack_hash_states([])
    st = thops.stack_hash_states([a, a])
    assert st.members.shape == (2,) + tuple(a.members.shape)
    assert st.overflow is None and st.x_bf16 is None


# ------------------------------------------------------------------- #
# against the reference's batched programs
# ------------------------------------------------------------------- #
def _ref_samplers(read, tenants=3):
    kw = {"exact": dict(exact_blocks=True), "stratified": {},
          "hash": dict(level1="hash")}[read]
    return [JNeighborSampler(_tenant_data(read, t), jgaussian(1.0),
                             block_size=BS,
                             seed=11 if read == "hash" else t,
                             use_pallas=False, **kw)
            for t in range(tenants)]


def _jkeys(seeds):
    return jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])


def _jarena(nbrs):
    xa = jnp.stack([s.x for s in nbrs])
    xa_sq = jnp.stack([s.x_sq for s in nbrs])
    hs = (jhops.stack_hash_states([s._hstate for s in nbrs])
          if nbrs[0]._hstate is not None else None)
    return xa, xa_sq, hs


def _words_equal(got, want):
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("read", sorted(READS))
def test_batched_words_equal_the_reference(read):
    """Every (R, WIDTH) counter word of the four programs equals the
    reference's batched program's for the same groups."""
    tn, jn = _samplers(read), _ref_samplers(read)
    xa, xa_sq, hs = _arena(tn)
    jxa, jxa_sq, jhs = _jarena(jn)
    cfg, jcfg = tn[0]._cfg, jn[0]._cfg
    src, dst = _srcs(tn[0], 5), _srcs(tn[0], 6)
    keys = _jkeys(range(len(TIDX)))
    gens = lambda: _gens(range(len(TIDX)))           # noqa: E731
    nkw = tn[0]._noise_cfg
    _, _, _, cw = tops.batched_fused_sample(
        xa, xa_sq, TIDX, torch.as_tensor(src), _stack(
            [tops.draw_sample_noise(W, cfg["num_blocks"], g, "cpu", **nkw)
             for g in gens()]), hs, **cfg)
    _, _, _, jw = jops.batched_fused_sample(jxa, jxa_sq, TIDX, src, keys,
                                            hstate=jhs, **jcfg)
    _words_equal(cw, jw)
    _, _, cw, _ = tops.batched_walk_scan(
        xa, xa_sq, TIDX, torch.as_tensor(src[:, :8]), _stack(
            [tops.draw_walk_noise(3, 8, cfg["num_blocks"], g, "cpu",
                                  n=cfg["n"], s=cfg["s"], rounds=0, **nkw)
             for g in gens()]), hs, rounds=0, slack=2.0, **cfg)
    wkeys = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    _, _, jw, _ = jops.batched_walk_scan(jxa, jxa_sq, TIDX, src[:, :8],
                                         wkeys, hstate=jhs, rounds=0,
                                         slack=2.0, record_path=False,
                                         **jcfg)
    _words_equal(cw, jw)
    prob, cw = tops.batched_prob_of(
        xa, xa_sq, TIDX, torch.as_tensor(src), torch.as_tensor(dst),
        _stack([tops._level1_noise(W, cfg["num_blocks"], g, "cpu", **nkw)
                for g in gens()]), hs, **cfg)
    jprob, jw = jops.batched_prob_of(jxa, jxa_sq, TIDX, src, dst, keys,
                                     hstate=jhs, **jcfg)
    _words_equal(cw, jw)
    if read == "exact":
        np.testing.assert_allclose(prob.numpy(), np.asarray(jprob),
                                   rtol=2e-4)


@pytest.mark.parametrize("read", ["exact", "stratified"])
def test_batched_kde_query_against_the_reference(read):
    tn, jn = _samplers(read), _ref_samplers(read)
    xa, xa_sq, _ = _arena(tn)
    jxa, jxa_sq, _ = _jarena(jn)
    cfg, jcfg = tn[0]._cfg, jn[0]._cfg
    y = np.stack([_data(f"rq{r}", 0.3 * t, n=8)
                  for r, t in enumerate(TIDX)])
    qk = ("kind", "inv_bw", "beta", "pairwise", "block_size", "num_blocks",
          "n", "s", "exact", "precision")
    noise = None if read == "exact" else _stack(
        [torch.rand((cfg["num_blocks"], BS), generator=g)
         for g in _gens(range(5))])
    est, cw = tops.batched_kde_query(xa, xa_sq, TIDX, torch.as_tensor(y),
                                     noise, **{k: cfg[k] for k in qk})
    jest, jw = jops.batched_kde_query(
        jxa, jxa_sq, TIDX, y, _jkeys(range(5)),
        **{k: jcfg[k] for k in qk})
    _words_equal(cw, jw)
    if read == "exact":
        np.testing.assert_allclose(est.numpy(), np.asarray(jest),
                                   rtol=2e-4)


def test_batched_hashed_query_near_counts_equal_the_reference():
    """The layouts come across from the reference, so each lane's bucket
    lookups and realized NEAR counts are the reference's exactly, and so
    is every counter word."""
    jn = _ref_samplers("hash")
    jstates = [s.hash_estimator.state for s in jn]
    jhq = jn[0].hash_estimator
    xa = torch.stack([torch.as_tensor(np.asarray(s.x)) for s in jn])
    hs = thops.stack_hash_states([hash_state_from_reference(
        st, device="cpu") for st in jstates])
    y = np.stack([_data(f"hq{r}", 4.0 * t, n=8)
                  for r, t in enumerate(TIDX)])
    cfg = {k: v for k, v in jhq._cfg.items()
           if k not in ("use_pallas", "interpret")}
    noise = _stack([thops.draw_query_noise(8, cfg["num_far"], cfg["n"], g,
                                           "cpu") for g in _gens(range(5))])
    _, cnt, cw = thops.batched_hashed_query(xa, TIDX, torch.as_tensor(y),
                                            hs, noise, **cfg)
    _, jcnt, jw = jhops.batched_hashed_query(
        jnp.stack([s.x for s in jn]), TIDX, y,
        jhops.stack_hash_states(jstates), _jkeys(range(5)), **jhq._cfg)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert int(cnt.sum()) > 0
    _words_equal(cw, jw)


# ------------------------------------------------------------------- #
# the servables on one scripted stream
# ------------------------------------------------------------------- #
S_TENANTS = (("e0", dict(exact_blocks=True), 0.0),
             ("e1", dict(exact_blocks=True), 0.4),
             ("s0", dict(), 0.2),
             ("h0", dict(level1="hash"), 0.0))


def _stream_tick(rng, tick):
    """One tick's requests: (tenant, op, payload, seed) in queue order."""
    reqs = []
    for i in range(10):
        name = S_TENANTS[(i + tick) % 4][0]
        op = ("sample", "query", "walk", "prob_of")[(i + tick) % 4]
        seed = 100 * tick + i
        if op == "sample":
            pl = dict(src=rng.integers(0, N, 12 if i % 3 else 16))
        elif op == "query":
            pl = dict(y=rng.normal(0, 0.6, (8, D)).astype(np.float32))
        elif op == "walk":
            pl = dict(starts=rng.integers(0, N, 8), length=3)
        else:
            pl = dict(src=rng.integers(0, N, 16), dst=rng.integers(0, N, 16))
        reqs.append((name, op, pl, seed))
    return reqs


def _run_stream(srv, seed=0):
    """Drive one servable through the scripted stream; returns (per-tick
    stats, per-request (name, op, payload, error?, result), report)."""
    rng = np.random.default_rng(stats.derive_seed("torch-serving", seed))
    for name, kw, shift in S_TENANTS:
        srv.add_tenant(name, _data(f"stream-{name}", shift), gaussian(1.0)
                       if isinstance(srv, KernelGraphServable)
                       else jgaussian(1.0), block_size=BS, seed=3, **kw)
    ticks, log = [], []
    for tick in range(4):
        plan = _stream_tick(rng, tick)
        if tick == 1:
            # a malformed payload (a walk without its length) and a
            # frontier holding rows deleted below
            plan.append(("e0", "walk", dict(starts=np.arange(8)), 7))
            plan.append(("s0", "sample", dict(src=np.array([5, 6, 7, 8])),
                         8))
        reqs = [(srv.submit(n, op, seed=s, **pl), n, op, pl)
                for n, op, pl, s in plan]
        if tick == 1:
            srv.dataset("s0").delete_rows(np.array([6, 40]))
        if tick == 2:
            srv.dataset("e1").update_rows(
                np.array([3, 4]), rng.normal(0, 0.6, (2, D)).astype(
                    np.float32))
            srv.dataset("h0").insert_rows(
                rng.normal(0, 0.6, (3, D)).astype(np.float32))
        st = srv.tick()
        ticks.append({k: st[k] for k in ("requests", "groups", "served",
                                         "failed", "stale", "admissions",
                                         "evictions", "realized_evals")})
        for r, n, op, pl in reqs:
            log.append((tick, n, op, pl, r))
            if n.startswith("e") and op == "sample" and r.error is None \
                    and isinstance(srv, KernelGraphServable):
                r.payload["_resident"] = srv.tenant(n).resident
    rep = srv.report()
    return ticks, log, rep


@pytest.mark.parametrize("checks", ["0", "1"])
def test_servable_matches_the_reference_on_a_scripted_stream(checks,
                                                             monkeypatch):
    monkeypatch.setenv("REPRO_CHECKS", checks)
    tsrv = KernelGraphServable(max_resident=2, device="cpu")
    jsrv = jserving.KernelGraphServable(max_resident=2)
    tt, tlog, trep = _run_stream(tsrv)
    jt, jlog, jrep = _run_stream(jsrv)
    assert tt == jt
    for k in ("ticks", "served", "failed", "admissions", "evictions",
              "resident", "tenants", "flags", "flag_counts",
              "device_counters"):
        assert trep[k] == jrep[k], k
    assert trep["device_counters"]["words"] > 0
    terr = [(t, n, op, type(r.error).__name__) for t, n, op, _, r in tlog
            if r.error is not None]
    jerr = [(t, n, op, type(r.error).__name__) for t, n, op, _, r in jlog
            if r.error is not None]
    assert terr == jerr and ("KeyError" in {e[3] for e in terr})
    if checks == "1":
        assert any(e[3] == "EstimationError" for e in terr)
    for (_, _, _, _, r), (_, _, _, _, j) in zip(tlog, jlog):
        assert r.status == j.status and r.done and j.done
        if r.error is None:
            if r.op == "sample":
                assert r.result[0].shape == j.result[0].shape
            elif r.op in ("query", "prob_of"):
                assert r.result.shape == j.result.shape


def test_exact_served_probabilities_equal_the_reference_prob_of():
    """Each served exact-tenant ``sample``'s probability equals the
    reference's q(neighbor | src) for the same pair at the same epoch
    (rtol 2e-4): the port's draw is another realization of the same law,
    its probability the same function."""
    tsrv = KernelGraphServable(max_resident=4, device="cpu")
    jsrv = jserving.KernelGraphServable(max_resident=4)
    for srv, ker in ((tsrv, gaussian(1.0)), (jsrv, jgaussian(1.0))):
        for name, shift in (("a", 0.0), ("b", 0.5)):
            srv.add_tenant(name, _data(f"pp-{name}", shift), ker,
                           block_size=BS, exact_blocks=True, seed=1)
    rng = np.random.default_rng(3)
    for tick in range(2):
        reqs = [tsrv.submit(n, "sample", src=rng.integers(0, N, w), seed=s)
                for s, (n, w) in enumerate((("a", 16), ("b", 16),
                                            ("a", 11), ("b", 5)))]
        tsrv.tick()
        if tick == 1:
            break
        jreq = [jsrv.submit(r.tenant, "prob_of", seed=0,
                            src=r.payload["src"], dst=r.result[0])
                for r in reqs]
        jsrv.tick()
        for r, j in zip(reqs, jreq):
            assert r.error is None and j.error is None
            np.testing.assert_allclose(r.result[1], j.result, rtol=2e-4)


@pytest.mark.parametrize("read", ["stratified", "hash"])
def test_served_draws_match_the_reference_in_law(read):
    """Padded draws (width 100 -> bucket 128) from one source through the
    port's servable against the reference's: TV within the stats.py
    tolerance (alpha 1e-3)."""
    kw = {"stratified": {}, "hash": dict(level1="hash")}[read]
    x = _data(f"tv-{read}")
    tsrv = KernelGraphServable(device="cpu")
    jsrv = jserving.KernelGraphServable()
    tsrv.add_tenant("t", x, gaussian(1.0), block_size=BS, seed=9, **kw)
    jsrv.add_tenant("t", x, jgaussian(1.0), block_size=BS, seed=9, **kw)
    cap = tsrv.dataset("t").capacity
    u0, w, reps = 7, 100, 8
    h_t, h_j = np.zeros(cap), np.zeros(cap)
    for i in range(reps):
        rt = tsrv.submit("t", "sample", src=np.full(w, u0),
                         seed=stats.derive_seed(read, "port", i))
        rj = jsrv.submit("t", "sample", src=np.full(w, u0),
                         seed=stats.derive_seed(read, "ref", i))
        tsrv.tick()
        jsrv.tick()
        assert rt.error is None and rj.error is None
        h_t += np.bincount(rt.result[0], minlength=cap)
        h_j += np.bincount(rj.result[0], minlength=cap)
    tv = stats.tv_distance(h_t, h_j)
    assert tv < stats.tv_tolerance(cap, w * reps), tv


# ------------------------------------------------------------------- #
# lifecycle and guards (the reference's own cases, on the port)
# ------------------------------------------------------------------- #
def test_lru_admission_eviction_readmission():
    srv = KernelGraphServable(max_resident=1, device="cpu")
    srv.add_tenant("a", _data("lru-a"), gaussian(1.0), block_size=BS)
    srv.add_tenant("b", _data("lru-b"), gaussian(1.0), block_size=BS)
    srv.submit("a", "sample", src=np.arange(8), seed=1)
    srv.tick()
    assert srv.tenant("a").resident and not srv.tenant("b").resident
    srv.submit("b", "sample", src=np.arange(8), seed=2)
    srv.tick()
    assert not srv.tenant("a").resident and srv.tenant("b").resident
    assert srv.evictions == 1
    r = srv.submit("a", "sample", src=np.arange(8), seed=3)
    srv.tick()
    assert r.error is None and srv.tenant("a").builds == 2
    assert srv.report()["admissions"] == 3


def test_epoch_stale_isolated_per_request(monkeypatch):
    monkeypatch.setenv("REPRO_CHECKS", "1")
    srv = KernelGraphServable(device="cpu")
    srv.add_tenant("t", _data("stale"), gaussian(1.0), block_size=BS)
    srv.dataset("t").delete_rows(np.array([5]))
    bad = srv.submit("t", "sample", src=np.array([4, 5, 6, 7]), seed=1)
    ok = srv.submit("t", "sample", src=np.array([10, 11, 12, 13]), seed=2)
    st = srv.tick()
    assert st["stale"] == 1 and st["failed"] == 1 and st["served"] == 1
    assert bad.error is not None and "EPOCH_STALE" in str(bad.error)
    assert bad.result is None
    assert ok.error is None and np.isfinite(ok.result[1]).all()
    assert srv.dataset("t").is_live(ok.result[0])


def test_group_failure_and_bad_payload_isolated_per_request():
    srv = KernelGraphServable(device="cpu")
    srv.add_tenant("a", _data("iso-a"), gaussian(1.0), block_size=BS)
    srv.add_tenant("b", _data("iso-b", 0.8), gaussian(1.0), block_size=BS)
    bad = srv.submit("a", "query", y=np.zeros((4, D + 3), np.float32),
                     seed=881)
    nolen = srv.submit("a", "walk", starts=np.arange(8), seed=883)
    ok = srv.submit("b", "sample", src=np.arange(8), seed=882)
    st = srv.tick()
    assert st["failed"] == 2 and st["served"] == 1
    assert bad.error is not None and bad.result is None and bad.done
    assert isinstance(nolen.error, KeyError)
    assert ok.error is None and np.isfinite(ok.result[1]).all()
    with pytest.raises(ValueError, match="widths differ"):
        srv.submit("a", "prob_of", src=np.arange(4), dst=np.arange(5))


def test_mesh_tenants_are_not_in_this_slice():
    """Mesh tenants are ported since the mesh slice
    (``tests/test_torch_mesh_pipelines.py`` serves one on gloo ranks):
    ``mesh=`` takes a ``DeviceMesh`` (TypeError for anything else), and
    ``data_axes`` without a mesh changes nothing, as in the reference."""
    srv = KernelGraphServable(device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        srv.add_tenant("m", _data("m"), gaussian(1.0), mesh=object())
    srv.add_tenant("m", _data("m"), gaussian(1.0), data_axes=("x",))
    assert srv.tenant("m").mesh is None
    r = srv.submit("m", "sample", src=np.arange(8), seed=3)
    srv.tick()
    assert r.error is None and np.isfinite(r.result[1]).all()


def test_noise_depends_on_seed_and_shape_only():
    """A request served alone and in a mixed two-tenant group at its
    bucket width returns the same draws."""
    srv = KernelGraphServable(device="cpu")
    for name in ("a", "b"):
        srv.add_tenant(name, _data(f"solo-{name}"), gaussian(1.0),
                       block_size=BS, seed=2)
    r1 = srv.submit("a", "sample", src=np.arange(16), seed=77)
    srv.tick()
    srv.submit("b", "sample", src=np.arange(16) + 3, seed=5)
    r2 = srv.submit("a", "sample", src=np.arange(16), seed=77)
    srv.submit("b", "sample", src=np.arange(16) + 9, seed=6)
    assert srv.tick()["groups"] == 1
    np.testing.assert_array_equal(r1.result[0], r2.result[0])
    np.testing.assert_array_equal(r1.result[1], r2.result[1])


def test_telemetry_records_serving_metrics():
    from repro_torch.obs import metrics as M
    M.reset()
    M.enable()
    try:
        srv = KernelGraphServable(device="cpu")
        srv.add_tenant("a", _data("tm"), gaussian(1.0), block_size=BS)
        srv.submit("a", "sample", src=np.arange(8), seed=1)
        srv.tick()
        reg = M.get_registry()
        assert reg["counters"]["serve.served"] == 1
        assert "serve.tick.us" in reg["histograms"]
        assert "serve.latency.a.sample.us" in reg["histograms"]
        assert reg["gauges"]["serve.resident"] == 1.0
    finally:
        M.reset()
        M.disable()


# ------------------------------------------------------------------- #
# the CLI
# ------------------------------------------------------------------- #
def _metrics(out: str) -> dict:
    lines = [ln for ln in out.splitlines()
             if ln.startswith(texport.METRICS_PREFIX)]
    assert len(lines) == 1, out
    m = json.loads(lines[0][len(texport.METRICS_PREFIX):])
    texport.validate_metrics_line(m)
    return m


def _main(argv):
    from repro_torch.launch.serve import main
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_cli_multi_tenant(monkeypatch):
    monkeypatch.delenv("REPRO_CHECKS", raising=False)
    rc, out = _main(["--device", "cpu", "--serve-tenants", "4",
                     "--requests", "16", "--ticks", "2", "--level1", "hash",
                     "--telemetry", "--metrics-format", "prometheus"])
    m = _metrics(out)
    assert rc == 0 and m["mode"] == "multi-tenant"
    assert m["served"] == 32 and m["failed"] == 0
    assert "repro_serve_tick_us" in out


def test_cli_graph_stream(monkeypatch):
    monkeypatch.delenv("REPRO_CHECKS", raising=False)
    rc, out = _main(["--device", "cpu", "--graph-stream", "4096",
                     "--ticks", "2"])
    m = _metrics(out)
    assert rc == 0 and m["error"] is None
    assert m["mode"] == "graph-stream" and m["ticks"] == 2
    assert m["flags"] == [] and m["live"] == 4096


def test_cli_graph_stream_epoch_stale_exits_3(monkeypatch, capsys):
    """Scripted trace (the reference test's): tick 2 deletes tick 1's
    reused frontier; under REPRO_CHECKS=1 the consumer-side EPOCH_STALE
    check promotes to an EstimationError -> exit 3, in the metrics
    line."""
    monkeypatch.setenv("REPRO_CHECKS", "1")
    from repro_torch.launch.serve import run_graph_stream
    rng = np.random.default_rng(stats.derive_seed("serving", "cli-stale"))
    args = argparse.Namespace(graph_stream=192, ticks=3, mutate_frac=0.02,
                              level1="blocked", seed=0, reuse_frontier=True,
                              device="cpu")
    trace = [dict(insert=rng.normal(size=(4, 16)).astype(np.float32)),
             dict(delete="frontier"), dict()]
    rc = run_graph_stream(args, trace=trace)
    m = _metrics(capsys.readouterr().out)
    assert rc == 3
    assert "EPOCH_STALE" in (m["error"] or "")
    assert m["ticks"] < m["ticks_planned"]
