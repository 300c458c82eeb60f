"""The port's level-1 kernels (plain versions), KDE oracles, status bits
and counter words against the JAX reference.

On the CPU every kernel wrapper takes its plain PyTorch version; these
tests hold those plain versions to the reference's jnp oracles on ragged
shapes and a non-power-of-two block size.  The CUDA kernels themselves
are held to the plain versions on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.core.kde import base as jbase
from repro.core.kernels_fn import make_kernel as jmake
from repro.ft import guards as jg
from repro.kernels.kde_rowsum import ops as jrs_ops
from repro.kernels.kde_rowsum import ref as jrs_ref
from repro.kernels.kde_sampler import ops as jops
from repro.kernels.kde_sampler import ref as jref
from repro.obs import counters as jc
from repro_torch.core.kde import base as tbase
from repro_torch.core.kernels_fn import make_kernel as tmake
from repro_torch.device import resolve_device
from repro_torch.ft import guards as tg
from repro_torch.kernels.kde_rowsum import kernel as trk
from repro_torch.kernels.kde_rowsum import ops as trs_ops
from repro_torch.kernels.kde_rowsum import ref as trs_ref
from repro_torch.kernels.kde_sampler import kernel as tsk
from repro_torch.kernels.kde_sampler import ops as tops
from repro_torch.obs import counters as tc

# the reference's own Pallas-vs-oracle tolerance (tests/test_pallas_kernels)
RTOL, ATOL = 2e-4, 1e-5
KINDS = ["gaussian", "exponential", "laplacian", "rational_quadratic"]
# (m, n, d, bn): ragged everything with a non-power-of-two block size, and
# an aligned case
SHAPES = [(37, 301, 19, 70), (16, 256, 5, 64)]
# one compiled program per oracle call instead of op-by-op dispatch, which
# compiles every primitive of the oracle separately for each new shape
_rowsum_ref = jax.jit(jrs_ref.rowsum_ref, static_argnums=(2, 3, 4))
_blocksum_ref = jax.jit(jrs_ref.blocksum_ref, static_argnums=(2, 3, 4, 5))
_masked_block_sums_ref = jax.jit(jref.masked_block_sums_ref,
                                 static_argnums=(4, 5, 6, 7))
_sample_block_ref = jax.jit(jref.sample_block_ref,
                            static_argnums=(5, 6, 7, 8))


def _case(kind, shape):
    m, n, d, bn = shape
    rng = np.random.default_rng(stats.derive_seed("torch_kde", kind, *shape))
    q = rng.normal(0, 0.4, (m, d)).astype(np.float32)
    x = rng.normal(0, 0.4, (n, d)).astype(np.float32)
    nb = -(-n // bn)
    own = rng.integers(-1, nb, size=m).astype(np.int32)
    g = rng.gumbel(size=(m, nb)).astype(np.float32)
    inv_bw = 1.0 / (0.25 * d) if kind == "laplacian" else \
        1.0 / (0.5 * np.sqrt(d))
    return q, x, own, g, float(inv_bw), 0.7, bn


@functools.partial(jax.jit, static_argnums=1)
def _padded(x, bn):
    """The reference's far-offset padding of the dataset to a block
    multiple (kernel values of pad rows are exactly 0)."""
    xp = jrs_ops._pad_rows(jnp.asarray(x), bn, jrs_ops._PAD_OFFSET)
    return xp, jnp.sum(xp * xp, axis=-1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_rowsum_and_blocksum_plain_match_reference(kind, shape):
    """rowsum / blocksum plain versions vs ``rowsum_ref`` /
    ``blocksum_ref`` (the latter on the far-offset padded dataset): rtol
    2e-4 / atol 1e-5."""
    q, x, _, _, inv_bw, beta, bn = _case(kind, shape)
    tq, tx = torch.as_tensor(q), torch.as_tensor(x)
    want = np.asarray(_rowsum_ref(jnp.asarray(q), jnp.asarray(x), kind,
                                  inv_bw, beta))
    got = trk.rowsum_plain(tq, tx, kind, inv_bw, beta).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    xp, _ = _padded(x, bn)
    want = np.asarray(_blocksum_ref(jnp.asarray(q), xp, kind, inv_bw, beta,
                                    bn))
    got = trk.blocksum_plain(tq, tx, kind, inv_bw, beta, bn).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_masked_and_sample_block_plain_match_reference(kind, shape):
    """masked_blocksum / sample_block plain versions vs
    ``masked_block_sums_ref`` / ``sample_block_ref`` with the same Gumbel
    noise (own = -1 rows included): floats rtol 2e-4 / atol 1e-5, the
    drawn block identical except on rows whose top two scores lie within
    1e-5."""
    q, x, own, g, inv_bw, beta, bn = _case(kind, shape)
    xp, xp_sq = _padded(x, bn)
    tq, tx, town = torch.as_tensor(q), torch.as_tensor(x), \
        torch.as_tensor(own)
    want = np.asarray(_masked_block_sums_ref(
        jnp.asarray(q), xp, xp_sq, jnp.asarray(own), kind, inv_bw, beta, bn))
    got = tsk.masked_blocksum_plain(tq, tx, town, kind, inv_bw, beta, bn)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    rblk, rpb, rtot, rbs = [np.asarray(a) for a in _sample_block_ref(
        jnp.asarray(q), xp, xp_sq, jnp.asarray(own), jnp.asarray(g), kind,
        inv_bw, beta, bn)]
    blk, pb, tot, bs = [a.numpy() for a in tsk.sample_block_plain(
        tq, tx, town, torch.as_tensor(g), kind, inv_bw, beta, bn)]
    score = np.sort(np.log(rbs) + g, axis=1)
    tie = score[:, -1] - score[:, -2] <= 1e-5
    assert np.all((blk == rblk) | tie)
    keep = ~tie
    np.testing.assert_allclose(bs, rbs, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tot, rtot, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pb[keep], rpb[keep], rtol=RTOL, atol=ATOL)


def tie_case(kind, m, n, d, bn, seed=0):
    """Planted exact ties: dyadic coordinates (k / 8, |k| <= 4), so every
    distance is exact in f32 in any summation order; block ``hi`` is a
    copy of block ``lo``, no row owns either, and both get the same large
    Gumbel noise, so every row's top two scores tie exactly."""
    rng = np.random.default_rng(seed)
    nb = -(-n // bn)
    lo, hi = 1, n // bn - 1
    x = (rng.integers(-4, 5, (n, d)) / 8.0).astype(np.float32)
    x[hi * bn:(hi + 1) * bn] = x[lo * bn:(lo + 1) * bn]
    q = (rng.integers(-4, 5, (m, d)) / 8.0).astype(np.float32)
    own = rng.integers(-1, nb, m).astype(np.int32)
    own[(own == lo) | (own == hi)] = -1
    g = rng.gumbel(size=(m, nb)).astype(np.float32)
    g[:, lo] = g[:, hi] = 30.0
    inv_bw = 1.0 / (0.25 * d) if kind == "laplacian" else 1.0 / (0.5 * d ** 0.5)
    return q, x, own, g, float(inv_bw), lo


@pytest.mark.parametrize("kind", KINDS)
def test_sample_block_plain_ties_go_to_the_lower_block(kind):
    """Two blocks with the same rows and equal Gumbel noise:
    ``sample_block_plain`` and the reference's ``sample_block_ref`` both
    draw the lower block on every row (first maximum, the reference's
    strict-">" update), with equal sums."""
    q, x, own, g, inv_bw, lo = tie_case(kind, 40, 512, 16, 64)
    xp, xp_sq = _padded(x, 64)
    rblk, _, rtot, rbs = [np.asarray(a) for a in _sample_block_ref(
        jnp.asarray(q), xp, xp_sq, jnp.asarray(own), jnp.asarray(g), kind,
        inv_bw, 0.7, 64)]
    blk, pb, tot, bs = tsk.sample_block_plain(
        torch.as_tensor(q), torch.as_tensor(x), torch.as_tensor(own),
        torch.as_tensor(g), kind, inv_bw, 0.7, 64)
    hi = bs.shape[1] - 1
    assert np.array_equal(rbs[:, lo], rbs[:, hi])
    assert torch.equal(bs[:, lo], bs[:, hi])
    assert np.all(rblk == lo) and bool((blk == lo).all())
    np.testing.assert_allclose(bs.numpy(), rbs, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tot.numpy(), rtot, rtol=RTOL, atol=ATOL)


# (m, n, d, bn, aligned) -> (instance, query tiles): the main path's edge
# batch and sampler frontier, chip_smoke.py's ragged checks (d = 19, 784),
# the CUDA tests' wide ragged shapes, their tie cases, and a view off 16
# bytes (the generic tile)
PLAN_CASES = [
    ((1024, 65536, 16, 256, True), (16, 8)),
    ((4096, 65536, 16, 256, True), (16, 32)),
    ((37, 301, 19, 70, True), (0, 1)),
    ((20, 203, 784, 50, True), (0, 1)),
    ((37, 301, 8, 70, True), (16, 1)),
    ((130, 1000, 32, 256, True), (32, 2)),
    ((300, 2048, 19, 256, True), (0, 5)),
    ((1024, 65536, 16, 256, False), (0, 16)),
    ((0, 10, 4, 4, True), (16, 0)),
]


@pytest.mark.parametrize("args,want", PLAN_CASES)
def test_sample_block_plan_picks_the_instance(args, want):
    """The host-side plan of the sampler kernels: the wide 128-row tile
    (d padded to 16 or 32) where d % 4 == 0, d <= 32 and the rows start on
    16 bytes, the generic 64-row tile elsewhere; the grid of
    ceil(nb / group) x tiles CTAs fits one wave of resident CTAs on 132
    SMs unless a group would exceed the tile's blocks."""
    plan = tsk.sample_block_plan(*args)
    assert (plan.instance, plan.tiles) == want
    assert plan.bm == (64 if plan.instance == 0 else 128)
    assert plan.nb == -(-args[1] // args[3])
    ctas = -(-plan.nb // plan.group) * plan.tiles
    slots = tsk.CTAS_PER_SM * 132
    assert 1 <= plan.group <= max(plan.nb, 1)
    assert ctas <= slots + plan.tiles or plan.group == plan.nb


def test_sample_block_plan_groups_blocks_into_one_wave():
    """The edge batch (m 1024, bn 256 over n 65536: 8 tiles x 256 blocks)
    runs 8 blocks a CTA, 256 CTAs on 132 SMs; the sampler frontier (m
    4096) 32; small calls one; fewer SMs, larger groups."""
    assert tsk.sample_block_plan(1024, 65536, 16, 256).group == 8
    assert tsk.sample_block_plan(4096, 65536, 16, 256).group == 32
    assert tsk.sample_block_plan(37, 301, 19, 70).group == 1
    assert tsk.sample_block_plan(1024, 65536, 16, 256, sms=66).group == 16
    assert tsk.sample_block_plan(64, 1000, 19, 10).group == 1


#: (m, n, d, bn, aligned) -> (instance, group) of the blocksum
BLOCKSUM_PLAN_CASES = [
    ((1024, 65536, 16, 256, True), (16, 8)),
    ((37, 301, 8, 70, True), (16, 1)),
    ((130, 1000, 32, 256, True), (32, 1)),
    ((130, 3000, 36, 256, True), (trk.DEEP, 1)),
    ((20, 203, 784, 50, True), (trk.DEEP, 1)),
    ((300, 5000, 784, 256, True), (trk.DEEP, 1)),
    ((37, 301, 19, 70, True), (0, 1)),
    ((300, 2048, 19, 256, True), (0, 1)),
    ((1024, 65536, 16, 256, False), (0, 1)),
    ((20, 203, 784, 50, False), (0, 1)),
]


@pytest.mark.parametrize("args,want", BLOCKSUM_PLAN_CASES)
def test_blocksum_plan_picks_the_tile(args, want):
    """The blocksum's plan: the sampler's wide tile where it takes the
    shape (d % 4 == 0, d <= 32, rows on 16 bytes), the deep 128-row tile
    for d > 32 under the same conditions, the generic tile (one block a
    CTA) elsewhere; the 128-row tiles group blocks into one wave."""
    m, n, d, bn, aligned = args
    plan = trk.blocksum_plan(*args)
    assert (plan.instance, plan.group) == want
    assert plan.bm == (64 if plan.instance == 0 else 128)
    assert plan.nb == -(-n // bn)
    if plan.instance:
        assert plan.group == tsk.group_for(plan.tiles, plan.nb, 132)


#: (m, n, d, aligned) -> (instance, splits, cols) of the rowsum
ROWSUM_PLAN_CASES = [
    ((1024, 16384, 784, True), (trk.DEEP, 32, 512)),
    ((1024, 16384, 784, False), (0, 32, 512)),
    ((1024, 16384, 19, True), (0, 32, 512)),
    ((1024, 65536, 16, True), (16, 32, 2048)),
    ((37, 301, 8, True), (16, 3, 128)),
    ((300, 5000, 784, True), (trk.DEEP, 40, 128)),
    ((20, 203, 784, True), (trk.DEEP, 2, 128)),
]


@pytest.mark.parametrize("args,want", ROWSUM_PLAN_CASES)
def test_rowsum_plan_splits_n_to_fill_the_card(args, want):
    """The rowsum's first pass is a blocksum over splits of a chunk
    multiple, one split a CTA: the 128-row tiles aim for 2 CTAs an SM
    (the LRA's m = 1024, n = 16384: 8 query tiles x 32 splits of 512
    columns), the generic tile for 4 (unchanged)."""
    m, n, d, aligned = args
    plan, cols = trk.rowsum_plan(*args)
    assert (plan.instance, plan.nb, cols) == want
    assert plan.group == 1 and plan.nb == -(-n // cols)
    chunk = 64 if plan.instance == 0 else 128
    assert cols % chunk == 0 and (plan.nb - 1) * cols < n


def test_rowsum_plan_refuses_what_the_kernel_does_not_take():
    for args, match in (((4, 0, 4), "empty"), ((4, 8, 0), ">= 1"),
                        ((4, 2 ** 31, 4), "int32")):
        with pytest.raises(ValueError, match=match):
            trk.rowsum_plan(*args)


def test_sample_block_plan_refuses_what_the_kernel_does_not_take():
    for args, match in (((4, 0, 4, 4), "empty"), ((4, 8, 0, 4), ">= 1"),
                        ((4, 8, 4, 0), ">= 1"),
                        ((128 * 65535 + 1, 8, 4, 4), "65535"),
                        ((64 * 65535 + 1, 8, 5, 4), "65535"),
                        ((4, 2 ** 31, 4, 4), "int32")):
        with pytest.raises(ValueError, match=match):
            tsk.sample_block_plan(*args)
    assert tsk.sample_block_plan(128 * 65535, 8, 4, 4).tiles == 65535


def test_sample_block_wrapper_contract_on_the_cpu():
    """``ops.sample_block`` on CPU tensors takes the plain version: blk is
    int64, and an int32 or int64 own gives the same draw; the CUDA wrapper
    refuses CPU tensors before anything is built."""
    q, x, own, g, inv_bw, beta, bn = _case("gaussian", SHAPES[0])
    tq, tx, tg_ = torch.as_tensor(q), torch.as_tensor(x), torch.as_tensor(g)
    cfg = dict(kind="gaussian", inv_bw=inv_bw, beta=beta, block_size=bn)
    outs = [tops.sample_block(tq, tx, torch.as_tensor(own).to(dt), tg_, **cfg)
            for dt in (torch.int32, torch.int64)]
    assert outs[0][0].dtype == torch.int64
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert tsk.LAUNCHES == {"masked_blocksum": 0, "sample_block": 0,
                            "masked_blocksum_bf16": 0,
                            "sample_block_bf16": 0}
    with pytest.raises(ValueError, match="CUDA"):
        tsk.sample_block_cuda(tq, tx, torch.as_tensor(own).float(), tg_,
                              "gaussian", inv_bw, beta, bn)


@pytest.mark.parametrize("kind", KINDS)
def test_exact_kde_matches_reference(kind):
    """``ExactKDE.query`` (the rowsum path) and ``ExactBlockKDE``'s
    block sums and row sums vs the reference classes on the CPU: rtol
    2e-4 / atol 1e-5; eval counters exactly equal."""
    q, x, _, _, inv_bw, beta, bn = _case(kind, SHAPES[0])
    jk = jmake(kind, bandwidth=1.0 / inv_bw, **(
        {"beta": beta} if kind == "rational_quadratic" else {}))
    tk = tmake(kind, bandwidth=1.0 / inv_bw, **(
        {"beta": beta} if kind == "rational_quadratic" else {}))
    ref, port = jbase.ExactKDE(x, jk), tbase.ExactKDE(x, tk, device="cpu")
    np.testing.assert_allclose(port.query(torch.as_tensor(q)).numpy(),
                               np.asarray(ref.query(jnp.asarray(q))),
                               rtol=RTOL, atol=ATOL)
    assert port.evals == ref.evals == q.shape[0] * x.shape[0]
    ref = jbase.ExactBlockKDE(x, jk, block_size=bn)
    port = tbase.ExactBlockKDE(x, tk, block_size=bn, device="cpu")
    np.testing.assert_allclose(port.block_sums(torch.as_tensor(q)).numpy(),
                               np.asarray(ref.block_sums(jnp.asarray(q))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.query(torch.as_tensor(q)).numpy(),
                               np.asarray(ref.query(jnp.asarray(q))),
                               rtol=RTOL, atol=ATOL)
    assert port.evals == ref.evals
    assert port.device_counters.as_dict() == ref.device_counters.as_dict()


def test_exact_block_sums_program_word_matches_reference():
    """``ops.exact_block_sums``: sums at rtol 2e-4 / atol 1e-5 and the
    identical counter word."""
    q, x, _, _, inv_bw, beta, bn = _case("gaussian", SHAPES[0])
    n = x.shape[0]
    cfg = dict(kind="gaussian", inv_bw=inv_bw, beta=beta, block_size=bn,
               num_blocks=-(-n // bn), n=n)
    xj = jnp.asarray(x)
    rbs, rw = jops.exact_block_sums(jnp.asarray(q), xj,
                                    jnp.sum(xj * xj, -1), pairwise=None,
                                    **cfg)
    tx = torch.as_tensor(x)
    bs, w = tops.exact_block_sums(torch.as_tensor(q), tx, (tx * tx).sum(-1),
                                  **cfg)
    np.testing.assert_allclose(bs.numpy(), np.asarray(rbs), rtol=RTOL,
                               atol=ATOL)
    assert tc.totals(w) == jc.totals(np.asarray(rw))


def test_pad_rows_convention():
    """Pad rows at +_PAD_OFFSET give a kernel value of exactly 0 for every
    kind, as in the reference."""
    x = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    tx = torch.as_tensor(x)
    xp = trs_ops._pad_rows(tx, 8, trs_ops._PAD_OFFSET)
    assert tuple(xp.shape) == (8, 7)
    np.testing.assert_array_equal(
        xp.numpy(), np.asarray(jrs_ops._pad_rows(jnp.asarray(x), 8,
                                                 jrs_ops._PAD_OFFSET)))
    for kind in KINDS:
        kv = trs_ref.kernel_values(tx, xp, kind, 0.5, 0.3)
        assert torch.all(kv[:, 5:] == 0.0), kind


@pytest.mark.parametrize("vals", [
    dict(status=5, evals=7, l1_reads=3, draws=2),
    dict(evals=(1 << 32) + 11, far_samples=4, psums=1),
    dict(status=jg.FATAL, retries=(1 << 33) + 3, overflow=9)])
def test_counter_words_match_reference(vals):
    """Slot for slot the same word (int64 here, uint32 there), with the
    same mod-2^32 wrap; fold and scale agree too."""
    ref = np.asarray(jc.word(**vals)).astype(np.int64)
    port = tc.word(**vals)
    np.testing.assert_array_equal(port.numpy(), ref)
    other = dict(status=2, evals=(1 << 32) - 1, draws=5)
    np.testing.assert_array_equal(
        tc.fold(port, tc.word(**other)).numpy(),
        np.asarray(jc.fold(jc.word(**vals), jc.word(**other))).astype(
            np.int64))
    np.testing.assert_array_equal(
        tc.scale(port, 3).numpy(),
        np.asarray(jc.scale(jc.word(**vals), 3)).astype(np.int64))
    assert tc.totals(port) == jc.totals(np.asarray(jc.word(**vals)))
    ht, hr = tc.HostTotals(), jc.HostTotals()
    assert ht.note(port) == hr.note(jc.word(**vals))
    assert ht.as_dict() == hr.as_dict()


def test_status_bits_and_helpers_match_reference(monkeypatch):
    """Same bit layout, same host decoding, same device reductions, and
    REPRO_CHECKS=1 promotes fatal flags in both."""
    assert tg.STATUS_NAMES == jg.STATUS_NAMES
    assert (tg.FATAL, tg.RETRYABLE) == (jg.FATAL, jg.RETRYABLE)
    bs = np.array([[1e-12, 1e-12], [0.5, np.inf]], np.float32)
    want = int(jg.sums_status(jnp.asarray(bs), 1e-12))
    assert int(tg.sums_status(torch.as_tensor(bs), 1e-12)) == want
    assert want == jg.NONFINITE | jg.ZERO_MASS
    a = np.array([1.0, np.nan], np.float32)
    assert int(tg.result_status(torch.as_tensor(a))) == \
        int(jg.result_status(jnp.asarray(a)))
    word = tc.word(status=tg.merge(tg.NONFINITE, torch.tensor(tg.HT_HEAVY)))
    assert tg.decode_status(word) == jg.decode_status(
        np.asarray(jc.word(status=jg.NONFINITE | jg.HT_HEAVY)))
    monkeypatch.setenv("REPRO_CHECKS", "1")
    with pytest.raises(tg.EstimationError):
        tg.raise_on_status(word, "probe")
    assert tg.raise_on_status(tc.word(status=tg.HT_HEAVY), "probe",
                              allow=tg.HT_HEAVY) == tg.HT_HEAVY


def test_device_defaults_to_the_card_and_slice_limits():
    """``device=None`` means CUDA and never drops to the CPU; options the
    port does not cover yet raise NotImplementedError (every estimator
    name is ported, ``grid_hbe`` and ``robust`` since the remaining
    estimators' slice, and ``precision="bf16"``: bf16 constructs, and bf16
    with the laplacian raises the reference's ValueError).  The mesh
    options are ported (the mesh slice): ``mesh=`` takes a ``DeviceMesh``
    (TypeError otherwise; ``tests/test_torch_mesh*.py`` run real ones),
    and ``data_axes`` without a mesh changes nothing, as in the
    reference."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    x = np.zeros((4, 2), np.float32)
    for name, cls in (("robust", "RobustEstimator"),
                      ("grid_hbe", "GridHBE")):
        est = tbase.make_estimator(name, x, tmake("gaussian"), device="cpu")
        assert type(est).__name__ == cls and est.device.type == "cpu"
    with pytest.raises(TypeError, match="DeviceMesh"):
        tbase.make_estimator("hash", x, tmake("gaussian"), device="cpu",
                             mesh=object())
    est = tbase.make_estimator("hash", x, tmake("gaussian"), device="cpu",
                               data_axes=("data", "model"))
    assert est.engine is None and est.state is not None
    est = tbase.make_estimator("hash", x, tmake("gaussian"), device="cpu",
                               precision="bf16")
    assert est.precision == "bf16"
    assert tbase.ExactKDE(x, tmake("gaussian"), precision="bf16",
                          device="cpu").precision == "bf16"
    with pytest.raises(ValueError, match="L2 kernels only"):
        tbase.make_estimator("hash", x, tmake("laplacian"), device="cpu",
                             precision="bf16")
    with pytest.raises(ValueError, match="L2 kernels only"):
        tbase.ExactKDE(x, tmake("laplacian"), precision="bf16", device="cpu")


def test_cuda_wrappers_reject_cpu_tensors():
    """The CUDA wrappers launch or raise: a CPU tensor is refused before
    anything is built (the CPU path goes through the plain versions)."""
    q = torch.zeros((3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        trk.rowsum_cuda(q, q, "gaussian", 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.sample_block_cuda(q, q, torch.zeros(3, dtype=torch.int32),
                              torch.zeros((3, 1)), "gaussian", 1.0, bn=4)
