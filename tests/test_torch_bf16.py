"""The bf16 precision policy (DESIGN.md §14) on the port, against the JAX
reference on the CPU.

The policy rounds query and dataset coordinates to bfloat16, sums exact
products in f32, recomputes both norms from the rounded coordinates and
reads exp() of the bf16-rounded argument from a 65,536-entry table.  The
reference's oracles that run here are its jnp ``ref.py`` functions and its
flat ``ops.py`` programs (``use_pallas=False``); its Pallas interpret paths
fail on this JAX (ROADMAP.md).

Tolerances:

- the table, ``exp_bf16`` and the bits: equal (NaN-aware: NaN payloads
  differ between libraries, every NaN entry is NaN);
- per-element kernel values: all but <= 1e-4 of the entries within rtol
  2e-4, and every entry within one bf16 step of its exp argument y,
  ``expm1(|y| 2^-7)`` relative.  This is the *flip allowance*: summing in
  another order moves the f32 argument by an ulp or so, and where that
  crosses a bf16 rounding midpoint the two sides read neighbouring table
  entries.  It is rare (a few entries in 10^6 on N(0, 0.5) data), not
  zero: do not tighten it to rtol alone;
- reduced outputs (row, block and weighted sums, the estimators'
  answers): rtol 2e-4 / atol 1e-5, the reference's kernel tolerance;
- each bf16 estimator against its f32 twin at the same seed: within
  ``2 * BF16_REL_ERR`` (the reference's ``tests/test_precision.py``).

The CUDA kernels are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``), where the flip allowance
is computed per pair (``ref.bf16_flip_slack``).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.core.kde.base import ExactBlockKDE as JExactBlockKDE
from repro.core.kde.base import ExactKDE as JExactKDE
from repro.core.kde.base import make_estimator as jmake_estimator
from repro.core.kernels_fn import make_kernel as jmake
from repro.core.sampling.edge import NeighborSampler as JNeighborSampler
from repro.core.sampling.rownorm import RowNormSampler as JRowNormSampler
from repro.kernels.kde_hash import ops as jhops
from repro.kernels.kde_hash import ref as jhref
from repro.kernels.kde_rowsum import ref as jrsref
from repro.kernels.kde_sampler import ops as jops
from repro.kernels.kde_sampler import ref as jref
from repro_torch.core.kde.base import (ExactBlockKDE, ExactKDE, RSKDE,
                                       StratifiedKDE, make_estimator)
from repro_torch.core.kde.hashed import HashedKDE
from repro_torch.core.kernels_fn import Kernel
from repro_torch.core.kernels_fn import make_kernel as tmake
from repro_torch.core.sampling.edge import NeighborSampler
from repro_torch.core.sampling.rownorm import RowNormSampler
from repro_torch.kernels import build
from repro_torch.kernels.kde_hash import kernel as thk
from repro_torch.kernels.kde_hash import ops as thops
from repro_torch.kernels.kde_hash import ref as thref
from repro_torch.kernels.kde_rowsum import kernel as trk
from repro_torch.kernels.kde_rowsum import ops as trs
from repro_torch.kernels.kde_sampler import kernel as tsk
from repro_torch.kernels.kde_sampler import ops as tops
from repro_torch.kernels.kde_sampler import ref as tref

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 1e-5
FLIP_SHARE = 1e-4          # entries allowed outside rtol (flips)
TIE = 1e-5
BOUND = 2.0 * tref.BF16_REL_ERR
L2 = ["gaussian", "exponential", "rational_quadratic"]

_kv_bf16 = jax.jit(jref.kv_matrix_bf16, static_argnums=(2, 3, 4))
_rowwise = jax.jit(jhref.rowwise_kv, static_argnums=(2, 3, 4, 5, 6))
_rowsum_ref = jax.jit(jrsref.rowsum_ref, static_argnums=(2, 3, 4, 5))
_blocksum_ref = jax.jit(jrsref.blocksum_ref, static_argnums=(2, 3, 4, 5, 6))


def _points(label, n, d=16, scale=0.5):
    rng = np.random.default_rng(stats.derive_seed("torch_bf16", label))
    return rng.normal(0, scale, (n, d)).astype(np.float32)


def _kernels(kind, bw=1.5):
    kw = dict(bandwidth=bw)
    if kind == "rational_quadratic":
        kw["beta"] = 0.7
    return jmake(kind, **kw), tmake(kind, **kw)


def _args(kind, bw=1.5):
    return kind, 1.0 / bw, 0.7 if kind == "rational_quadratic" else 1.0


def _y64(q, x, kind, inv_bw):
    """|exp argument| of every pair of the rounded rows, in float64; x (n,
    d) or gathered (w, t, d)."""
    qf = tref.round_bf16(torch.as_tensor(q)).double()
    xf = tref.round_bf16(torch.as_tensor(x)).double()
    if xf.dim() == 3:
        d2 = ((qf[:, None, :] - xf) ** 2).sum(-1)
    else:
        d2 = torch.cdist(qf, xf) ** 2
    y = d2 * inv_bw ** 2 if kind == "gaussian" else d2.sqrt() * inv_bw
    return y.numpy()


def _assert_values(got, want, kind, y):
    """Per-element kernel values of the bf16 policy: all but FLIP_SHARE of
    the entries within rtol 2e-4, every entry within one bf16 step of its
    exp argument (the rational quadratic reads no table: every entry
    within rtol)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    tol = RTOL * np.abs(want) + 1e-30
    off = err > tol
    if kind == "rational_quadratic":
        assert not off.any(), (int(off.sum()), float(err.max()))
        return
    assert off.mean() <= FLIP_SHARE, (int(off.sum()), off.size)
    step = np.expm1(np.abs(y) * 2.0 ** -7) * np.abs(want) * 1.01
    assert np.all(err <= np.maximum(tol, step)), float((err - step).max())


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL)


# --------------------------------------------------------------------- #
# the table, exp_bf16, check_precision
# --------------------------------------------------------------------- #
def _same_bits(a, b):
    """Equal float32 arrays, NaN-aware: the same NaN positions, equal bits
    elsewhere."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a[~nan].view(np.uint32),
                                  b[~nan].view(np.uint32))


def test_exp_table_is_bitwise_the_reference_table():
    """The port builds the table itself (numpy f64 exp over every bf16
    pattern, rounded to f32); it equals the reference's bit for bit, and
    its tensor copy equals it too."""
    _same_bits(tref.bf16_exp_table(), jref.bf16_exp_table())
    _same_bits(tref.exp_table_on("cpu").numpy(), jref.bf16_exp_table())
    t = tref.bf16_exp_table()
    assert t[0x8000] == 1.0 and t[0x0000] == 1.0       # exp(-0), exp(+0)
    assert t[0xFF80] == 0.0                             # exp(-inf)
    assert np.isinf(t[0x7F80])                          # exp(+inf)
    assert np.isnan(t[0x7FC0]) and np.isnan(t[0xFFC0])  # NaN patterns


def _tie_values():
    """f32 values exactly halfway between neighbouring bf16 values (both
    parities of the lower neighbour), and one f32 ulp either side."""
    lo = (np.arange(0x3E00, 0x4200, 7, dtype=np.uint32) << 16).view(
        np.float32)
    mid = (lo.view(np.uint32) + 0x8000).view(np.float32)
    near = np.concatenate([mid, np.nextafter(mid, np.float32(np.inf)),
                           np.nextafter(mid, np.float32(-np.inf))])
    return np.concatenate([near, -near]).astype(np.float32)


EXP_CASES = {
    "zeros": np.array([0.0, -0.0], np.float32),
    "infinities": np.array([-np.inf, np.inf], np.float32),
    "subnormals": np.array([1e-40, -1e-40, 1.4e-45, -1.4e-45, -1e-39,
                            -1.17e-38], np.float32),
    "ties": _tie_values(),
    "range": np.random.default_rng(0).uniform(
        -110.0, 12.0, 4096).astype(np.float32),
    "nan": np.array([np.nan, -np.nan, -1.0], np.float32),
}


@pytest.mark.parametrize("case", sorted(EXP_CASES))
def test_exp_bf16_matches_reference(case):
    """``exp_bf16`` (round to nearest even, table read) equals the
    reference's on signed zeros, infinities, subnormals, exact rounding
    ties and their neighbours, a wide range, and NaN (NaN stays NaN)."""
    y = EXP_CASES[case]
    got = tref.exp_bf16(torch.as_tensor(y)).numpy()
    want = np.asarray(jax.jit(jref.exp_bf16)(jnp.asarray(y)))
    _same_bits(got, want)


def test_bf16_bits_round_to_nearest_even():
    """The bit patterns of the rounded values equal JAX's
    ``astype(bfloat16)`` patterns (ties go to the even pattern)."""
    y = _tie_values()
    got = tref.bf16_bits(torch.as_tensor(y)).numpy()
    want = np.asarray(jax.lax.bitcast_convert_type(
        jnp.asarray(y).astype(jnp.bfloat16), jnp.uint16)).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    mid = y[:len(y) // 6]            # the exact midpoints, positive
    assert np.all(got[:len(mid)] % 2 == 0)


def _custom(torch_side):
    fn = (lambda a, b: torch.exp(-torch.cdist(a, b))) if torch_side else \
        (lambda a, b: jnp.exp(-jnp.sum(jnp.abs(a[:, None] - b[None]), -1)))
    return fn


PRECISION_CASES = [("fp8", "gaussian", False), ("bf16", "laplacian", False),
                   ("bf16", "gaussian", True), ("bf16", "gaussian", False),
                   ("bf16", "rational_quadratic", False),
                   ("f32", "laplacian", False), ("f32", "gaussian", True)]


@pytest.mark.parametrize("precision,kind,custom", PRECISION_CASES)
def test_check_precision_matches_reference(precision, kind, custom):
    """``check_precision`` raises ValueError exactly where the reference's
    does: an unknown precision, and bf16 with the laplacian or a custom
    pairwise kernel."""
    def raises(fn, *a):
        try:
            fn(*a)
        except ValueError:
            return True
        return False
    want = raises(jref.check_precision, precision, kind,
                  _custom(False) if custom else None)
    assert raises(tref.check_precision, precision, kind,
                  _custom(True) if custom else None) == want
    assert want == (precision == "fp8"
                    or (precision == "bf16" and (custom or kind == "laplacian")))


def _custom_kernel():
    return Kernel(name="custom", pairwise=_custom(True),
                  squaring_constant=None, kde_exponent=1.0)


CONSTRUCTORS = {
    "exact": lambda x, k, p: ExactKDE(x, k, precision=p, device="cpu"),
    "rs": lambda x, k, p: RSKDE(x, k, 8, precision=p, device="cpu"),
    "stratified": lambda x, k, p: StratifiedKDE(x, k, block_size=8,
                                                precision=p, device="cpu"),
    "exact_block": lambda x, k, p: ExactBlockKDE(x, k, block_size=8,
                                                 precision=p, device="cpu"),
    "hash": lambda x, k, p: HashedKDE(x, k, precision=p, device="cpu"),
    "sampler_exact": lambda x, k, p: NeighborSampler(
        x, k, exact_blocks=True, precision=p, device="cpu"),
    "sampler_stratified": lambda x, k, p: NeighborSampler(
        x, k, precision=p, device="cpu"),
    "sampler_hash": lambda x, k, p: NeighborSampler(
        x, k, level1="hash", precision=p, device="cpu"),
}


@pytest.mark.parametrize("ctor", sorted(CONSTRUCTORS))
def test_bf16_refusals_at_construction(ctor):
    """Every public class that takes ``precision`` constructs with bf16 on
    the L2 kinds and raises the reference's ValueError at construction for
    the laplacian, a custom pairwise kernel and an unknown precision."""
    x = _points("ctor", 64, d=4)
    make = CONSTRUCTORS[ctor]
    assert make(x, tmake("gaussian"), "bf16").precision == "bf16"
    for kernel, precision in ((tmake("laplacian"), "bf16"),
                              (_custom_kernel(), "bf16"),
                              (tmake("gaussian"), "fp8")):
        with pytest.raises(ValueError):
            make(x, kernel, precision)


def test_reference_refuses_the_same_at_construction():
    """The reference's estimators and sampler raise ValueError for bf16
    with the laplacian, as the port's (the pair the port mirrors)."""
    x = _points("ctor", 64, d=4)
    with pytest.raises(ValueError):
        JExactKDE(x, jmake("laplacian"), precision="bf16")
    with pytest.raises(ValueError):
        jmake_estimator("hash", x, jmake("laplacian"), precision="bf16")
    with pytest.raises(ValueError):
        JNeighborSampler(x, jmake("laplacian"), exact_blocks=True,
                         precision="bf16")


# --------------------------------------------------------------------- #
# per-element values and their plain reductions
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", L2)
def test_kv_matrix_bf16_matches_reference(kind):
    """(m, n) bf16 values against the reference's ``kv_matrix_bf16`` (the
    flip allowance of the module note), and ``kv_matrix(precision=
    "bf16")`` is the same function, ``x_sq`` unused."""
    q, x = _points("kvq", 64), _points("kvx", 4096)
    kind_, inv_bw, beta = _args(kind)
    got = tref.kv_matrix_bf16(torch.as_tensor(q), torch.as_tensor(x), kind_,
                              inv_bw, beta)
    want = _kv_bf16(jnp.asarray(q), jnp.asarray(x), kind_, inv_bw, beta)
    _assert_values(got.numpy(), want, kind, _y64(q, x, kind, inv_bw))
    via = tref.kv_matrix(torch.as_tensor(q), torch.as_tensor(x), None, kind_,
                         inv_bw, beta, precision="bf16")
    assert torch.equal(via, got)


@pytest.mark.parametrize("n", [4096, 4001])
@pytest.mark.parametrize("kind", L2)
def test_kv_block_sums_bf16_matches_reference(kind, n):
    """Per-block sums of the bf16 sweep (tail padded at the far offset:
    exactly 0) against the reference's column-tile scan, and against the
    blocksum kernel's plain version."""
    q, x = _points("kbq", 48), _points("kbx", n)
    kind_, inv_bw, beta = _args(kind)
    got = tref.kv_block_sums_bf16(torch.as_tensor(q), torch.as_tensor(x),
                                  kind_, inv_bw, beta, 256)
    want = jref.kv_block_sums_bf16(jnp.asarray(q), jnp.asarray(x), kind_,
                                   inv_bw, beta, bn=256)
    assert got.shape == (48, -(-n // 256))
    _close(got.numpy(), want)
    _close(trk.blocksum_plain(torch.as_tensor(q), torch.as_tensor(x), kind_,
                              inv_bw, beta, 256, precision="bf16").numpy(),
           want)


@pytest.mark.parametrize("kind", L2)
def test_rowsum_blocksum_plain_bf16_match_reference(kind):
    """The plain versions of the bf16 rowsum and blocksum kernels (and the
    CPU path of ``kde_rowsum`` / ``kde_blocksum``) against the reference's
    ``rowsum_ref`` / ``blocksum_ref(precision="bf16")``."""
    q, x = _points("rbq", 37, d=19), _points("rbx", 1024, d=19)
    jk, tk = _kernels(kind)
    kind_, inv_bw, beta = _args(kind)
    tq, tx = torch.as_tensor(q), torch.as_tensor(x)
    want = _rowsum_ref(jnp.asarray(q), jnp.asarray(x), kind_, inv_bw, beta,
                       "bf16")
    got = trk.rowsum_plain(tq, tx, kind_, inv_bw, beta, "bf16")
    _close(got.numpy(), want)
    assert torch.equal(trs.kde_rowsum(tq, tx, tk, precision="bf16"), got)
    want = _blocksum_ref(jnp.asarray(q), jnp.asarray(x), kind_, inv_bw, beta,
                         128, "bf16")
    got = trk.blocksum_plain(tq, tx, kind_, inv_bw, beta, 128, "bf16")
    _close(got.numpy(), want)
    assert torch.equal(trs.kde_blocksum(tq, tx, tk, bn=128,
                                        precision="bf16"), got)
    with pytest.raises(ValueError, match="L2 kernels only"):
        trs.kde_rowsum(tq, tx, tmake("laplacian"), precision="bf16")


def _masked_oracle(q, x, own, kind, inv_bw, beta, bn):
    """The reference's masked level-1 sums composed from its
    ``kv_matrix(precision="bf16")``: zero-padded to a block multiple,
    k(x, x) = 1 off each row's own block, floored."""
    kv = np.asarray(jax.jit(jref.kv_matrix, static_argnums=(3, 4, 5, 6, 7))(
        jnp.asarray(q), jnp.asarray(x), None, kind, inv_bw, beta, None,
        "bf16"), np.float64)
    pad = -x.shape[0] % bn
    kv = np.pad(kv, ((0, 0), (0, pad)))
    bs = kv.reshape(q.shape[0], -1, bn).sum(-1)
    rows = np.nonzero(own >= 0)[0]
    bs[rows, own[rows]] -= 1.0
    return np.maximum(bs, tref.BLOCK_SUM_FLOOR)


@pytest.mark.parametrize("kind", L2)
def test_masked_blocksum_plain_bf16_matches_reference_oracle(kind):
    """``masked_blocksum_plain(precision="bf16")`` (own -1: no own block;
    a ragged tail block) against the reference's bf16 values, own-corrected
    and floored."""
    x = _points("mbx", 1000)
    rng = np.random.default_rng(3)
    src = rng.integers(0, 1000, 70)
    own = src // 128
    own[::7] = -1
    kind_, inv_bw, beta = _args(kind)
    got = tsk.masked_blocksum_plain(torch.as_tensor(x[src]),
                                    torch.as_tensor(x), torch.as_tensor(own),
                                    kind_, inv_bw, beta, 128, "bf16")
    _close(got.numpy(), _masked_oracle(x[src], x, own, kind_, inv_bw, beta,
                                       128))


@pytest.mark.parametrize("kind", L2)
def test_sample_block_plain_bf16_matches_reference_oracle(kind):
    """``sample_block_plain(precision="bf16")`` under the same Gumbel noise
    as the reference oracle (its bf16 values, own mask, floor, argmax):
    the drawn block equal except on rows whose top two scores lie within
    1e-5; p_blk, tot and the sums within the kernel tolerance."""
    x = _points("sbx", 1000)
    rng = np.random.default_rng(4)
    src = rng.integers(0, 1000, 200)
    own = src // 128
    kind_, inv_bw, beta = _args(kind)
    bs = _masked_oracle(x[src], x, own, kind_, inv_bw, beta, 128)
    g = rng.gumbel(size=bs.shape).astype(np.float32)
    blk, pb, tot, tbs = tsk.sample_block_plain(
        torch.as_tensor(x[src]), torch.as_tensor(x), torch.as_tensor(own),
        torch.as_tensor(g), kind_, inv_bw, beta, 128, "bf16")
    score = np.log(bs) + g
    top2 = -np.sort(-score, axis=1)[:, :2]
    tie = top2[:, 0] - top2[:, 1] <= TIE
    want = np.argmax(score, axis=1)
    assert np.all((blk.numpy() == want) | tie)
    _close(tbs.numpy(), bs)
    _close(tot.numpy(), bs.sum(1))
    _close(pb.numpy(), bs[np.arange(len(src)), blk.numpy()] / bs.sum(1))


@pytest.mark.parametrize("kind", L2)
def test_weighted_kv_plain_bf16_matches_reference(kind):
    """The plain weighted-kv pair (HT weights up to 256, columns out of
    range clamped) against the reference's ``rowwise_kv(precision=
    "bf16") * wgt``: per element with the flip allowance, the row sums at
    the kernel tolerance."""
    rng = np.random.default_rng(5)
    x = _points("wkx", 2000)
    q = _points("wkq", 64)
    cols = rng.integers(-2, 2002, (64, 300)).astype(np.int32)
    wgt = (rng.uniform(size=(64, 300)) * 256.0).astype(np.float32)
    kind_, inv_bw, beta = _args(kind)
    xr = x[np.clip(cols, 0, 1999)]
    want = np.asarray(_rowwise(jnp.asarray(q), jnp.asarray(xr), kind_,
                               inv_bw, beta, None, "bf16"),
                      np.float64) * wgt
    args = (torch.as_tensor(q), torch.as_tensor(x), torch.as_tensor(cols),
            torch.as_tensor(wgt), kind_, inv_bw, beta)
    got = thk.weighted_kv_plain(*args, precision="bf16")
    _assert_values(got.numpy(), want, kind, _y64(q, xr, kind, inv_bw))
    np.testing.assert_allclose(
        thk.weighted_kv_sum_plain(*args, precision="bf16").numpy(),
        want.sum(1), rtol=RTOL, atol=ATOL * float(np.abs(want).max()))


def test_pad_rows_give_exactly_zero():
    """A far-offset pad row: 1e30 is bf16-representable, its squared norm
    overflows f32, and the table reads exp(-inf) = 0 -- every L2 kind's bf16
    value against it is exactly 0."""
    q = torch.as_tensor(_points("padq", 8))
    pad = torch.full((3, 16), tref._FAR_OFFSET)
    for kind in L2:
        assert torch.equal(tref.kv_matrix_bf16(q, pad, kind, 0.7, 0.7),
                           torch.zeros(8, 3))


@pytest.mark.parametrize("kind", ["gaussian", "exponential"])
def test_flip_slack_bounds_two_summation_orders(kind):
    """``ref.bf16_flip_slack`` (the card checks' per-pair allowance) bounds
    the difference between two plain versions that sum in different
    orders (a GEMM and a per-row reduction) on clustered data with large
    norms, where flips are frequent, self pairs included; outside it the
    two read the same table entry."""
    from repro_torch.data.synthetic_points import gaussian_clusters
    x, _ = gaussian_clusters(n=2048, d=16, seed=0)
    x = torch.as_tensor(x)
    q = x[:128]
    a = tref.kv_matrix_bf16(q, x, kind, 1.0, 1.0).double()
    b = thref.rowwise_kv(q, x[None].expand(128, -1, -1), kind, 1.0, 1.0,
                         precision="bf16").double()
    slack = tref.bf16_flip_slack(q, x, kind, 1.0)
    diff = (a - b).abs()
    assert int((diff > 0).sum()) > 0            # flips do happen here
    assert bool((diff <= slack).all())
    assert torch.equal(tref.bf16_flip_slack(
        q, x[None].expand(128, -1, -1), kind, 1.0), slack)
    assert not bool(tref.bf16_flip_slack(q, x, "rational_quadratic",
                                         1.0).any())


@pytest.mark.parametrize("bn,chunk", [(None, 7), (70, 1024), (70, 5),
                                      (1, 16), (301, 3)])
def test_flip_slack_blocks_and_chunks(bn, chunk):
    """``bf16_flip_slack`` over query chunks, reduced to column blocks
    with ``bn`` (the last one ragged), equals the pairwise slack of one
    pass summed over each block; gathered rows chunk with the queries."""
    from repro_torch.data.synthetic_points import gaussian_clusters
    x, _ = gaussian_clusters(n=301, d=16, seed=1)
    x = torch.as_tensor(x)
    q = x[:37]
    full = tref.bf16_flip_slack(q, x, "gaussian", 1.0)
    assert int((full > 0).sum()) > 0
    got = tref.bf16_flip_slack(q, x, "gaussian", 1.0, bn, chunk=chunk)
    if bn is None:
        assert torch.equal(got, full)
    else:
        want = torch.stack([full[:, lo:lo + bn].sum(1)
                            for lo in range(0, 301, bn)], dim=1)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0.0)
    rows = x[torch.arange(37 * 45).view(37, 45) % 301]
    assert torch.equal(
        tref.bf16_flip_slack(q, rows, "exponential", 1.0, chunk=chunk),
        tref.bf16_flip_slack(q, rows, "exponential", 1.0))


# --------------------------------------------------------------------- #
# programs and estimators
# --------------------------------------------------------------------- #
def _word(a):
    return np.asarray(a).astype(np.int64).tolist()


@pytest.mark.parametrize("kind", L2)
def test_exact_block_sums_bf16_matches_reference(kind):
    """``exact_block_sums(precision="bf16")`` (the blocksum kernel's plain
    version here) against the reference program's bf16 column-tile scan;
    the counter words equal."""
    x = _points("ebx", 900)
    q = _points("ebq", 40)
    kind_, inv_bw, beta = _args(kind)
    cfg = dict(kind=kind_, inv_bw=inv_bw, beta=beta, block_size=64,
               num_blocks=15, n=900)
    xj = jnp.asarray(x)
    want, rw = jops.exact_block_sums(jnp.asarray(q), xj,
                                     jnp.sum(xj * xj, -1), pairwise=None,
                                     precision="bf16", **cfg)
    tx = torch.as_tensor(x)
    got, w = tops.exact_block_sums(torch.as_tensor(q), tx, (tx * tx).sum(-1),
                                   precision="bf16", **cfg)
    _close(got.numpy(), want)
    assert _word(w) == _word(rw)


@pytest.mark.parametrize("n", [320, 291])
@pytest.mark.parametrize("kind", L2)
def test_stratified_block_sums_bf16_matches_reference(kind, n):
    """The stratified read in bf16 (plain torch on every device, as the
    reference's jnp): the same subsample from the reference's key, the
    bf16 values of the sampled rows; the counter words equal."""
    x = _points("sbsx", n, d=5)
    q = _points("sbsq", 30, d=5)
    kind_, inv_bw, beta = _args(kind)
    nb = -(-n // 16)
    cfg = dict(kind=kind_, inv_bw=inv_bw, beta=beta, block_size=16,
               num_blocks=nb, n=n, s=8)
    key = jax.random.PRNGKey(stats.derive_seed("sbs", kind, n))
    xj = jnp.asarray(x)
    want, rw = jops.stratified_block_sums(jnp.asarray(q), xj,
                                          jnp.sum(xj * xj, -1), key,
                                          pairwise=None, precision="bf16",
                                          **cfg)
    u = torch.as_tensor(np.array(jax.random.uniform(key, (nb, 16))))
    tx = torch.as_tensor(x)
    got, w = tops.stratified_block_sums(torch.as_tensor(q), tx,
                                        (tx * tx).sum(-1), u,
                                        precision="bf16", **cfg)
    _close(got.numpy(), want)
    assert _word(w) == _word(rw)


def _hash_case():
    rng = np.random.default_rng(stats.derive_seed("torch_bf16", "hash"))
    x = rng.normal(-0.5, 1.2, (640, 6)).astype(np.float32)
    jk, tk = _kernels("gaussian", bw=1.0)
    jstate, _ = jhops.build_hash_state(x, jk, num_hash_dims=4,
                                       max_bucket=12, seed=5)
    tstate, w = thops.build_hash_state(x, tk, num_hash_dims=4, max_bucket=12,
                                       seed=5, device="cpu")
    return x, jstate, tstate, w


@pytest.mark.parametrize("kind", L2)
def test_hashed_query_bf16_matches_reference(kind):
    """``hashed_query(precision="bf16")`` against the reference program
    under the same FAR draw: estimates at the kernel tolerance (scaled by
    the HT weight n / num_far = 40), NEAR counts and counter words equal
    (but ``HT_HEAVY``, the static rule of the kernel branch)."""
    x, jstate, tstate, w = _hash_case()
    kind_, inv_bw, beta = _args(kind, bw=1.0)
    n, m, nf = 640, 40, 16
    y = x[::16][:m]
    key = jax.random.PRNGKey(stats.derive_seed("bf16_hq", kind))
    cfg = dict(kind=kind_, inv_bw=inv_bw, beta=beta, cell_width=w,
               num_far=nf, n=n)
    est, cnt, word = jhops.hashed_query(jnp.asarray(x), jnp.asarray(y),
                                        jstate, key, pairwise=None,
                                        precision="bf16", **cfg)
    fidx = torch.as_tensor(np.asarray(
        jax.random.randint(key, (m, nf), 0, n)).astype(np.int64))
    t_est, t_cnt, t_word = thops.hashed_query(
        torch.as_tensor(x), torch.as_tensor(y), tstate, fidx,
        precision="bf16", **cfg)
    np.testing.assert_allclose(t_est.numpy(), np.asarray(est), rtol=RTOL,
                               atol=ATOL * n / nf)
    np.testing.assert_array_equal(t_cnt.numpy(),
                                  np.asarray(cnt).astype(np.int64))
    assert _word(t_word)[1:] == _word(word)[1:]
    o_est, _ = thref.hashed_query_ref(torch.as_tensor(x), torch.as_tensor(y),
                                      tstate, fidx, kind_, inv_bw, beta, w,
                                      nf, n, precision="bf16")
    assert torch.equal(o_est, t_est)


@pytest.mark.parametrize("read", ["exact", "stratified", "hash"])
def test_masked_block_sums_bf16_match_reference(read):
    """The sampler's level-1 program ``masked_block_sums(precision=
    "bf16")`` on each read against the reference program (the exact read:
    bf16 block sums, own-corrected; the stratified read from the
    reference's key; the hashed read under the same offsets): sums at the
    kernel tolerance, counter words equal."""
    if read == "hash":
        x, jstate, tstate, _ = _hash_case()
        bs, nf = 48, 2
    else:
        x, jstate, tstate, bs, nf = _points("mbsx", 300, d=5), None, None, \
            17, 1
    n = x.shape[0]
    nb = -(-n // bs)
    src = np.random.default_rng(6).integers(0, n, 64).astype(np.int32)
    key = jax.random.PRNGKey(stats.derive_seed("bf16_mbs", read))
    cfg = dict(kind="gaussian", inv_bw=1.0, beta=1.0, block_size=bs,
               num_blocks=nb, n=n, s=8, exact=read == "exact",
               level1="hash" if read == "hash" else "blocked", num_far=nf)
    xj = jnp.asarray(x)
    want, rw = jops.masked_block_sums(xj, jnp.sum(xj * xj, -1),
                                      jnp.asarray(src), key, jstate,
                                      pairwise=None, precision="bf16", **cfg)
    if read == "hash":
        noise = torch.as_tensor(np.asarray(jax.random.randint(
            key, (64, nb, nf), 0, bs)).astype(np.int64))
    elif read == "stratified":
        noise = torch.as_tensor(np.array(jax.random.uniform(key, (nb, bs))))
    else:
        noise = None
    tx = torch.as_tensor(x)
    got, w = tops.masked_block_sums(tx, (tx * tx).sum(-1),
                                    torch.as_tensor(src.astype(np.int64)),
                                    noise, tstate, precision="bf16",
                                    pairwise=None, **cfg)
    _close(got.numpy(), want)
    assert _word(w) == _word(rw)


def _estimator_points():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.5, (4096, 16)).astype(np.float32)
    q = rng.normal(0, 0.5, (32, 16)).astype(np.float32)
    return x, q


@pytest.mark.parametrize("name", ["exact", "rs"])
def test_exact_and_rs_estimators_bf16_match_reference(name):
    """``ExactKDE`` / ``RSKDE`` in bf16 (the bf16 rowsum kernel's plain
    version on the CPU) against the reference's CPU path (``_bf16_rowsum``:
    the same function summed in another order; RS draws its rows with the
    same numpy generator); evals equal."""
    x, q = _estimator_points()
    jk, tk = _kernels("gaussian", bw=4.0)
    ref = jmake_estimator(name, x, jk, seed=3, tau=0.05, eps=0.3,
                          precision="bf16")
    port = make_estimator(name, x, tk, seed=3, tau=0.05, eps=0.3,
                          precision="bf16", device="cpu")
    for _ in range(2):
        _close(port.query(torch.as_tensor(q)).numpy(),
               ref.query(jnp.asarray(q)))
    assert port.evals == ref.evals


def test_exact_block_estimator_bf16_matches_reference():
    """``ExactBlockKDE(precision="bf16").block_sums`` against the
    reference's (its program's column-tile scan); evals and device counter
    totals equal."""
    x, q = _estimator_points()
    jk, tk = _kernels("exponential", bw=4.0)
    ref = JExactBlockKDE(x, jk, block_size=200, precision="bf16")
    port = ExactBlockKDE(x, tk, block_size=200, precision="bf16",
                         device="cpu")
    _close(port.block_sums(torch.as_tensor(q)).numpy(),
           ref.block_sums(jnp.asarray(q)))
    assert port.evals == ref.evals
    assert port.device_counters.as_dict() == ref.device_counters.as_dict()


@pytest.mark.parametrize("name", ["exact", "rs", "stratified", "hash",
                                  "exact_block"])
def test_estimator_bf16_within_documented_tolerance(name):
    """The reference's accuracy contract, ported: the same seed gives the
    same sample draws, so bf16 against f32 isolates the kernel-value
    precision; every query within 2 * BF16_REL_ERR."""
    x, q = _estimator_points()
    ker = tmake("gaussian", bandwidth=4.0)
    f32 = make_estimator(name, x, ker, seed=3, tau=0.05, eps=0.3,
                         device="cpu")
    b16 = make_estimator(name, x, ker, seed=3, tau=0.05, eps=0.3,
                         precision="bf16", device="cpu")
    v32 = f32.query(torch.as_tensor(q)).double().numpy()
    v16 = b16.query(torch.as_tensor(q)).double().numpy()
    assert np.max(np.abs(v16 / v32 - 1.0)) < BOUND, name
    assert b16.evals == f32.evals


@pytest.mark.parametrize("name", ["exact", "rs", "stratified", "hash",
                                  "exact_block"])
def test_f32_bitwise_unchanged_by_precision_kwarg(name):
    """``precision="f32"`` is the default path, bit for bit."""
    x, q = _estimator_points()
    ker = tmake("gaussian", bandwidth=2.0)
    a = make_estimator(name, x, ker, seed=1, device="cpu")
    b = make_estimator(name, x, ker, seed=1, precision="f32", device="cpu")
    assert torch.equal(a.query(torch.as_tensor(q)),
                       b.query(torch.as_tensor(q)))


def test_f32_wrappers_bitwise_unchanged_by_precision_kwarg():
    """The plain versions of every kernel give the same bits with and
    without ``precision="f32"``."""
    q, x = torch.as_tensor(_points("f32q", 20)), torch.as_tensor(
        _points("f32x", 300))
    own = torch.arange(20) % 5
    g = torch.as_tensor(np.random.default_rng(0).gumbel(
        size=(20, 5)).astype(np.float32))
    cols = torch.randint(0, 300, (20, 30), dtype=torch.int32)
    wgt = torch.rand(20, 30)
    for kind in ("gaussian", "laplacian"):
        pairs = [(trk.rowsum_plain(q, x, kind, 0.5),
                  trk.rowsum_plain(q, x, kind, 0.5, precision="f32")),
                 (trk.blocksum_plain(q, x, kind, 0.5, 1.0, 64),
                  trk.blocksum_plain(q, x, kind, 0.5, 1.0, 64, "f32")),
                 (tsk.masked_blocksum_plain(q, x, own, kind, 0.5, 1.0, 64),
                  tsk.masked_blocksum_plain(q, x, own, kind, 0.5, 1.0, 64,
                                            "f32")),
                 (thk.weighted_kv_plain(q, x, cols, wgt, kind, 0.5),
                  thk.weighted_kv_plain(q, x, cols, wgt, kind, 0.5,
                                        precision="f32"))]
        pairs += list(zip(
            tsk.sample_block_plain(q, x, own, g, kind, 0.5, 1.0, 64),
            tsk.sample_block_plain(q, x, own, g, kind, 0.5, 1.0, 64, "f32")))
        for a, b in pairs:
            assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# the exact bf16 sampler
# --------------------------------------------------------------------- #
def _sampler_case():
    x = _points("sampler", 300, d=5)
    jk, tk = _kernels("gaussian", bw=1.5)
    return x, jk, tk


def test_exact_bf16_sampler_level1_matches_reference():
    """``NeighborSampler(exact_blocks=True, precision="bf16")``: its
    level-1 sums (through ``prob_of``'s cached read) match the reference
    sampler's, which are ``exact_block_sums(precision="bf16")`` own-
    corrected and floored; ``prob_of`` matches at the kernel tolerance;
    the counter totals and evals equal."""
    x, jk, tk = _sampler_case()
    rng = np.random.default_rng(stats.derive_seed("bf16_sampler"))
    src = rng.integers(0, 300, 80)
    dst = rng.integers(0, 300, 80)
    ref = JNeighborSampler(x, jk, exact_blocks=True, seed=0,
                           precision="bf16")
    port = NeighborSampler(x, tk, exact_blocks=True, seed=0,
                           precision="bf16", device="cpu")
    _close(port.prob_of(src, dst), ref.prob_of(src, dst))
    bs = port.block_size
    nb = -(-300 // bs)
    xj = jnp.asarray(x)
    want, _ = jops.exact_block_sums(xj[src], xj, jnp.sum(xj * xj, -1),
                                    kind="gaussian", inv_bw=1.0 / 1.5,
                                    beta=1.0, pairwise=None, block_size=bs,
                                    num_blocks=nb, n=300, precision="bf16")
    want = np.asarray(want, np.float64)
    want[np.arange(80), src // bs] -= 1.0
    _close(port._l1_cache[1].numpy(),
           np.maximum(want, tref.BLOCK_SUM_FLOOR))
    assert port.evals == ref.evals
    assert port.device_counters.as_dict() == ref.device_counters.as_dict()


def test_exact_bf16_sampler_edge_batches_counters_match_reference():
    """The bf16 exact sampler's edge batches: the same static shapes give
    the same counter totals and evals as the reference's; statuses
    clean."""
    x, jk, tk = _sampler_case()
    k = np.asarray(jax.jit(jk.matrix)(jnp.asarray(x)), np.float64)
    deg = k.sum(1) - 1.0
    cdf = (np.cumsum(deg) / deg.sum()).astype(np.float32)
    ref = JNeighborSampler(x, jk, exact_blocks=True, seed=0,
                           precision="bf16")
    ref.edge_batches(jnp.asarray(cdf), jnp.asarray(deg.astype(np.float32)),
                     float(deg.sum()), 700, batch=256)
    port = NeighborSampler(x, tk, exact_blocks=True, seed=0,
                           precision="bf16", device="cpu")
    out = port.edge_batches(torch.as_tensor(cdf),
                            torch.as_tensor(deg.astype(np.float32)),
                            float(deg.sum()), 700, batch=256)
    assert all(len(a) == 700 for a in out)
    assert port.evals == ref.evals
    assert port.device_counters.as_dict() == ref.device_counters.as_dict()
    assert port.status == ref.status == 0


def test_exact_bf16_sampler_edge_law():
    """The law of the bf16 exact sampler's draws: v | u follows the bf16
    block sums (own-corrected) at level 1 and the exact f32 kernel row
    inside the block.  ``prob_of`` over every destination equals that law
    (computed here from the plain bf16 block sums and the f32 rows), and
    20,000 draws from one source pass a chi-square at alpha 1e-3."""
    x, _, tk = _sampler_case()
    n, u = 300, 17
    nbr = NeighborSampler(x, tk, exact_blocks=True, seed=9,
                          precision="bf16", device="cpu")
    bsz = nbr.block_size
    tx = torch.as_tensor(x)
    bsum = trk.blocksum_plain(tx[u:u + 1], tx, "gaussian", 1.0 / 1.5, 1.0,
                              bsz, "bf16").double().numpy()[0]
    bsum[u // bsz] -= 1.0
    bsum = np.maximum(bsum, tref.BLOCK_SUM_FLOOR)
    row = tref.kv_matrix(tx[u:u + 1], tx, (tx * tx).sum(-1), "gaussian",
                         1.0 / 1.5, 1.0).double().numpy()[0]
    row[u] = 0.0
    blk = np.arange(n) // bsz
    in_blk = row / np.bincount(blk, weights=row)[blk]
    law = bsum[blk] / bsum.sum() * in_blk
    got = nbr.prob_of(np.full(n, u), np.arange(n))
    np.testing.assert_allclose(got, law, rtol=1e-4, atol=1e-9)
    draws, _ = nbr.sample(np.full(20000, u))
    counts = np.bincount(draws, minlength=n)
    stat = stats.chi2_statistic(counts, 20000 * law)
    assert stat < stats.chi2_critical(int((law > 0).sum()) - 1), stat


@pytest.mark.parametrize("estimator", ["exact", "exact_block", "hash"])
def test_row_norm_sampler_bf16_matches_reference(estimator):
    """``RowNormSampler(precision="bf16")`` through ``**est_kw``: the
    squared row norms (n queries against cX in bf16) match the
    reference's; evals equal."""
    x = _points("rns", 512, d=8)
    jk, tk = _kernels("gaussian", bw=2.0)
    ref = JRowNormSampler(x, jk, estimator=estimator, seed=0,
                          precision="bf16")
    port = RowNormSampler(x, tk, estimator=estimator, seed=0,
                          precision="bf16", device="cpu")
    if estimator == "hash":       # FAR draws differ (key vs generator)
        np.testing.assert_allclose(port.row_norms_sq.sum(),
                                   ref.row_norms_sq.sum(), rtol=0.05)
    else:
        _close(port.row_norms_sq, ref.row_norms_sq)
        assert port.evals == ref.evals


# --------------------------------------------------------------------- #
# the wrappers' contract with the CUDA sources (no card needed)
# --------------------------------------------------------------------- #
_CTYPE = {"const float*": "P", "float*": "P", "const void*": "P",
          "void*": "P", "const int*": "P", "int*": "P", "long long*": "P",
          "int": "I", "float": "F", "long long": "L"}


def _c_params(name):
    """The parameter kinds of the ``extern "C"`` function ``name`` in
    src/repro_torch/csrc: P pointer, I int, F float, L long long, S a
    pointer to a launch struct (a shape, or a plan the function fills)."""
    for src in (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu"):
        m = re.search(rf"\bint {name}\(([^)]*)\)", src.read_text())
        if m:
            out = []
            for p in m.group(1).split(","):
                decl = " ".join(p.split()[:-1]).replace(" *", "*")
                if re.fullmatch(r"(const )?Kde\w+(Shape|Plan)\*", decl):
                    out.append("S")
                else:
                    out.append(_CTYPE[decl])
            return out
    raise AssertionError(f"{name} not found")


def _py_params(argtypes):
    import ctypes
    kinds = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F",
             ctypes.c_longlong: "L"}
    return [kinds.get(a, "S") for a in argtypes]


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_c_signatures_match_the_sources(name):
    """Every launcher's ctypes ``argtypes`` list has the C signature's
    arity and kinds, in order (an argtypes list out of step passes its
    arguments into the wrong slots without an error).  The KDE launchers
    take the exp table just before the stream."""
    assert _py_params(build.SIGNATURES[name]) == _c_params(name)
    if name.startswith(("kde_rowsum", "kde_blocksum", "kde_masked",
                        "kde_sample", "kde_weighted")):
        src = next(p for p in (ROOT / "src/repro_torch/csrc").glob("*.cu")
                   if f"int {name}(" in p.read_text()).read_text()
        decl = re.search(rf"\bint {name}\(([^)]*)\)", src).group(1)
        assert re.search(r"const float\* table,\s*void\* stream", decl)


def test_kind_args_and_table_operand():
    """bf16 takes the bf16 kind ids of kde_tile.cuh (4, 5, 6), the table
    only for the gaussian and exponential kinds, and refuses the
    laplacian; the tile header declares the same ids."""
    tile = (ROOT / "src/repro_torch/csrc/kde_tile.cuh").read_text()
    for kind, kid in trk.KIND_IDS_BF16.items():
        assert trk.kind_args(kind, 2.0, 0.7, "bf16") == (kid, 2.0, 4.0, 0.7)
        name = {"gaussian": "GAUSSIAN", "exponential": "EXPONENTIAL",
                "rational_quadratic": "RATIONAL_QUADRATIC"}[kind]
        assert re.search(rf"\b{name}_BF16 = {kid}\b", tile)
        assert trk.kind_args(kind, 2.0, 0.7)[0] == trk.KIND_IDS[kind]
    with pytest.raises(ValueError, match="L2 kernels only"):
        trk.kind_args("laplacian", 1.0, 1.0, "bf16")
    with pytest.raises(ValueError, match="unknown precision"):
        trk.kind_args("gaussian", 1.0, 1.0, "fp16")
    assert [trk.needs_exp_table(k, p) for k in L2 for p in ("f32", "bf16")] \
        == [False, True, False, True, False, False]
    assert trk.exp_table_ptr("rational_quadratic", "bf16", "cpu") is None
    assert trk.exp_table_ptr("gaussian", "f32", "cpu") is None
    assert trk.exp_table_ptr("gaussian", "bf16", "cpu") \
        == tref.exp_table_on("cpu").data_ptr()


def test_bf16_cuda_wrappers_refuse_cpu_tensors():
    """The bf16 CUDA wrappers launch or raise: a CPU tensor is refused
    before anything is built, and no launch is counted."""
    q = torch.zeros((3, 4))
    own = torch.zeros(3, dtype=torch.int32)
    cols = torch.zeros((3, 5), dtype=torch.int32)
    calls = [lambda: trk.rowsum_cuda(q, q, "gaussian", 1.0,
                                     precision="bf16"),
             lambda: trk.blocksum_cuda(q, q, "gaussian", 1.0, 1.0, 2, "bf16"),
             lambda: tsk.masked_blocksum_cuda(q, q, own, "gaussian", 1.0,
                                              1.0, 2, "bf16"),
             lambda: tsk.sample_block_cuda(q, q, own, torch.zeros((3, 2)),
                                           "gaussian", 1.0, 1.0, 2, "bf16"),
             lambda: thk.weighted_kv_cuda(q, q, cols, torch.zeros((3, 5)),
                                          "gaussian", 1.0,
                                          precision="bf16"),
             lambda: thk.weighted_kv_sum_cuda(q, q, cols, torch.zeros((3, 5)),
                                              "gaussian", 1.0,
                                              precision="bf16")]
    before = {**trk.LAUNCHES, **tsk.LAUNCHES, **thk.LAUNCHES}
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert {**trk.LAUNCHES, **tsk.LAUNCHES, **thk.LAUNCHES} == before
    assert all(f"{k}_bf16" in before for k in (
        "rowsum", "blocksum", "masked_blocksum", "sample_block",
        "weighted_kv", "weighted_kv_sum"))
