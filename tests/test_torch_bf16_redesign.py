"""The bf16 sampler and weighted-kv redesign, on the CPU: the plans that
pick the tensor-core sample-block instance and the bf16-row weighted-kv
instances, the bf16-resident dataset copy of the hashed estimator (made
once, carried in the hash state down to every hashed read), and the plain
versions, which take an f32 or a bf16 dataset and give the same values.

The hashed pipeline with the copy is held to the JAX reference's jnp
programs and oracles (``rowwise_kv`` on rounded rows) at the reference's
tolerances: rtol 2e-4, atol 1e-5 scaled by the HT weight.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.core.kernels_fn import make_kernel as jmake
from repro.kernels.kde_hash import ops as jhops
from repro.kernels.kde_hash import ref as jhref
from repro.kernels.kde_sampler import ops as jops
from repro_torch.core.kde.hashed import HashedKDE
from repro_torch.core.kernels_fn import make_kernel as tmake
from repro_torch.core.sampling.edge import NeighborSampler
from repro_torch.core.sampling.walks import random_walks
from repro_torch.kernels.kde_hash import kernel as thk
from repro_torch.kernels.kde_hash import ops as thops
from repro_torch.kernels.kde_rowsum import kernel as trk
from repro_torch.kernels.kde_sampler import kernel as tsk
from repro_torch.kernels.kde_sampler import ops as tops
from repro_torch.kernels.kde_sampler.ref import round_bf16

RTOL, ATOL = 2e-4, 1e-5
L2 = ["gaussian", "exponential", "rational_quadratic"]
KINDS = L2 + ["laplacian"]
WIDTHS = [8, 16, 19, 32, 784]

_rowwise = jax.jit(jhref.rowwise_kv, static_argnums=(2, 3, 4, 5, 6))


def _points(label, n, d=16, scale=0.5):
    rng = np.random.default_rng(stats.derive_seed("torch_bf16_redesign",
                                                  label))
    return rng.normal(0, scale, (n, d)).astype(np.float32)


def _word(a):
    return np.asarray(a).astype(np.int64).tolist()


def _args(kind, bw=1.5):
    return kind, 1.0 / bw, 0.7 if kind == "rational_quadratic" else 1.0


# --------------------------------------------------------------------- #
# plans
# --------------------------------------------------------------------- #
def _sample_block_instance(d, precision, aligned):
    wide = aligned and d % 4 == 0 and d <= 32
    if not wide:
        return 0
    pad = 16 if d <= 16 else 32
    return pad + (tsk.MMA if precision == "bf16" else 0)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_sample_block_plan_picks_the_tensor_core_tile(kind, precision, d,
                                                      aligned):
    """``sample_block_plan`` takes the tensor-core tile (MMA + the padded
    d: d = 8 pads to one k-step, d = 32 takes two) for the bf16 kinds
    wherever the wide tile's conditions hold, the wide tile at f32, the
    generic tile at d = 19 / 784 and off 16 bytes at either precision; the
    laplacian has no bf16 instance (``kind_args`` refuses it before any
    plan).  At f32 the rowsum and blocksum plans never take it (their bf16
    plans do: ``tests/test_torch_rowsum_mma.py``)."""
    if kind == "laplacian" and precision == "bf16":
        with pytest.raises(ValueError, match="L2 kernels only"):
            trk.kind_args(kind, 1.0, 1.0, precision)
        return
    assert trk.kind_args(kind, 1.0, 1.0, precision)[0] == (
        trk.KIND_IDS_BF16 if precision == "bf16" else trk.KIND_IDS)[kind]
    plan = tsk.sample_block_plan(300, 5000, d, 70, aligned,
                                 precision=precision)
    want = _sample_block_instance(d, precision, aligned)
    assert plan.instance == want
    assert plan.bm == (tsk.WIDE_BM if want else tsk.GENERIC_BM)
    assert plan.nb == -(-5000 // 70)
    # the same shape at f32 is the wide / generic plan, block groups equal
    assert plan._replace(instance=_sample_block_instance(d, "f32", aligned)) \
        == tsk.sample_block_plan(300, 5000, d, 70, aligned)
    assert trk.blocksum_plan(300, 5000, d, 70, aligned,
                             precision="f32").instance < tsk.MMA
    assert trk.rowsum_plan(300, 5000, d, aligned,
                           precision="f32")[0].instance < tsk.MMA


def _weighted_instance(d, dtype, aligned):
    rows = thk.BF16_ROWS if dtype == torch.bfloat16 else 0
    if not (aligned and d % 4 == 0 and d <= 32):
        return rows
    return rows + (4 if d <= 16 else 8)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_weighted_kv_plan_picks_by_the_dtype_of_x(precision, dtype, d,
                                                  aligned):
    """``weighted_kv_plan`` picks the instance by x's dtype: the vector
    instance (4 lanes a row at d <= 16, 8 at d <= 32) or the scalar one on
    f32 rows, the same + ``BF16_ROWS`` on a bf16 x; a bf16 x at
    ``precision="f32"`` raises (its rows are already rounded)."""
    if dtype == torch.bfloat16 and precision == "f32":
        with pytest.raises(ValueError, match="needs precision='bf16'"):
            thk.weighted_kv_plan(64, 4096, d, 100, aligned, dtype, precision)
        return
    plan = thk.weighted_kv_plan(64, 4096, d, 100, aligned, dtype, precision)
    assert plan.instance == _weighted_instance(d, dtype, aligned)
    assert plan.lanes == (plan.instance % thk.BF16_ROWS or 1)


def test_weighted_kv_refuses_other_x_dtypes():
    """Only f32 and bf16 datasets: an f16 x is refused by the plan and by
    the plain versions, a bf16 x at f32 by the plain versions too."""
    q = torch.zeros((3, 4))
    cols = torch.zeros((3, 5), dtype=torch.int32)
    wgt = torch.zeros((3, 5))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        thk.weighted_kv_plan(3, 4, 4, 5, True, torch.float16, "bf16")
    for fn in (thk.weighted_kv_plain, thk.weighted_kv_sum_plain):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fn(q, q.half(), cols, wgt, "gaussian", 1.0, precision="bf16")
        with pytest.raises(ValueError, match="needs precision='bf16'"):
            fn(q, q.bfloat16(), cols, wgt, "gaussian", 1.0)


# --------------------------------------------------------------------- #
# the bf16-resident copy
# --------------------------------------------------------------------- #
def _recording(monkeypatch):
    """Record the dataset every weighted pass gathers from."""
    seen = []
    real = thops._weighted_pass

    def spy(q, x, *a, **kw):
        seen.append(x)
        return real(q, x, *a, **kw)

    monkeypatch.setattr(thops, "_weighted_pass", spy)
    return seen


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_hashed_estimator_makes_the_copy_once(monkeypatch, precision):
    """``HashedKDE(precision="bf16")`` keeps ``round_bf16(x)`` as bf16 in
    its state, made at construction: every query gathers that one tensor
    (the same ``data_ptr`` across calls), and the degrees' batches too.
    At f32 there is no copy and the passes gather x."""
    x = _points("copy", 700, d=8)
    est = HashedKDE(x, tmake("gaussian", bandwidth=1.0), max_bucket=32,
                    num_far_samples=16, precision=precision, device="cpu")
    copy = est.state.x_bf16
    seen = _recording(monkeypatch)
    est.query(torch.as_tensor(x[:50]))
    est.query(torch.as_tensor(x[50:90]))
    est.degrees(batch=300)
    assert len(seen) == 5
    if precision == "f32":
        assert copy is None
        assert all(s is est.x for s in seen)
        return
    assert copy.dtype == torch.bfloat16 and copy.shape == est.x.shape
    assert torch.equal(copy.float(), round_bf16(est.x))
    assert est.state.x_bf16 is copy
    assert all(s.data_ptr() == copy.data_ptr() for s in seen)


def test_hashed_sampler_and_walks_gather_the_estimator_copy(monkeypatch):
    """A ``level1="hash"`` bf16 sampler shares its estimator's state, so
    its level-1 reads (sample, prob_of, edge batches) and its walks gather
    the one copy the estimator made."""
    x = _points("sampler", 600, d=8)
    nbr = NeighborSampler(x, tmake("gaussian", bandwidth=1.0),
                          level1="hash", precision="bf16", device="cpu",
                          hash_opts=dict(max_bucket=32))
    copy = nbr.hash_estimator.state.x_bf16
    assert copy is not None and nbr._hstate.x_bf16 is copy
    seen = _recording(monkeypatch)
    src = np.arange(0, 600, 7)
    v, _ = nbr.sample(src)
    nbr.prob_of(src + 1, v)
    random_walks(nbr, np.zeros(16, np.int64), length=3)
    assert len(seen) == 5
    assert all(s.data_ptr() == copy.data_ptr() for s in seen)


@pytest.mark.parametrize("kind", L2)
def test_plain_versions_take_either_dtype(kind):
    """The plain weighted passes give bitwise the same values for an f32
    dataset and its bf16 copy (the copy is the rounding the bf16 policy
    applies to the gathered rows), columns out of range included."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(_points("either_x", 900, d=19))
    q = torch.as_tensor(_points("either_q", 40, d=19))
    cols = torch.as_tensor(rng.integers(-2, 903, (40, 77)).astype(np.int32))
    wgt = torch.as_tensor((rng.uniform(size=(40, 77)) * 64).astype(
        np.float32))
    a = (cols, wgt, *_args(kind))
    x16 = round_bf16(x).to(torch.bfloat16)
    for fn in (thk.weighted_kv_plain, thk.weighted_kv_sum_plain):
        assert torch.equal(fn(q, x, *a, precision="bf16"),
                           fn(q, x16, *a, precision="bf16"))


# --------------------------------------------------------------------- #
# the hashed pipeline with the copy, against the reference
# --------------------------------------------------------------------- #
def _hash_case(kind):
    x = _points("hash", 640, d=8, scale=1.0)
    kw = dict(bandwidth=1.0)
    if kind == "rational_quadratic":
        kw["beta"] = 0.7
    jk, tk = jmake(kind, **kw), tmake(kind, **kw)
    jstate, w = jhops.build_hash_state(jnp.asarray(x), jk, num_hash_dims=4,
                                       max_bucket=12, seed=5)
    est = HashedKDE(x, tk, num_hash_dims=4, max_bucket=12, seed=5,
                    precision="bf16", device="cpu")
    assert est.cell_width == w and est.state.x_bf16 is not None
    return x, jstate, est


@pytest.mark.parametrize("kind", L2)
def test_hashed_query_with_the_copy_matches_reference(kind):
    """``hashed_query`` on the bf16 estimator's state (the weighted pass
    gathers the copy) against the reference's program under the same FAR
    draw and against ``rowwise_kv`` on the rounded gathered rows: at the
    kernel tolerance scaled by the HT weight n / num_far = 40; bitwise the
    same program on the f32 rows."""
    x, jstate, est = _hash_case(kind)
    kind_, inv_bw, beta = _args(kind, bw=1.0)
    n, m, nf = 640, 40, 16
    y = x[::16][:m]
    key = jax.random.PRNGKey(stats.derive_seed("redesign_hq", kind))
    cfg = dict(kind=kind_, inv_bw=inv_bw, beta=beta, cell_width=est.cell_width,
               num_far=nf, n=n)
    want, _, _ = jhops.hashed_query(jnp.asarray(x), jnp.asarray(y), jstate,
                                    key, pairwise=None, precision="bf16",
                                    **cfg)
    fidx = torch.as_tensor(np.asarray(
        jax.random.randint(key, (m, nf), 0, n)).astype(np.int64))
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    got, _, _ = thops.hashed_query(tx, ty, est.state, fidx,
                                   precision="bf16", **cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * n / nf)
    f32_rows, _, _ = thops.hashed_query(
        tx, ty, est.state._replace(x_bf16=None), fidx, precision="bf16",
        **cfg)
    assert torch.equal(got, f32_rows)
    # the reference's oracle on the gathered rows of the same columns
    cols, wgt, _, _ = thops._ref.query_gather(ty, est.state, fidx,
                                              est.cell_width, nf, n)
    xr = x[np.clip(cols.numpy(), 0, n - 1)]
    oracle = (np.asarray(_rowwise(jnp.asarray(y), jnp.asarray(xr), kind_,
                                  inv_bw, beta, None, "bf16"), np.float64)
              * wgt.numpy()).sum(1)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL,
                               atol=ATOL * n / nf)


@pytest.mark.parametrize("kind", L2)
def test_hashed_level1_read_with_the_copy_matches_reference(kind):
    """The sampler's hashed level-1 program ``masked_block_sums(level1=
    "hash", precision="bf16")`` on the state with the copy, against the
    reference's program under the same offsets: sums at the kernel
    tolerance, counter words equal (the copy changes no count)."""
    x, jstate, est = _hash_case(kind)
    kind_, inv_bw, beta = _args(kind, bw=1.0)
    n, bs, nf = x.shape[0], 48, 2
    nb = -(-n // bs)
    src = np.random.default_rng(6).integers(0, n, 64).astype(np.int32)
    key = jax.random.PRNGKey(stats.derive_seed("redesign_mbs", kind))
    cfg = dict(kind=kind_, inv_bw=inv_bw, beta=beta, block_size=bs,
               num_blocks=nb, n=n, s=8, exact=False, level1="hash",
               num_far=nf)
    xj = jnp.asarray(x)
    want, rw = jops.masked_block_sums(xj, jnp.sum(xj * xj, -1),
                                      jnp.asarray(src), key, jstate,
                                      pairwise=None, precision="bf16", **cfg)
    off = torch.as_tensor(np.asarray(jax.random.randint(
        key, (64, nb, nf), 0, bs)).astype(np.int64))
    tx = torch.as_tensor(x)
    got, w = tops.masked_block_sums(tx, (tx * tx).sum(-1),
                                    torch.as_tensor(src.astype(np.int64)),
                                    off, est.state, precision="bf16",
                                    pairwise=None, **cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert _word(w) == _word(rw)
    f32_rows, _ = tops.masked_block_sums(
        tx, (tx * tx).sum(-1), torch.as_tensor(src.astype(np.int64)), off,
        est.state._replace(x_bf16=None), precision="bf16",
        pairwise=None, **cfg)
    assert torch.equal(got, f32_rows)


@pytest.mark.parametrize("other", ["width", "rows"])
@pytest.mark.parametrize("entry", ["hashed_query", "hashed_block_sums"])
def test_hashed_reads_refuse_a_copy_of_another_dataset(entry, other):
    """A bf16 state whose copy is not of the x passed (another width at
    the same n, or another n) raises ValueError instead of gathering rows
    the caller did not pass; at f32 the copy is not read."""
    x, _, est = _hash_case("gaussian")
    n, d = x.shape
    shape = (n, d + 4) if other == "width" else (n + 16, d)
    tx = torch.as_tensor(_points("other_dataset", shape[0], d=shape[1]))
    kind_, inv_bw, beta = _args("gaussian", bw=1.0)
    cfg = dict(kind=kind_, inv_bw=inv_bw, beta=beta, n=n)
    if entry == "hashed_query":
        fidx = torch.zeros((4, 8), dtype=torch.int64)

        def call(precision):
            return thops.hashed_query(tx, tx[:4], est.state, fidx,
                                      cell_width=est.cell_width, num_far=8,
                                      precision=precision, **cfg)
    else:
        bs = 48
        nb = -(-n // bs)
        src = torch.arange(0, 64, 8)
        off = torch.zeros((8, nb, 2), dtype=torch.int64)

        def call(precision):
            return thops.hashed_block_sums(tx, src, est.state, off,
                                           num_far=2, block_size=bs,
                                           num_blocks=nb,
                                           precision=precision, **cfg)
    with pytest.raises(ValueError, match="another dataset"):
        call("bf16")
    call("f32")
