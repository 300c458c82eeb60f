"""The port's hashed-KDE engine (``repro_torch.kernels.kde_hash``,
``core.kde.hashed``) against the JAX reference on the same numpy inputs.

The reference runs its jnp path (``use_pallas=False``).  Its FAR noise is
drawn with ``jax.random`` under the reference's own key discipline and
handed to the port's explicit-noise gathers, so the bucket layout, the
evaluation columns, the weights, the NEAR counts and the truncation flags
must match exactly; kernel values and sums at rtol 2e-4 (the reference's
own kernel tolerance; f32 sums taken in another order).  On the CPU the
weighted pass is the kernels' plain version; the CUDA kernels are held to
it on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.core.kde.base import StratifiedKDE as JStratifiedKDE
from repro.core.kde.hashed import HashedKDE as JHashedKDE
from repro.core.kernels_fn import make_kernel as jmake
from repro.core.sampling.vertex import approximate_degrees as japprox
from repro.kernels.kde_hash import ops as jhops
from repro.kernels.kde_hash import ref as jhref
from repro.kernels.kde_sampler import ops as jops
from repro_torch.convert import hash_state_from_reference
from repro_torch.core.kde.base import StratifiedKDE, make_estimator
from repro_torch.core.kde.hashed import HashedKDE
from repro_torch.core.kernels_fn import make_kernel as tmake
from repro_torch.core.sampling.vertex import approximate_degrees
from repro_torch.ft import guards as tg
from repro_torch.kernels.kde_hash import kernel as thk
from repro_torch.kernels.kde_hash import ops as thops
from repro_torch.kernels.kde_hash import ref as thref
from repro_torch.kernels.kde_sampler import ops as tops

RTOL, ATOL = 2e-4, 1e-5
KINDS = ["gaussian", "exponential", "laplacian", "rational_quadratic"]
_rowwise_kv = jax.jit(jhref.rowwise_kv, static_argnums=(2, 3, 4))
_query_gather = jax.jit(jhref.query_gather, static_argnums=(4, 5, 6))
_frontier_gather = jax.jit(jhref.frontier_gather,
                           static_argnums=(4, 5, 6, 7))


def _kernels(kind, bw=1.5, beta=0.7):
    kw = dict(bandwidth=bw)
    if kind == "rational_quadratic":
        kw["beta"] = beta
    return jmake(kind, **kw), tmake(kind, **kw)


def _data(label, n=600, d=6, scale=1.5, shift=-0.5):
    """Points with negative coordinates (so negative grid codes)."""
    rng = np.random.default_rng(stats.derive_seed("torch_kde_hash", label))
    return (rng.normal(shift, scale, (n, d))).astype(np.float32)


def _states(x, jk, tk, **kw):
    jstate, jw = jhops.build_hash_state(x, jk, **kw)
    tstate, tw = thops.build_hash_state(x, tk, device="cpu", **kw)
    assert jw == tw
    return jstate, tstate, tw


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_hash_state_bitwise(seed):
    """Every array of the port's ``HashState`` equals the reference's
    exactly: 3 seeds, negative coordinates, and a ``max_bucket`` small
    enough that buckets are truncated (their seeded subsample included)."""
    x = _data(("build", seed), n=700, d=5, scale=1.0)
    jk, tk = _kernels("gaussian", bw=1.0)
    jstate, tstate, _ = _states(x, jk, tk, num_hash_dims=3, max_bucket=8,
                                seed=seed)
    assert bool(np.asarray(jstate.truncated).any())
    assert (x < 0).any()
    for name in ("dims", "keys", "members", "counts", "point_bucket",
                 "truncated"):
        np.testing.assert_array_equal(
            getattr(tstate, name).numpy(),
            np.asarray(getattr(jstate, name)).astype(
                getattr(tstate, name).numpy().dtype), err_msg=name)
    for name in ("shift", "self_stored"):
        assert getattr(tstate, name).numpy().tobytes() == \
            np.asarray(getattr(jstate, name)).tobytes(), name
    conv = hash_state_from_reference(jstate, device="cpu")
    for a, b in zip(conv, tstate):
        if a is not None or b is not None:
            _eq(a, b.numpy())


def test_pack_codes_wraps_like_uint32():
    """``pack_codes`` on int64 keys equals numpy's uint32 wraparound
    multiply-add, at the int32 extremes too (the product of two 32-bit
    values would pass 2^63; the 16-bit split keeps it below 2^48)."""
    rng = np.random.default_rng(stats.derive_seed("torch_kde_hash", "pack"))
    codes = rng.integers(-2 ** 31, 2 ** 31, (500, 8), dtype=np.int64)
    codes[:4] = [[-2 ** 31] * 8, [2 ** 31 - 1] * 8, [-1] * 8, [0] * 8]
    codes = codes.astype(np.int32)
    want = np.zeros(len(codes), np.uint32)
    for j in range(codes.shape[1]):
        want = want * np.uint32(thref.HASH_MULT) + codes[:, j].astype(
            np.uint32)
    got = thref.pack_codes(torch.as_tensor(codes)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    _eq(thref.pack_codes(torch.as_tensor(codes)),
        np.asarray(jhref.pack_codes(jnp.asarray(codes))).astype(np.int64))


def test_device_hashing_reproduces_point_bucket():
    """Hashing the dataset rows on the device (``query_codes`` ->
    ``pack_codes`` -> ``searchsorted``) finds every row's own bucket, as
    the host build recorded it in ``point_bucket``."""
    x = _data("lookup", n=900, d=7)
    jk, tk = _kernels("gaussian", bw=0.8)
    _, tstate, w = _states(x, jk, tk, max_bucket=16, seed=3)
    codes = thref.query_codes(torch.as_tensor(x), tstate.dims, tstate.shift,
                              w)
    assert bool((codes < 0).any())
    b, hit = thref.lookup_buckets(torch.as_tensor(x), tstate, w)
    assert bool(hit.all())
    _eq(b, tstate.point_bucket.numpy())


@pytest.mark.parametrize("kind,d", [(k, 19) for k in KINDS]
                         + [("laplacian", 784)])
def test_weighted_kv_plain_matches_reference(kind, d):
    """``weighted_kv_plain`` / ``weighted_kv_sum_plain`` against the
    reference's ``rowwise_kv(q, x[cols]) * wgt`` on ragged m=37, t=45,
    columns past the end included (clamped to n - 1, as a JAX gather
    clamps them)."""
    rng = np.random.default_rng(stats.derive_seed("torch_kde_hash", kind, d))
    m, t, n = 37, 45, 301
    q = rng.normal(0, 0.4, (m, d)).astype(np.float32)
    x = rng.normal(0, 0.4, (n, d)).astype(np.float32)
    cols = rng.integers(0, n + 2, (m, t)).astype(np.int64)
    wgt = rng.uniform(0, 256, (m, t)).astype(np.float32)
    jk, _ = _kernels(kind, bw=0.3 * d ** 0.5)
    inv_bw = 1.0 / jk.bandwidth
    want = np.asarray(_rowwise_kv(jnp.asarray(q),
                                  jnp.asarray(x)[jnp.asarray(cols)], kind,
                                  inv_bw, 0.7)) * wgt
    args = (torch.as_tensor(q), torch.as_tensor(x), torch.as_tensor(cols),
            torch.as_tensor(wgt), kind, inv_bw, 0.7)
    np.testing.assert_allclose(thk.weighted_kv_plain(*args).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(thk.weighted_kv_sum_plain(*args).numpy(),
                               want.sum(1), rtol=RTOL, atol=ATOL)
    assert thk.LAUNCHES == {"weighted_kv_sum": 0, "weighted_kv": 0,
                            "weighted_kv_sum_bf16": 0, "weighted_kv_bf16": 0}


# (m, n, d, t, aligned) -> instance: the frontier read and degree query of
# the main path, chip_smoke.py's ragged checks (d = 19, 784), the CUDA
# tests' vector shapes (d = 8, 32), and x off 16 bytes (scalar)
WEIGHTED_PLAN_CASES = [
    ((1024, 262144, 16, 1152, True), 4), ((1024, 262144, 16, 192, True), 4),
    ((37, 301, 19, 45, True), 0), ((20, 203, 784, 33, True), 0),
    ((37, 301, 8, 45, True), 4), ((50, 2000, 32, 300, True), 8),
    ((64, 5000, 16, 300, False), 0), ((3, 10, 36, 5, True), 0),
]


@pytest.mark.parametrize("args,want", WEIGHTED_PLAN_CASES)
def test_weighted_kv_plan_picks_the_instance(args, want):
    """The host-side plan of the weighted kernels: the vector instance
    (float4 per row padded to 4 or 8, q in registers) where d % 4 == 0,
    d <= 32 and x starts on 16 bytes, the scalar one elsewhere."""
    plan = thk.weighted_kv_plan(*args)
    assert plan.instance == want
    # a gathered row is one 16-byte piece a lane on the vector instance
    assert plan.lanes == (plan.instance or 1)


def test_weighted_kv_plan_refuses_what_the_kernel_does_not_take():
    for args, match in (((4, 0, 4, 4), "empty"), ((4, 8, 0, 4), ">= 1"),
                        ((4, 8, 4, 2 ** 31), "int32")):
        with pytest.raises(ValueError, match=match):
            thk.weighted_kv_plan(*args)


def test_weighted_kv_cuda_wrappers_reject_cpu_tensors():
    """The kde_hash CUDA wrappers launch or raise: CPU tensors are refused
    before anything is built."""
    q = torch.zeros((3, 4))
    cols = torch.zeros((3, 5), dtype=torch.int32)
    for fn in (thk.weighted_kv_cuda, thk.weighted_kv_sum_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, cols, torch.zeros((3, 5)), "gaussian", 1.0)
    assert thk.LAUNCHES == {"weighted_kv_sum": 0, "weighted_kv": 0,
                            "weighted_kv_sum_bf16": 0, "weighted_kv_bf16": 0}


def _gather_case(label, num_far=16):
    x = _data(label, n=640, d=6, scale=1.2)
    jk, tk = _kernels("gaussian", bw=1.0)
    jstate, tstate, w = _states(x, jk, tk, num_hash_dims=4, max_bucket=12,
                                seed=5)
    assert bool(np.asarray(jstate.truncated).any())
    return x, jk, tk, jstate, tstate, w


def test_query_gather_matches_reference_exactly():
    """Fed the reference's FAR draw (``randint(k, (m, num_far), 0, n)``
    with ``k`` the split ``HashedKDE`` hands its query), the port's
    columns, weights, NEAR counts and truncation flags equal the
    reference's exactly."""
    x, _, _, jstate, tstate, w = _gather_case("qgather")
    n, m, nf = x.shape[0], 50, 16
    rng = np.random.default_rng(stats.derive_seed("torch_kde_hash", "qy"))
    y = np.concatenate([x[:30], rng.normal(0, 1.2, (m - 30, 6))]
                       ).astype(np.float32)
    _, k = jax.random.split(jax.random.PRNGKey(7))
    cols, _, wgt, cnt, trunc = _query_gather(jnp.asarray(x), jnp.asarray(y),
                                             jstate, k, w, nf, n)
    fidx = torch.as_tensor(np.asarray(
        jax.random.randint(k, (m, nf), 0, n)).astype(np.int64))
    got = thref.query_gather(torch.as_tensor(y), tstate, fidx, w, nf, n)
    for a, b in zip(got, (cols, wgt, cnt, trunc)):
        _eq(a, np.asarray(b).astype(a.numpy().dtype))
    assert bool(got[3].any()) and float(got[1][:, -nf:].min()) == 0.0


def test_frontier_gather_matches_reference_exactly():
    """The edge-batch key discipline (``k_u, k_fwd = split(key)``, then
    ``k_l1, k_rest = split(k_fwd)``; the offsets are ``randint(k_l1, (w,
    B, num_far), 0, block_size)``): columns, weights, NEAR counts and
    truncation flags equal the reference's exactly, ragged tail block
    included."""
    x, _, _, jstate, tstate, _ = _gather_case("fgather")
    n, bs, nf = x.shape[0], 48, 2
    nb = -(-n // bs)
    src = np.random.default_rng(1).integers(0, n, 70).astype(np.int32)
    _, k_fwd = jax.random.split(jax.random.PRNGKey(9))
    k_l1, _ = jax.random.split(k_fwd)
    cols, _, wgt, cnt, trunc = _frontier_gather(
        jnp.asarray(x), jnp.asarray(src), jstate, k_l1, nf, bs, nb, n)
    off = torch.as_tensor(np.asarray(jax.random.randint(
        k_l1, (len(src), nb, nf), 0, bs)).astype(np.int64))
    got = thref.frontier_gather(torch.as_tensor(src.astype(np.int64)),
                                tstate, off, nf, bs, nb, n)
    for a, b in zip(got, (cols, wgt, cnt, trunc)):
        _eq(a, np.asarray(b).astype(a.numpy().dtype))


def _words_equal_but_ht(port_word, ref_word):
    p = port_word.numpy().astype(np.int64)
    r = np.asarray(ref_word).astype(np.int64)
    np.testing.assert_array_equal(p[1:], r[1:])
    assert p[0] & ~tg.HT_HEAVY == r[0] & ~tg.HT_HEAVY


@pytest.mark.parametrize("kind", KINDS)
def test_hashed_query_matches_reference(kind):
    """``hashed_query`` against the reference program under the same FAR
    draw: estimates at rtol 2e-4, NEAR counts exactly, counter words equal
    in every slot but ``HT_HEAVY`` (see the static-rule test); the port's
    own oracle ``hashed_query_ref`` agrees bit for bit."""
    x, _, _, jstate, tstate, w = _gather_case("hq")
    jk, tk = _kernels(kind, bw=1.0)
    n, m, nf = x.shape[0], 40, 16
    y = x[::16][:m]
    key = jax.random.PRNGKey(stats.derive_seed("torch_kde_hash", "hq", kind))
    cfg = dict(kind=kind, inv_bw=1.0 / jk.bandwidth, beta=0.7,
               cell_width=w, num_far=nf, n=n)
    est, cnt, word = jhops.hashed_query(jnp.asarray(x), jnp.asarray(y),
                                        jstate, key, pairwise=None, **cfg)
    fidx = torch.as_tensor(np.asarray(
        jax.random.randint(key, (m, nf), 0, n)).astype(np.int64))
    t_est, t_cnt, t_word = thops.hashed_query(
        torch.as_tensor(x), torch.as_tensor(y), tstate, fidx, **cfg)
    np.testing.assert_allclose(t_est.numpy(), np.asarray(est), rtol=RTOL,
                               atol=ATOL)
    _eq(t_cnt, np.asarray(cnt).astype(np.int64))
    _words_equal_but_ht(t_word, word)
    assert t_word[0] & tg.BUCKET_OVERFLOW
    o_est, o_cnt = thref.hashed_query_ref(
        torch.as_tensor(x), torch.as_tensor(y), tstate, fidx, kind,
        cfg["inv_bw"], 0.7, w, nf, n)
    _eq(o_est, t_est.numpy())
    _eq(o_cnt, t_cnt.numpy())


@pytest.mark.parametrize("kind", ["gaussian", "laplacian"])
def test_hashed_block_sums_matches_reference(kind):
    """``hashed_block_sums`` against the reference program under the same
    offsets: (w, B) sums at rtol 2e-4 (atol 1e-5 on the floored sums), the
    counter word equal in every slot; the port's oracle
    ``hashed_block_sums_ref`` and the sampler's level-1 program
    (``masked_block_sums(level1="hash")``) agree bit for bit."""
    x, _, _, jstate, tstate, _ = _gather_case("hbs")
    jk, _ = _kernels(kind, bw=1.0)
    n, bs, nf = x.shape[0], 48, 2
    nb = -(-n // bs)
    src = np.random.default_rng(2).integers(0, n, 64).astype(np.int32)
    key = jax.random.PRNGKey(21)
    cfg = dict(kind=kind, inv_bw=1.0 / jk.bandwidth, beta=1.0, num_far=nf,
               block_size=bs, num_blocks=nb, n=n)
    bsum, word = jhops.hashed_block_sums(jnp.asarray(x), jnp.asarray(src),
                                         jstate, key, pairwise=None, **cfg)
    off = torch.as_tensor(np.asarray(jax.random.randint(
        key, (len(src), nb, nf), 0, bs)).astype(np.int64))
    t_bs, t_word = thops.hashed_block_sums(
        torch.as_tensor(x), torch.as_tensor(src.astype(np.int64)), tstate,
        off, **cfg)
    np.testing.assert_allclose(t_bs.numpy(), np.asarray(bsum), rtol=RTOL,
                               atol=ATOL)
    _eq(t_word, np.asarray(word).astype(np.int64))
    _eq(thref.hashed_block_sums_ref(
        torch.as_tensor(x), torch.as_tensor(src.astype(np.int64)), tstate,
        off, kind, cfg["inv_bw"], 1.0, nf, bs, nb, n), t_bs.numpy())
    # the same read through the sampler's level-1 program
    m_bs, m_word = tops.masked_block_sums(
        torch.as_tensor(x), None, torch.as_tensor(src.astype(np.int64)), off,
        tstate, kind=kind, inv_bw=cfg["inv_bw"], beta=1.0, block_size=bs,
        num_blocks=nb, n=n, s=16, exact=False, level1="hash", num_far=nf)
    _eq(m_bs, t_bs.numpy())
    _eq(m_word, t_word.numpy())


def test_hashed_query_ht_heavy_follows_the_static_rule(monkeypatch):
    """The port's ``hashed_query`` mirrors the reference's KERNEL branch on
    every device: ``HT_HEAVY`` iff ``n / num_far > ht_bound()``, whatever
    the per-sample FAR values (``ht_frac`` is not read).  The reference's
    jnp branch tests each FAR value against ``ht_frac`` instead (ROADMAP.md
    §3, a designed-in divergence)."""
    x, _, _, _, tstate, w = _gather_case("heavy")
    n, nf = x.shape[0], 16                  # HT weight n/num_far = 40
    cfg = dict(kind="gaussian", inv_bw=1.0, beta=1.0, cell_width=w,
               num_far=nf, n=n)
    tx = torch.as_tensor(x)
    fidx = torch.randint(0, n, (32, nf), generator=torch.Generator()
                         .manual_seed(0))
    for bound, heavy in (("39.9", True), ("40", False), ("4096", False)):
        monkeypatch.setenv("REPRO_HT_BOUND", bound)
        monkeypatch.setenv("REPRO_HT_FRAC", "0.0")
        _, _, word = thops.hashed_query(tx, tx[:32], tstate, fidx, **cfg)
        assert bool(int(word[0]) & tg.HT_HEAVY) == heavy, bound
    monkeypatch.setenv("REPRO_HT_BOUND", "4096")
    _, _, word = thops.hashed_query(tx, tx[:32], tstate, None, **dict(
        cfg, num_far=0))
    assert not int(word[0]) & tg.HT_HEAVY


def test_gathers_emit_the_kernels_int32_columns():
    """On the path, the layout's members and the drawn FAR noise are int32,
    so both gathers hand the kernels int32 columns and no launch converts
    them; ``cols // block_size`` still scatters (int64 index)."""
    x, _, _, _, tstate, w = _gather_case("int32")
    n, nf, bs = x.shape[0], 16, 64
    nb = -(-n // bs)
    gen = torch.Generator().manual_seed(0)
    tx = torch.as_tensor(x)
    assert tstate.members.dtype == torch.int32
    fidx = thops.draw_query_noise(40, nf, n, gen, "cpu")
    cols, *_ = thref.query_gather(tx[:40], tstate, fidx, w, nf, n)
    assert cols.dtype == torch.int32 and cols.is_contiguous()
    src = torch.arange(0, n, 9)
    off = thops.draw_frontier_noise(src.numel(), nb, 2, bs, gen, "cpu")
    cols, *_ = thref.frontier_gather(src, tstate, off, 2, bs, nb, n)
    assert cols.dtype == torch.int32 and cols.is_contiguous()
    bsums, _ = thops.hashed_block_sums(
        tx, src, tstate, off, kind="gaussian", inv_bw=1.0, beta=1.0,
        num_far=2, block_size=bs, num_blocks=nb, n=n)
    assert bsums.shape == (src.numel(), nb)
    assert bool(torch.isfinite(bsums).all())


@pytest.mark.parametrize("kind", ["gaussian", "rational_quadratic"])
def test_hashed_kde_near_only_matches_reference(kind):
    """``HashedKDE`` with ``num_far_samples=0`` (deterministic) against the
    reference's: query estimates and Algorithm 4.3 degrees at rtol 2e-4,
    ``evals`` exactly, statuses equal; ``approximate_degrees`` dispatches
    to ``degrees()`` on both sides (clamped at 1e-12)."""
    x = _data(("hkde", kind), n=500, d=5, scale=1.0)
    jk, tk = _kernels(kind, bw=0.7)
    kw = dict(num_far_samples=0, max_bucket=16, num_hash_dims=4, seed=4)
    ref = JHashedKDE(x, jk, use_pallas=False, **kw)
    port = HashedKDE(x, tk, device="cpu", **kw)
    np.testing.assert_allclose(port.query(torch.as_tensor(x[:70])).numpy(),
                               np.asarray(ref.query(jnp.asarray(x[:70]))),
                               rtol=RTOL, atol=ATOL)
    assert port.evals == ref.evals
    np.testing.assert_allclose(approximate_degrees(port, batch=128),
                               japprox(ref, batch=128), rtol=RTOL, atol=ATOL)
    assert port.evals == ref.evals
    assert port.status == ref.status and port.last_status == ref.last_status
    assert port.device_counters.as_dict() == ref.device_counters.as_dict()
    assert isinstance(make_estimator("hash", x, tk, device="cpu"), HashedKDE)


def test_hashed_kde_far_samples_are_unbiased():
    """With FAR samples the estimate is random; its mean over 400 repeated
    queries lies within 4.5 standard errors of the exact row sums on every
    row (HT unbiasedness; alpha ~1e-4 over the 20 rows), and ``evals``
    counts realized NEAR reads + m * num_far."""
    x = _data("unbiased", n=400, d=4, scale=0.8)
    _, tk = _kernels("gaussian", bw=1.0)
    est = HashedKDE(x, tk, num_far_samples=32, max_bucket=8, seed=1,
                    device="cpu")
    y = torch.as_tensor(x[:20])
    draws = torch.stack([est.query(y) for _ in range(400)]).double()
    exact = torch.exp(-torch.cdist(y, torch.as_tensor(x)) ** 2).sum(1)
    sem = draws.std(0) / 400 ** 0.5
    assert bool(((draws.mean(0) - exact).abs() <= 4.5 * sem).all())
    cnt = est.state.counts[est.state.point_bucket[:20]].sum()
    assert est.evals == 400 * (int(cnt) + 20 * 32)


def test_stratified_block_sums_match_reference():
    """``StratifiedKDE``'s program against the reference's under the same
    uniforms (``uniform(key, (B, block_size))``): block sums at rtol 2e-4,
    counter words equal, ragged tail block included; the estimators count
    m*B*s evals per read."""
    x = _data("strat", n=300, d=5, scale=0.6)
    jk, tk = _kernels("gaussian", bw=1.0)
    port = StratifiedKDE(x, tk, block_size=64, samples_per_block=10,
                         seed=3, device="cpu")
    y = x[:25]
    key = jax.random.PRNGKey(3)
    cfg = port._static_cfg()
    want, word = jops.stratified_block_sums(
        jnp.asarray(y), jnp.asarray(x), jnp.sum(jnp.asarray(x) ** 2, -1), key,
        s=10, **cfg)
    u = torch.as_tensor(np.array(jax.random.uniform(key, (5, 64))))
    got, t_word = tops.stratified_block_sums(torch.as_tensor(y), port.x,
                                             port.x_sq, u, s=10, **cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    _eq(t_word, np.asarray(word).astype(np.int64))
    ref = JStratifiedKDE(x, jk, block_size=64, samples_per_block=10, seed=3)
    ref.block_sums(jnp.asarray(y))
    port.block_sums(torch.as_tensor(y))
    assert port.evals == ref.evals == 25 * 5 * 10
    assert isinstance(make_estimator("stratified", x, tk, device="cpu"),
                      StratifiedKDE)
