"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need a CUDA device and skip without one; on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(This file imports no JAX, so it runs where only PyTorch is installed.)
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_reduced
from repro_torch.core.kde.base import RSKDE, ExactKDE
from repro_torch.core.kernels_fn import gaussian, laplacian
from repro_torch.core.sampling.edge import NeighborSampler
from repro_torch.core.sparsify import (incidence_row_norms,
                                       spectral_sparsify)
from repro_torch.kernels.kde_hash import kernel as hk
from repro_torch.kernels.kde_hash import ops as hops
from repro_torch.kernels.kde_rowsum import kernel as rk
from repro_torch.kernels.kde_sampler import kernel as sk
from repro_torch.kernels.kde_sampler import ops as sops
from repro_torch.kernels.kde_sampler import ref as sref
from repro_torch.kernels.kde_sampler.ops import gumbel
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.kde_attention import kernel as kk
from repro_torch.kernels.kde_attention import ops as kops
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.testing import assert_bf16_close, bf16_steps
from repro_torch.train.train_step import make_decode_step

RTOL, ATOL = 2e-4, 1e-5
KINDS = ["gaussian", "exponential", "laplacian", "rational_quadratic"]
# (m, n, d, bn[, "misaligned"]): ragged (the generic tile: d = 19), aligned,
# the wide tile ragged at both padded widths (d = 8 -> 16, d = 32), the
# deep tile of rowsum / blocksum (the sampler kernels' generic tile) at its
# first width with a partial last chunk (d = 36) and at d = 784, once with
# m > 128 and n not a multiple of the rowsum's split width, and views off
# 16 bytes (the generic tile of every kernel)
SHAPES = [(37, 301, 19, 70), (64, 1024, 16, 256), (20, 203, 784, 50),
          (37, 301, 8, 70), (130, 1000, 32, 256), (130, 3000, 36, 256),
          (300, 5000, 784, 256), (130, 1000, 16, 256, "misaligned"),
          (40, 500, 784, 100, "misaligned")]
# (m, n, t, d) of the weighted gathered kernels: ragged, the degree-query
# width (t = 128 + 64), and the laplacian's mnist_like width
HASH_SHAPES = [(37, 301, 45, 19), (64, 4096, 192, 16), (20, 203, 33, 784),
               (37, 301, 45, 8), (50, 2000, 300, 32)]


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _misaligned(a):
    """A contiguous copy of ``a`` whose data starts 4 bytes past 16."""
    view = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)[1:]
    return view.view(a.shape).copy_(a)


def _inputs(kind, shape, dev):
    m, n, d, bn, *layout = shape
    gen = torch.Generator(device=dev).manual_seed(m * 1000 + d)
    q = torch.randn(m, d, generator=gen, device=dev) * 0.3
    x = torch.randn(n, d, generator=gen, device=dev) * 0.3
    if layout == ["misaligned"]:
        q, x = _misaligned(q), _misaligned(x)
    nb = -(-n // bn)
    own = torch.randint(-1, nb, (m,), generator=gen, device=dev)
    inv_bw = 1.0 / (0.3 * d) if kind == "laplacian" else 1.0 / (0.4 * d ** 0.5)
    return q, x, own, gumbel((m, nb), gen, dev), inv_bw, bn


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_kernels_match_plain(cuda, kind, shape):
    """All four kernels vs their plain versions: rtol 2e-4 / atol 1e-5;
    drawn blocks equal except where the top two scores lie within 1e-5."""
    q, x, own, g, inv_bw, bn = _inputs(kind, shape, cuda)
    torch.testing.assert_close(rk.rowsum_cuda(q, x, kind, inv_bw, 0.7),
                               rk.rowsum_plain(q, x, kind, inv_bw, 0.7),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        rk.blocksum_cuda(q, x, kind, inv_bw, 0.7, bn),
        rk.blocksum_plain(q, x, kind, inv_bw, 0.7, bn), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        sk.masked_blocksum_cuda(q, x, own, kind, inv_bw, 0.7, bn),
        sk.masked_blocksum_plain(q, x, own, kind, inv_bw, 0.7, bn),
        rtol=RTOL, atol=ATOL)
    blk, pb, tot, bs = sk.sample_block_cuda(q, x, own, g, kind, inv_bw, 0.7,
                                            bn)
    rblk, _, rtot, rbs = sk.sample_block_plain(q, x, own, g, kind, inv_bw,
                                               0.7, bn)
    torch.testing.assert_close(bs, rbs, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(tot, rtot, rtol=RTOL, atol=ATOL)
    top2 = torch.topk(torch.log(rbs) + g, 2, dim=1).values
    tie = top2[:, 0] - top2[:, 1] <= 1e-5
    assert bool(((blk == rblk) | tie).all())
    torch.testing.assert_close(pb, torch.gather(rbs, 1, blk[:, None])[:, 0]
                               / rtot, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tile", [
    ((64, 1024, 16, 256), "wide16"), ((130, 1000, 32, 256), "wide32"),
    ((130, 3000, 36, 256), "deep"), ((300, 5000, 784, 256), "deep"),
    ((37, 301, 19, 70), "generic"),
    ((130, 1000, 16, 256, "misaligned"), "generic"),
    ((40, 500, 784, 100, "misaligned"), "generic")])
def test_rowsum_blocksum_plans_pick_the_tile(cuda, shape, tile):
    """On the card's tensors, the rowsum and blocksum plans take the wide
    tile (d % 4 == 0, d <= 32, rows on 16 bytes), the deep tile (the same
    for d > 32) or the generic tile (any other d, any view off 16 bytes)."""
    want = {"wide16": 16, "wide32": 32, "deep": rk.DEEP, "generic": 0}[tile]
    q, x, _, _, inv_bw, bn = _inputs("gaussian", shape, cuda)
    for b in (None, bn):
        plan, kshape = rk._cached_plan(q, x, "gaussian", inv_bw, 1.0, b)
        assert plan.instance == want == kshape.instance


def _device_kernels_per_call(fn, reps=3):
    """CUDA kernels a call of ``fn`` launches, by name, from
    ``profiling.device_kernels`` (padded traces, retraced until whole; a
    lost record lowers a count, never raises it)."""
    from repro_torch.kernels.profiling import device_kernels
    return {k: c / reps for k, (c, _) in device_kernels(fn, reps).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 1024, 16, 256), (300, 5000, 784, 256),
                                   (37, 301, 19, 70)])
def test_blocksum_is_one_launch_and_rowsum_two(cuda, shape):
    """A blocksum call is one device launch on every tile; a rowsum call
    two (the split's block sums, then their deterministic reduction)."""
    q, x, _, _, inv_bw, bn = _inputs("laplacian", shape, cuda)
    got = _device_kernels_per_call(
        lambda: rk.blocksum_cuda(q, x, "laplacian", inv_bw, 1.0, bn))
    assert sum(got.values()) == 1, got
    got = _device_kernels_per_call(
        lambda: rk.rowsum_cuda(q, x, "laplacian", inv_bw, 1.0))
    assert sum(got.values()) == 2, got
    assert any("rowsum_reduce_kernel" in k for k in got), got


@pytest.mark.cuda
def test_sample_block_on_two_streams_at_once(cuda):
    """Two streams launching the sample-block kernel concurrently: each
    launch's tile arrival counters are its own, so every draw and sum
    equals the plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(65536, 16, generator=gen, device=cuda) * 0.5
    calls = []
    for _ in range(2):
        src = torch.randint(0, 65536, (1024,), generator=gen, device=cuda)
        calls.append((x[src], x, src // 256, gumbel((1024, 256), gen, cuda),
                      "gaussian", 1.0, 1.0, 256))
    wants = [sk.sample_block_plain(*c) for c in calls]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    gots = [[], []]
    for _ in range(8):
        for i, (st, c) in enumerate(zip(streams, calls)):
            with torch.cuda.stream(st):
                gots[i].append(sk.sample_block_cuda(*c))
    torch.cuda.synchronize()
    for got, want, c in zip(gots, wants, calls):
        for g in got:
            _assert_sample_block(g, want, c[3])


def _assert_sample_block(got, want, g, exact=False):
    """sample_block kernel output vs plain: bs, tot rtol 2e-4 / atol 1e-5,
    blk int64 and equal except at near-ties within 1e-5 (everywhere with
    ``exact``), p_blk against the plain sums at the kernel's draw."""
    blk, pb, tot, bs = got
    rblk, _, rtot, rbs = want
    assert blk.dtype == torch.int64
    torch.testing.assert_close(bs, rbs, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(tot, rtot, rtol=RTOL, atol=ATOL)
    if exact:
        assert torch.equal(blk, rblk)
    else:
        top2 = torch.topk(torch.log(rbs) + g, min(2, rbs.shape[1]), dim=1).values
        tie = top2[:, 0] - top2[:, -1] <= 1e-5
        assert bool(((blk == rblk) | tie).all())
    torch.testing.assert_close(pb, torch.gather(rbs, 1, blk[:, None])[:, 0]
                               / rtot, rtol=RTOL, atol=ATOL)


def tie_case(kind, m, n, d, bn, dev, seed=0):
    """Planted exact ties: dyadic coordinates (k / 8, |k| <= 4), so every
    distance is exact in f32 in any summation order; block ``hi`` is a
    copy of block ``lo``, no row owns either, and both get the same large
    Gumbel noise, so every row's top two scores tie exactly and the lower
    block must win.  Returns (q, x, own, g, inv_bw, lo)."""
    rng = np.random.default_rng(seed)
    nb = -(-n // bn)
    lo, hi = 1, n // bn - 1
    x = rng.integers(-4, 5, (n, d)) / 8.0
    x[hi * bn:(hi + 1) * bn] = x[lo * bn:(lo + 1) * bn]
    q = rng.integers(-4, 5, (m, d)) / 8.0
    own = rng.integers(-1, nb, m)
    own[(own == lo) | (own == hi)] = -1
    g = rng.gumbel(size=(m, nb))
    g[:, lo] = g[:, hi] = 30.0
    inv_bw = 1.0 / (0.25 * d) if kind == "laplacian" else 1.0 / (0.5 * d ** 0.5)
    t = [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (q, x, g)]
    return (t[0], t[1], torch.as_tensor(own, device=dev), t[2], inv_bw, lo)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 19])
@pytest.mark.parametrize("kind", KINDS)
def test_sample_block_kernel_ties_go_to_the_lower_block(cuda, kind, d):
    """Two blocks with the same rows and equal Gumbel noise: the fused
    draw picks the lower one on every row, as the reference's strict-">"
    update (wide tile at d = 16, generic at d = 19)."""
    q, x, own, g, inv_bw, lo = tie_case(kind, 300, 2048, d, 256, cuda)
    got = sk.sample_block_cuda(q, x, own, g, kind, inv_bw, 0.7, 256)
    assert bool((got[0] == lo).all())
    _assert_sample_block(got, sk.sample_block_plain(q, x, own, g, kind,
                                                    inv_bw, 0.7, 256), g,
                         exact=True)


@pytest.mark.cuda
def test_sample_block_kernel_at_the_main_shape(cuda):
    """The exact sparsifier's edge-batch shape (m = 1024, n = 65536, d =
    16, bn = 256, gaussian) with int64 own as the path hands it, and the
    masked-blocksum kernel on the same rows: one launch each."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(65536, 16, generator=gen, device=cuda) * 0.5
    src = torch.randint(0, 65536, (1024,), generator=gen, device=cuda)
    q, own = x[src], src // 256
    g = gumbel((1024, 256), gen, cuda)
    assert sk.sample_block_plan(1024, 65536, 16, 256).instance == 16
    sk.reset_launches()
    got = sk.sample_block_cuda(q, x, own, g, "gaussian", 1.0, 1.0, 256)
    masked = sk.masked_blocksum_cuda(q, x, own, "gaussian", 1.0, 1.0, 256)
    assert sk.LAUNCHES == {"masked_blocksum": 1, "sample_block": 1,
                           "masked_blocksum_bf16": 0, "sample_block_bf16": 0}
    want = sk.sample_block_plain(q, x, own, g, "gaussian", 1.0, 1.0, 256)
    _assert_sample_block(got, want, g)
    torch.testing.assert_close(masked, want[3], rtol=RTOL, atol=ATOL)
    got32 = sk.sample_block_cuda(q, x, own.to(torch.int32), g, "gaussian",
                                 1.0, 1.0, 256)
    for a, b in zip(got32, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [2, 3, 8])
@pytest.mark.parametrize("shape", [(37, 301, 8, 70), (130, 1000, 32, 256),
                                   (37, 301, 19, 70), (300, 4096, 16, 256)])
def test_sample_block_kernel_block_groups(cuda, monkeypatch, shape, group):
    """A CTA summing several consecutive level-1 blocks (the last group
    ragged, the last block too) gives the same sums and draws, both
    instances."""
    monkeypatch.setattr(sk, "group_for", lambda *_: group)
    monkeypatch.setattr(sk, "_PLANS", {})
    q, x, own, g, inv_bw, bn = _inputs("gaussian", shape, cuda)
    m, n, d, _ = shape
    assert sk.sample_block_plan(m, n, d, bn).group == group
    _assert_sample_block(sk.sample_block_cuda(q, x, own, g, "gaussian",
                                              inv_bw, 0.7, bn),
                         sk.sample_block_plain(q, x, own, g, "gaussian",
                                               inv_bw, 0.7, bn), g)
    torch.testing.assert_close(
        sk.masked_blocksum_cuda(q, x, own, "gaussian", inv_bw, 0.7, bn),
        sk.masked_blocksum_plain(q, x, own, "gaussian", inv_bw, 0.7, bn),
        rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 19])
def test_sample_block_kernel_repeated_calls_reset_the_counters(cuda, d):
    """Calls of several row counts in a row, each with fresh noise: every
    draw matches, so each launch leaves its tiles' arrival counters at 0."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn(3000, d, generator=gen, device=cuda) * 0.4
    for m in (1024, 37, 300, 1, 1024, 129, 1024):
        q = torch.randn(m, d, generator=gen, device=cuda) * 0.4
        own = torch.randint(-1, 12, (m,), generator=gen, device=cuda)
        g = gumbel((m, 12), gen, cuda)
        got = sk.sample_block_cuda(q, x, own, g, "exponential", 0.5, 1.0, 256)
        _assert_sample_block(got, sk.sample_block_plain(
            q, x, own, g, "exponential", 0.5, 1.0, 256), g)


@pytest.mark.cuda
def test_weighted_kv_kernels_at_the_main_shape(cuda):
    """The hashed sparsifier's frontier read (m = 1024, t = 1152, d = 16
    over n = 262144) and the degree query's width (t = 192): the vector
    instance, against the plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(262144, 16, generator=gen, device=cuda)
    for t, name in ((1152, "weighted_kv"), (192, "weighted_kv_sum")):
        q = torch.randn(1024, 16, generator=gen, device=cuda)
        cols = torch.randint(0, 262144, (1024, t), generator=gen,
                             dtype=torch.int32, device=cuda)
        wgt = torch.rand((1024, t), generator=gen, device=cuda) * 256.0
        args = (q, x, cols, wgt, "gaussian", 1.0)
        want = getattr(hk, name + "_plain")(*args)
        torch.testing.assert_close(getattr(hk, name + "_cuda")(*args), want,
                                   rtol=RTOL,
                                   atol=1e-6 * float(want.abs().max()))
    assert hk.weighted_kv_plan(1024, 262144, 16, 1152).instance == 4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unaligned", "d19"])
def test_weighted_kv_kernels_scalar_path(cuda, case):
    """x off 16-byte alignment (a view one float into a buffer) at d = 16,
    and d = 19: both take the scalar instance and match the plain
    versions."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    m, n, t = 64, 5000, 300
    d = 16 if case == "unaligned" else 19
    flat = torch.randn(n * d + 1, generator=gen, device=cuda)
    x = flat[1:].view(n, d) if case == "unaligned" else flat[:n * d].view(n, d)
    if case == "unaligned":
        assert x.data_ptr() % 16 != 0
    assert hk.weighted_kv_plan(m, n, d, t, x.data_ptr() % 16 == 0).instance == 0
    q = torch.randn(m, d, generator=gen, device=cuda)
    cols = torch.randint(-2, n + 2, (m, t), generator=gen, dtype=torch.int32,
                         device=cuda)
    wgt = torch.rand((m, t), generator=gen, device=cuda) * 256.0
    for name in ("weighted_kv", "weighted_kv_sum"):
        args = (q, x, cols, wgt, "laplacian" if d == 19 else "gaussian", 0.3)
        want = getattr(hk, name + "_plain")(*args)
        torch.testing.assert_close(getattr(hk, name + "_cuda")(*args), want,
                                   rtol=RTOL,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.cuda
def test_sampler_runs_on_the_kernels(cuda):
    """A CUDA sampler reads its level-1 sums through the kernels (counted
    launches) and prob_of reproduces the realized probabilities."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.5, (3000, 8)).astype(np.float32)
    src = rng.integers(0, 3000, 500)
    sk.reset_launches()
    nbr = NeighborSampler(x, gaussian(1.0), exact_blocks=True, device=cuda)
    v, p = nbr.sample(src)
    assert sk.LAUNCHES["sample_block"] == 1
    fresh = NeighborSampler(x, gaussian(1.0), exact_blocks=True, device=cuda)
    np.testing.assert_allclose(fresh.prob_of(src, v), p, rtol=1e-4)
    assert sk.LAUNCHES["masked_blocksum"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HASH_SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_hash_kernels_match_plain(cuda, kind, shape):
    """Both kde_hash kernels vs their plain versions, columns past the end
    included (clamped): rtol 2e-4 and an atol of 1e-6 of the largest
    value (the HT weights scale the outputs up to 256 here)."""
    m, n, t, d = shape
    gen = torch.Generator(device=cuda).manual_seed(m * 1000 + d)
    q = torch.randn(m, d, generator=gen, device=cuda) * 0.3
    x = torch.randn(n, d, generator=gen, device=cuda) * 0.3
    cols = torch.randint(0, n + 3, (m, t), generator=gen, dtype=torch.int32,
                         device=cuda)
    wgt = torch.rand((m, t), generator=gen, device=cuda) * 256.0
    inv_bw = 1.0 / (0.3 * d) if kind == "laplacian" else 1.0 / (0.4 * d ** 0.5)
    args = (q, x, cols, wgt, kind, inv_bw, 0.7)
    want = hk.weighted_kv_plain(*args)
    torch.testing.assert_close(hk.weighted_kv_cuda(*args), want, rtol=RTOL,
                               atol=1e-6 * float(want.abs().max()))
    want = hk.weighted_kv_sum_plain(*args)
    torch.testing.assert_close(hk.weighted_kv_sum_cuda(*args), want,
                               rtol=RTOL, atol=1e-6 * float(want.abs().max()))


@pytest.mark.cuda
def test_hash_path_runs_on_the_kernels(cuda):
    """A level-1-hash sampler on the card reads its frontier through the
    weighted-kv kernel and prob_of reproduces the realized probabilities;
    the hashed sparsifier's degrees go through the weighted-kv-sum kernel
    (one launch per 1024-row batch) and its edge batches through the
    weighted-kv kernel (one launch per batch)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.5, (3000, 8)).astype(np.float32)
    src = rng.integers(0, 3000, 500)
    hk.reset_launches()
    nbr = NeighborSampler(x, gaussian(1.0), level1="hash", device=cuda)
    v, p = nbr.sample(src)
    assert hk.LAUNCHES == {"weighted_kv_sum": 0, "weighted_kv": 1,
                           "weighted_kv_sum_bf16": 0, "weighted_kv_bf16": 0}
    np.testing.assert_allclose(nbr.prob_of(src, v), p, rtol=1e-6)
    hk.reset_launches()
    g = spectral_sparsify(x, gaussian(1.0), num_edges=4096, estimator="hash",
                          device=cuda)
    assert hk.LAUNCHES == {"weighted_kv_sum": 3, "weighted_kv": 4,
                           "weighted_kv_sum_bf16": 0, "weighted_kv_bf16": 0}
    assert np.all(np.isfinite(g.weight)) and g.num_edges == 4096


# --------------------------------------------------------------------- #
# the bf16 policy (DESIGN.md §14): the bf16 instances of the KDE kernels
# --------------------------------------------------------------------- #
L2_KINDS = ["gaussian", "exponential", "rational_quadratic"]


def _bf16_close(got, want, slack):
    """bf16 kernel vs plain: |got - want| <= atol + rtol |want| + slack,
    where ``slack`` is the reduced ``ref.bf16_flip_slack`` of the pairs
    behind each output (0 where no pair's f32 argument can cross a bf16
    rounding midpoint between the two summation orders)."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs() + slack
    assert not bool(bad.any()), (int(bad.sum()), float(err.max()))
    assert bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", L2_KINDS)
def test_bf16_kernels_match_plain(cuda, kind, shape):
    """The bf16 instances of the four level-1 kernels (every tile: the
    ragged, wide, deep and misaligned shapes) vs their plain versions at
    rtol 2e-4 / atol 1e-5 plus the flip slack of each output's pairs;
    drawn blocks equal except where the top two scores lie within 1e-5 or
    within the slack; the launches counted under the bf16 keys."""
    q, x, own, g, inv_bw, bn = _inputs(kind, shape, cuda)
    slack = sref.bf16_flip_slack(q, x, kind, inv_bw)
    bslack = sref.bf16_flip_slack(q, x, kind, inv_bw, bn)
    rk.reset_launches()
    sk.reset_launches()
    _bf16_close(rk.rowsum_cuda(q, x, kind, inv_bw, 0.7, "bf16"),
                rk.rowsum_plain(q, x, kind, inv_bw, 0.7, "bf16"),
                slack.sum(1))
    _bf16_close(rk.blocksum_cuda(q, x, kind, inv_bw, 0.7, bn, "bf16"),
                rk.blocksum_plain(q, x, kind, inv_bw, 0.7, bn, "bf16"),
                bslack)
    _bf16_close(sk.masked_blocksum_cuda(q, x, own, kind, inv_bw, 0.7, bn,
                                        "bf16"),
                sk.masked_blocksum_plain(q, x, own, kind, inv_bw, 0.7, bn,
                                         "bf16"), bslack)
    blk, pb, tot, bs = sk.sample_block_cuda(q, x, own, g, kind, inv_bw, 0.7,
                                            bn, "bf16")
    _, _, rtot, rbs = sk.sample_block_plain(q, x, own, g, kind, inv_bw, 0.7,
                                            bn, "bf16")
    _bf16_close(bs, rbs, bslack)
    _bf16_close(tot, rtot, bslack.sum(1))
    score = torch.log(rbs) + g
    top2 = torch.topk(score, 2, dim=1).values
    widen = 2.0 * torch.log1p(bslack / rbs.double()).max(1).values
    tie = (top2[:, 0] - top2[:, 1]).double() <= 1e-5 + widen
    assert bool(((blk == torch.argmax(score, 1)) | tie).all())
    _bf16_close(pb, torch.gather(rbs, 1, blk[:, None])[:, 0] / rtot,
                (bslack.sum(1) + torch.gather(bslack, 1, blk[:, None])[:, 0])
                / rtot.double())
    assert rk.LAUNCHES == {"rowsum": 0, "blocksum": 0, "rowsum_bf16": 1,
                           "blocksum_bf16": 1}
    assert sk.LAUNCHES == {"masked_blocksum": 0, "sample_block": 0,
                           "masked_blocksum_bf16": 1, "sample_block_bf16": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 301, 19, 70), (64, 1024, 16, 256),
                                   (37, 301, 8, 70), (130, 1000, 32, 256),
                                   (130, 1000, 36, 256),
                                   (130, 1000, 16, 256, "misaligned")])
@pytest.mark.parametrize("kind", ["gaussian", "exponential"])
def test_bf16_blocksum_one_column_blocks_are_the_plain_values(cuda, kind,
                                                               shape):
    """A blocksum of one-column blocks returns every bf16 kernel value of
    the tile: equal to the plain version's wherever no bf16 rounding
    midpoint lies within the f32 error of the pair's argument (the kernel
    rounds its staged operands and reads the same table entry), and within
    the flip slack where one does."""
    q, x, _, _, inv_bw, _ = _inputs(kind, shape, cuda)
    got = rk.blocksum_cuda(q, x, kind, inv_bw, 1.0, 1, "bf16")
    want = rk.blocksum_plain(q, x, kind, inv_bw, 1.0, 1, "bf16")
    slack = sref.bf16_flip_slack(q, x, kind, inv_bw)
    assert torch.equal(got[slack == 0], want[slack == 0])
    _bf16_close(got, want, slack)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 19, 36])
@pytest.mark.parametrize("kind", L2_KINDS)
def test_bf16_kernels_on_dyadic_points(cuda, kind, d):
    """Dyadic coordinates are exact in bf16 and every distance is exact in
    f32 in any order, so the bf16 kernels equal their plain versions to
    the kernel tolerance with no slack, and planted exact ties (two equal
    blocks, equal Gumbel noise) go to the lower block on every row."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    n, bn, m = 2048, 128, 200
    x = torch.randint(-4, 5, (n, d), generator=gen, device=cuda) / 8.0
    x[7 * bn:8 * bn] = x[2 * bn:3 * bn]
    q = torch.randint(-4, 5, (m, d), generator=gen, device=cuda) / 8.0
    own = torch.randint(-1, 16, (m,), generator=gen, device=cuda)
    own[(own == 2) | (own == 7)] = -1
    g = gumbel((m, 16), gen, cuda)
    g[:, 2] = g[:, 7] = 30.0
    inv_bw = 1.0 / (0.5 * d ** 0.5)
    args = (kind, inv_bw, 0.7)
    torch.testing.assert_close(rk.rowsum_cuda(q, x, *args, "bf16"),
                               rk.rowsum_plain(q, x, *args, "bf16"),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(rk.blocksum_cuda(q, x, *args, bn, "bf16"),
                               rk.blocksum_plain(q, x, *args, bn, "bf16"),
                               rtol=RTOL, atol=ATOL)
    blk, _, tot, bs = sk.sample_block_cuda(q, x, own, g, *args, bn, "bf16")
    want = sk.sample_block_plain(q, x, own, g, *args, bn, "bf16")
    torch.testing.assert_close(bs, want[3], rtol=RTOL, atol=ATOL)
    assert torch.equal(bs[:, 2], bs[:, 7])
    assert bool((blk == 2).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HASH_SHAPES)
@pytest.mark.parametrize("kind", L2_KINDS)
def test_bf16_hash_kernels_match_plain(cuda, kind, shape):
    """The bf16 instances of both kde_hash kernels (vector and scalar) vs
    their plain versions, columns past the end included (clamped): rtol
    2e-4, an atol of 1e-6 of the largest value, plus the flip slack of
    each gathered pair times its weight."""
    m, n, t, d = shape
    gen = torch.Generator(device=cuda).manual_seed(m * 1000 + d)
    q = torch.randn(m, d, generator=gen, device=cuda) * 0.3
    x = torch.randn(n, d, generator=gen, device=cuda) * 0.3
    cols = torch.randint(0, n + 3, (m, t), generator=gen, dtype=torch.int32,
                         device=cuda)
    wgt = torch.rand((m, t), generator=gen, device=cuda) * 256.0
    inv_bw = 1.0 / (0.4 * d ** 0.5)
    args = (q, x, cols, wgt, kind, inv_bw, 0.7)
    slack = sref.bf16_flip_slack(q, x[cols.long().clamp(0, n - 1)], kind,
                                 inv_bw) * wgt.double()
    hk.reset_launches()
    want = hk.weighted_kv_plain(*args, precision="bf16")
    atol = 1e-6 * float(want.abs().max())
    _bf16_close(hk.weighted_kv_cuda(*args, precision="bf16"), want,
                slack + atol)
    want = hk.weighted_kv_sum_plain(*args, precision="bf16")
    _bf16_close(hk.weighted_kv_sum_cuda(*args, precision="bf16"), want,
                slack.sum(1) + 1e-6 * float(want.abs().max()))
    assert hk.LAUNCHES == {"weighted_kv_sum": 0, "weighted_kv": 0,
                           "weighted_kv_sum_bf16": 1, "weighted_kv_bf16": 1}


@pytest.mark.cuda
def test_bf16_paths_run_on_the_bf16_kernels(cuda):
    """The public bf16 entry points on the card launch the bf16 instances
    and no f32 one: an exact sampler (sample, then prob_of on a fresh
    one: sample_block_bf16, masked_blocksum_bf16), its block structure's
    degrees (blocksum_bf16), ExactKDE (rowsum_bf16, against its CPU twin)
    and a level-1-hash sampler over a bf16 HashedKDE (weighted_kv_bf16,
    weighted_kv_sum_bf16)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.5, (3000, 8)).astype(np.float32)
    src = rng.integers(0, 3000, 500)
    for mod in (rk, sk, hk):
        mod.reset_launches()
    nbr = NeighborSampler(x, gaussian(1.0), exact_blocks=True,
                          precision="bf16", device=cuda)
    v, p = nbr.sample(src)
    fresh = NeighborSampler(x, gaussian(1.0), exact_blocks=True,
                            precision="bf16", device=cuda)
    np.testing.assert_allclose(fresh.prob_of(src, v), p, rtol=1e-4)
    nbr.blocks.block_sums(x[:64])
    est = ExactKDE(x, gaussian(1.0), precision="bf16", device=cuda)
    cpu = ExactKDE(x, gaussian(1.0), precision="bf16", device="cpu")
    np.testing.assert_allclose(est.query(x[:100]).cpu().numpy(),
                               cpu.query(x[:100]).numpy(), rtol=1e-3)
    hs = NeighborSampler(x, gaussian(1.0), level1="hash", precision="bf16",
                         device=cuda)
    hs.sample(src)
    hs.hash_estimator.query(x[:64])
    assert rk.LAUNCHES == {"rowsum": 0, "blocksum": 0, "rowsum_bf16": 1,
                           "blocksum_bf16": 1}
    assert sk.LAUNCHES == {"masked_blocksum": 0, "sample_block": 0,
                           "masked_blocksum_bf16": 1, "sample_block_bf16": 1}
    assert hk.LAUNCHES == {"weighted_kv_sum": 0, "weighted_kv": 0,
                           "weighted_kv_sum_bf16": 1, "weighted_kv_bf16": 1}


# the tensor-core sample-block tile and the bf16-row weighted kernels:
# (m, n, d, bn) with m around the 16-row warp slices and the 128-row tile,
# ragged (70) and full (256) block sizes, and every padded width (d = 8 in
# one zero-padded k-step, 16, 32 in two)
MMA_SHAPES = [(m, 3000, d, bn) for m in (1, 15, 17, 129) for bn in (70, 256)
              for d in (8, 16, 32)]


def _mma_against_plain(q, x, own, g, kind, inv_bw, bn):
    """The bf16 masked-blocksum and sample-block kernels on the tensor-core
    tile vs their plain versions within the flip slack (sums, totals, p),
    drawn blocks equal but at near-ties; two calls bitwise equal."""
    m, d = q.shape
    plan = sk.sample_block_plan(m, x.shape[0], d, bn, precision="bf16")
    assert plan.instance == sk.MMA + (16 if d <= 16 else 32)
    bslack = sref.bf16_flip_slack(q, x, kind, inv_bw, bn)
    _bf16_close(sk.masked_blocksum_cuda(q, x, own, kind, inv_bw, 0.7, bn,
                                        "bf16"),
                sk.masked_blocksum_plain(q, x, own, kind, inv_bw, 0.7, bn,
                                         "bf16"), bslack)
    got = sk.sample_block_cuda(q, x, own, g, kind, inv_bw, 0.7, bn, "bf16")
    blk, pb, tot, bs = got
    _, _, rtot, rbs = sk.sample_block_plain(q, x, own, g, kind, inv_bw, 0.7,
                                            bn, "bf16")
    _bf16_close(bs, rbs, bslack)
    _bf16_close(tot, rtot, bslack.sum(1))
    if rbs.shape[1] > 1:
        score = torch.log(rbs) + g
        top2 = torch.topk(score, 2, dim=1).values
        widen = 2.0 * torch.log1p(bslack / rbs.double()).max(1).values
        tie = (top2[:, 0] - top2[:, 1]).double() <= 1e-5 + widen
        assert bool(((blk == torch.argmax(score, 1)) | tie).all())
    _bf16_close(pb, torch.gather(rbs, 1, blk[:, None])[:, 0] / rtot,
                (bslack.sum(1) + torch.gather(bslack, 1, blk[:, None])[:, 0])
                / rtot.double())
    again = sk.sample_block_cuda(q, x, own, g, kind, inv_bw, 0.7, bn, "bf16")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MMA_SHAPES)
@pytest.mark.parametrize("kind", L2_KINDS)
def test_mma_sampler_kernels_match_plain(cuda, kind, shape):
    """The tensor-core instance of the bf16 sampler kernels (plan MMA + the
    padded d) at ragged m and bn, every padded width, every L2 kind."""
    q, x, own, g, inv_bw, bn = _inputs(kind, shape, cuda)
    _mma_against_plain(q, x, own, g, kind, inv_bw, bn)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [4.0, 30.0, 300.0])
@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("kind", L2_KINDS)
def test_mma_sampler_kernels_on_cancelling_inputs(cuda, kind, d, offset):
    """Inputs built for cancellation: every point sits at a common offset
    large against its spread (qq + xx - 2c cancels all but a few bits of
    the norms), and the queries are dataset rows (each meets itself at d2
    = 0).  The tensor cores' truncating accumulation stays within the flip
    slack's error model (``ref._pair_slack``): no slack is widened."""
    gen = torch.Generator(device=cuda).manual_seed(d * 7 + int(offset))
    n, m, bn = 2000, 150, 70
    x = offset + torch.randn(n, d, generator=gen, device=cuda) * 0.5
    src = torch.randint(0, n, (m,), generator=gen, device=cuda)
    q = x[src].contiguous()
    g = gumbel((m, -(-n // bn)), gen, cuda)
    _mma_against_plain(q, x, src // bn, g, kind, 1.0 / (0.5 * d ** 0.5), bn)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 32])
@pytest.mark.parametrize("kind", L2_KINDS)
def test_mma_sampler_ties_go_to_the_lower_block(cuda, kind, d):
    """Dyadic points (exact in bf16 and in f32 in any order, so no slack)
    at the widths the other dyadic test leaves out: the tensor-core tile
    equals the plain sums at the kernel tolerance, two equal blocks with
    equal Gumbel noise give bitwise equal sums and the lower block on
    every row, and repeated calls are bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(100 + d)
    n, bn, m = 2048, 128, 200
    x = torch.randint(-4, 5, (n, d), generator=gen, device=cuda) / 8.0
    x[7 * bn:8 * bn] = x[2 * bn:3 * bn]
    q = torch.randint(-4, 5, (m, d), generator=gen, device=cuda) / 8.0
    own = torch.randint(-1, 16, (m,), generator=gen, device=cuda)
    own[(own == 2) | (own == 7)] = -1
    g = gumbel((m, 16), gen, cuda)
    g[:, 2] = g[:, 7] = 30.0
    args = (kind, 1.0 / (0.5 * d ** 0.5), 0.7, bn, "bf16")
    got = sk.sample_block_cuda(q, x, own, g, *args)
    want = sk.sample_block_plain(q, x, own, g, *args)
    torch.testing.assert_close(got[3], want[3], rtol=RTOL, atol=ATOL)
    assert torch.equal(got[3][:, 2], got[3][:, 7])
    assert bool((got[0] == 2).all())
    assert all(torch.equal(a, b) for a, b in zip(
        got, sk.sample_block_cuda(q, x, own, g, *args)))


# the bf16 rowsum and blocksum on the tensor-core tile: m around the 64-row
# short tile (1, 37, 64 split; 65 full; 129 a full tile and a short one;
# 1024 eight full ones), one-column, ragged and full blocks, every padded
# width
ROWSUM_MMA_SHAPES = [(m, 3000, d, bn) for m in (1, 37, 64, 65, 129, 1024)
                     for bn in (1, 70, 256) for d in (8, 16, 32)]


def _rowsum_mma_against_plain(q, x, kind, inv_bw, bn, instance):
    """The bf16 rowsum and blocksum at plan ``instance`` vs their plain
    versions within the flip slack; one-column blocks equal the plain
    values off the slack; two calls bitwise equal."""
    m, d = q.shape
    for b in (None, bn):
        assert rk._cached_plan(q, x, kind, inv_bw, 0.7, b,
                               "bf16")[0].instance == instance
    args = (kind, inv_bw, 0.7)
    slack = sref.bf16_flip_slack(q, x, kind, inv_bw)
    got = rk.rowsum_cuda(q, x, *args, "bf16")
    _bf16_close(got, rk.rowsum_plain(q, x, *args, "bf16"), slack.sum(1))
    assert torch.equal(got, rk.rowsum_cuda(q, x, *args, "bf16"))
    got = rk.blocksum_cuda(q, x, *args, bn, "bf16")
    want = rk.blocksum_plain(q, x, *args, bn, "bf16")
    _bf16_close(got, want, sref.bf16_flip_slack(q, x, kind, inv_bw, bn))
    assert torch.equal(got, rk.blocksum_cuda(q, x, *args, bn, "bf16"))
    if bn == 1 and kind != "rational_quadratic":
        assert torch.equal(got[slack == 0], want[slack == 0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ROWSUM_MMA_SHAPES)
@pytest.mark.parametrize("kind", L2_KINDS)
def test_mma_rowsum_blocksum_match_plain(cuda, kind, shape):
    """The bf16 rowsum and blocksum take the tensor-core tile (plan MMA +
    the padded d) wherever the wide tile's conditions hold, and match
    their plain versions within the flip slack at short tiles (m <= 64,
    the warp halves split the columns), full ones and both in one call;
    two calls are bitwise equal."""
    q, x, _, _, inv_bw, bn = _inputs(kind, shape, cuda)
    d = q.shape[1]
    _rowsum_mma_against_plain(q, x, kind, inv_bw, bn,
                              sk.MMA + (16 if d <= 16 else 32))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 64, 129])
@pytest.mark.parametrize("kind", L2_KINDS)
def test_mma_rowsum_blocksum_views_off_16_bytes_take_the_generic_tile(
        cuda, kind, m):
    """A view off 16 bytes takes the generic tile at bf16, as at f32, and
    still matches the plain version within the flip slack."""
    q, x, _, _, inv_bw, bn = _inputs(kind, (m, 3000, 16, 70, "misaligned"),
                                     cuda)
    _rowsum_mma_against_plain(q, x, kind, inv_bw, bn, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [37, 64, 300])
@pytest.mark.parametrize("offset", [4.0, 300.0])
@pytest.mark.parametrize("d", [8, 32])
@pytest.mark.parametrize("kind", L2_KINDS)
def test_mma_rowsum_blocksum_on_cancelling_inputs(cuda, kind, d, offset, m):
    """Cancelling inputs (a common offset large against a 0.5 spread,
    queries that are dataset rows) on the tensor-core rowsum and blocksum,
    short and full tiles: within the flip slack, no slack widened."""
    gen = torch.Generator(device=cuda).manual_seed(d * 11 + int(offset) + m)
    n, bn = 2000, 70
    x = offset + torch.randn(n, d, generator=gen, device=cuda) * 0.5
    q = x[torch.randint(0, n, (m,), generator=gen, device=cuda)].contiguous()
    _rowsum_mma_against_plain(q, x, kind, 1.0 / (0.5 * d ** 0.5), bn,
                              sk.MMA + (16 if d <= 16 else 32))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 1024])
def test_mma_blocksum_is_one_launch_and_rowsum_two(cuda, m):
    """On the tensor-core tile a bf16 blocksum call is one launch of
    ``blocksum_mma_kernel`` and a rowsum call two (the split's block sums,
    then the reduce), counted under the bf16 keys."""
    q, x, _, _, inv_bw, bn = _inputs("gaussian", (m, 65536, 16, 256), cuda)
    rk.reset_launches()
    got = _device_kernels_per_call(
        lambda: rk.blocksum_cuda(q, x, "gaussian", inv_bw, 1.0, bn, "bf16"))
    assert sum(got.values()) == 1, got
    assert all("blocksum_mma_kernel" in k for k in got), got
    got = _device_kernels_per_call(
        lambda: rk.rowsum_cuda(q, x, "gaussian", inv_bw, 1.0, "bf16"))
    assert sum(got.values()) == 2, got
    assert any("blocksum_mma_kernel" in k for k in got), got
    assert any("rowsum_reduce_kernel" in k for k in got), got
    assert rk.LAUNCHES["rowsum"] == rk.LAUNCHES["blocksum"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HASH_SHAPES)
@pytest.mark.parametrize("kind", L2_KINDS)
def test_weighted_kv_on_bf16_rows_is_bitwise_the_f32_rows(cuda, kind, shape):
    """Both kde_hash kernels on the dataset's bf16-resident copy (the
    bf16-row instances: vector at d = 8 / 16 / 32, scalar at 19 / 784)
    give bitwise what their bf16 instances give on the f32 rows (the
    lanes add the same values in the same order), within the flip slack
    of the plain version, counted under the bf16 keys."""
    m, n, t, d = shape
    gen = torch.Generator(device=cuda).manual_seed(m * 1000 + d + 1)
    q = torch.randn(m, d, generator=gen, device=cuda) * 0.3
    x = torch.randn(n, d, generator=gen, device=cuda) * 0.3
    x16 = sref.round_bf16(x).to(torch.bfloat16)
    cols = torch.randint(-2, n + 3, (m, t), generator=gen, dtype=torch.int32,
                         device=cuda)
    wgt = torch.rand((m, t), generator=gen, device=cuda) * 256.0
    a = (cols, wgt, kind, 1.0 / (0.4 * d ** 0.5), 0.7)
    plan = hk.weighted_kv_plan(m, n, d, t, x16.data_ptr() % 8 == 0,
                               torch.bfloat16, "bf16")
    assert plan.instance >= hk.BF16_ROWS
    hk.reset_launches()
    kv = hk.weighted_kv_cuda(q, x16, *a, precision="bf16")
    kv_sum = hk.weighted_kv_sum_cuda(q, x16, *a, precision="bf16")
    assert hk.LAUNCHES == {"weighted_kv_sum": 0, "weighted_kv": 0,
                           "weighted_kv_sum_bf16": 1, "weighted_kv_bf16": 1}
    assert torch.equal(kv, hk.weighted_kv_cuda(q, x, *a, precision="bf16"))
    assert torch.equal(kv_sum, hk.weighted_kv_sum_cuda(q, x, *a,
                                                       precision="bf16"))
    slack = sref.bf16_flip_slack(q, x[cols.long().clamp(0, n - 1)], kind,
                                 a[3]) * wgt.double()
    want = hk.weighted_kv_plain(q, x16, *a, precision="bf16")
    _bf16_close(kv, want, slack + 1e-6 * float(want.abs().max()))
    with pytest.raises(ValueError, match="needs precision='bf16'"):
        hk.weighted_kv_cuda(q, x16, *a)


@pytest.mark.cuda
def test_hashed_bf16_paths_gather_the_copy(cuda, monkeypatch):
    """On the card, a bf16 hashed sampler's level-1 reads, its walks and
    its estimator's queries launch the weighted kernels on the one bf16
    copy the estimator made (the same tensor every call)."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 0.5, (3000, 16)).astype(np.float32)
    nbr = NeighborSampler(x, gaussian(1.0), level1="hash", precision="bf16",
                          device=cuda)
    copy = nbr.hash_estimator.state.x_bf16
    assert copy.dtype == torch.bfloat16 and copy.is_cuda
    seen = []
    for name in ("weighted_kv_cuda", "weighted_kv_sum_cuda"):
        real = getattr(hk, name)

        def spy(q, xx, *a, _real=real, **kw):
            seen.append(xx.data_ptr())
            return _real(q, xx, *a, **kw)

        monkeypatch.setattr(hk, name, spy)
    nbr.sample(rng.integers(0, 3000, 500))
    nbr.walk(np.zeros(64, np.int64), 3)
    nbr.hash_estimator.query(x[:64])
    assert len(seen) == 5 and set(seen) == {copy.data_ptr()}


# (b, hq, hkv, sq, skv, dh): the reference's flash sweep, the (5, 37)
# offset case, rows with no valid key (negative offsets), head dim 128
# (over 48 KB of dynamic shared memory) with ragged tiles, head dims that
# are not a multiple of 16 bytes (the scalar-staged instance: 30, 7, and 100
# in bf16), and several query tiles over interior and diagonal key tiles
FLASH_SHAPES = [(2, 4, 2, 64, 64, 32), (1, 8, 2, 1, 300, 64),
                (2, 4, 4, 100, 228, 16), (1, 2, 1, 17, 17, 8),
                (1, 2, 1, 5, 37, 16), (1, 4, 2, 100, 40, 32),
                (1, 2, 2, 200, 17, 16), (1, 8, 2, 300, 300, 128),
                (2, 4, 1, 130, 77, 128), (1, 4, 2, 257, 257, 30),
                (1, 2, 1, 129, 300, 100), (1, 2, 2, 70, 70, 7),
                (1, 4, 1, 384, 384, 64)]
# (b, hq, hkv, S, dh, bk, stride, kv_valid): the serve driver's shape at
# an early and the last step, the S = 32768 production setting at yi's
# heads, a group of 32 (warps loop), dh not a multiple of 32, bk not a
# multiple of stride
LSE_SHAPES = [(4, 32, 4, 544, 128, 32, 4, 1), (4, 32, 4, 544, 128, 32, 4, 527),
              (1, 32, 4, 32768, 128, 256, 16, 32768),
              (2, 32, 1, 1024, 64, 128, 8, 700),
              (1, 6, 2, 480, 100, 96, 8, 300), (1, 4, 4, 240, 16, 30, 4, 200)]


def _randn(gen, shape, dev, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, shape, dtype):
    """The flash kernel (through ops: the reference's padding and offset,
    bq = bk = 64) vs the plain version on the same tensors moved to the
    CPU: out and lse at rtol 2e-4 / atol 1e-5 for f32 operands; a bf16 out
    within one bf16 step of the plain version's (both sum in f32 and round
    once), or within atol 1e-5 near zero; v is a transposed view, as the
    model hands it."""
    b, hq, hkv, sq, skv, dh = shape
    gen = torch.Generator(device=cuda).manual_seed(sq * 1000 + skv)
    q = _randn(gen, (b, hq, sq, dh), cuda, dtype)
    k = _randn(gen, (b, hkv, skv, dh), cuda, dtype)
    v = _randn(gen, (b, skv, hkv, dh), cuda, dtype).transpose(1, 2)
    fk.reset_launches()
    out, lse = fops.flash_attention(q, k, v, True, 64, 64, with_lse=True)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["flash_attention"] == 1
    want, want_lse = fops.flash_attention(q.cpu(), k.cpu(), v.cpu(), True,
                                          64, 64, with_lse=True)
    assert out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out.cpu(), want, rtol=RTOL, atol=ATOL)
    else:
        assert_bf16_close(out.cpu(), want, ATOL, "flash out")
    torch.testing.assert_close(lse.cpu(), want_lse, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_scalar_staging_on_unaligned_rows(cuda, dtype):
    """Operand rows that are not 16-byte aligned (k and v views one element
    into their storage) take the scalar-staged instance and still match the
    plain version (a bf16 out within one bf16 step); fresh copies take the
    cp.async instance."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(gen, (1, 4, 200, 64), cuda, dtype)
    kv = _randn(gen, (2, 2 * 200 * 64 + 1), cuda, dtype)
    k, v = (t[1:].view(1, 2, 200, 64) for t in kv)
    kw = dict(causal=True, scale=0.125, kv_valid=200, offset=0)
    assert fk.instantiation(q, k, v).endswith("scalar")
    assert fk.instantiation(q, k.clone(), v.clone()).endswith("cp.async")
    out, lse = fk.flash_attention_cuda(q, k, v, **kw)
    want, want_lse = fk.flash_attention_plain(q, k, v, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    else:
        assert_bf16_close(out, want, ATOL, "flash out")
    torch.testing.assert_close(lse, want_lse, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_flash_kernel_matches_plain_at_the_prefill_shape(cuda):
    """The prefill shape (1, 32, 8192, 128), 4 kv-heads, f32, v a
    transposed view: kernel vs plain version on the card, rtol 2e-4 /
    atol 1e-5 (out and lse)."""
    gen = torch.Generator(device=cuda).manual_seed(8192)
    q = _randn(gen, (1, 32, 8192, 128), cuda)
    k = _randn(gen, (1, 4, 8192, 128), cuda)
    v = _randn(gen, (1, 8192, 4, 128), cuda).transpose(1, 2)
    kp, vp, kw = fops.flash_args(q, k, v)
    assert fk.instantiation(q, kp, vp) == "float32 dh<=128 cp.async"
    out, lse = fk.flash_attention_cuda(q, kp, vp, **kw)
    want, want_lse = fk.flash_attention_plain(q, kp, vp, **kw)
    torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(lse, want_lse, rtol=RTOL, atol=ATOL)


#: (sq, skv, kv_valid, offset, causal): sq and skv off multiples of 16,
#: 64 and 128, kv_valid inside a key tile, rows with no valid key, and a
#: non-causal call
FLASH_BF16_CASES = [(77, 333, 333, 256, True), (200, 200, 137, 0, True),
                    (33, 515, 500, 482, True), (50, 90, 70, -20, True),
                    (65, 129, 100, 0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 48, 64, 96, 100, 128])
def test_flash_bf16_tensor_core_body(cuda, dh):
    """The bf16 body (tensor cores, p split into bf16 hi + lo) at every
    head-dim bucket, with cp.async staging and (dh 100: rows of 200 bytes)
    the scalar-staged instance, over ``FLASH_BF16_CASES``: out within one
    bf16 step of the plain version (atol 1e-5 near zero), lse at rtol 2e-4
    / atol 1e-5."""
    gen = torch.Generator(device=cuda).manual_seed(dh)
    for sq, skv, kv_valid, offset, causal in FLASH_BF16_CASES:
        q = _randn(gen, (1, 8, sq, dh), cuda, torch.bfloat16)
        k = _randn(gen, (1, 2, skv, dh), cuda, torch.bfloat16)
        v = _randn(gen, (1, 2, skv, dh), cuda, torch.bfloat16)
        kw = dict(causal=causal, scale=dh ** -0.5, kv_valid=kv_valid,
                  offset=offset)
        out, lse = fk.flash_attention_cuda(q, k, v, **kw)
        want, want_lse = fk.flash_attention_plain(q, k, v, **kw)
        assert_bf16_close(out, want, ATOL, f"dh {dh} sq {sq} skv {skv}")
        torch.testing.assert_close(lse, want_lse, rtol=RTOL, atol=ATOL)
    assert fk.instantiation(q, k, v).endswith(
        "scalar" if dh % 8 else "cp.async")


@pytest.mark.cuda
def test_flash_bf16_at_the_prefill_shape(cuda):
    """The bf16 prefill shape (1, 32, 8192, 128), 4 kv-heads, v a
    transposed view: the tensor-core body within one bf16 step of the
    plain version, lse at rtol 2e-4 / atol 1e-5."""
    gen = torch.Generator(device=cuda).manual_seed(8193)
    q = _randn(gen, (1, 32, 8192, 128), cuda, torch.bfloat16)
    k = _randn(gen, (1, 4, 8192, 128), cuda, torch.bfloat16)
    v = _randn(gen, (1, 8192, 4, 128), cuda, torch.bfloat16).transpose(1, 2)
    kp, vp, kw = fops.flash_args(q, k, v)
    assert fk.instantiation(q, kp, vp) == "bfloat16 dh<=128 cp.async"
    out, lse = fk.flash_attention_cuda(q, kp, vp, **kw)
    want, want_lse = fk.flash_attention_plain(q, kp, vp, **kw)
    assert_bf16_close(out, want, ATOL, "prefill shape")
    torch.testing.assert_close(lse, want_lse, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LSE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kde_decode_step1_matches_block_lse_plain(cuda, shape, dtype):
    """Step 1 of the fused decode kernel (its ``with_est`` estimates, one
    launch) vs block_lse_plain, q and the cache in f32 or bf16: rtol 2e-4 /
    atol 1e-5; blocks with no valid key come out at -1e30 exactly."""
    b, hq, hkv, s, dh, bk, stride, kv_valid = shape
    gen = torch.Generator(device=cuda).manual_seed(s + dh)
    q = _randn(gen, (b, hq, dh), cuda, dtype)
    k = _randn(gen, (b, hkv, s, dh), cuda, dtype, scale=0.3)
    v = _randn(gen, (b, hkv, s, dh), cuda, dtype)
    kk.reset_launches()
    _, got = kk.kde_decode_cuda(q, k, v, top_p=4, bk=bk, stride=stride,
                                kv_valid=kv_valid, with_est=True)
    torch.cuda.synchronize()
    assert kk.LAUNCHES["kde_decode"] == 1
    want = kk.block_lse_plain(q, k, scale=dh ** -0.5, stride=stride,
                              kv_valid=kv_valid, bk=bk)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    dead = -(-kv_valid // bk)
    assert bool((got[..., dead:] == -1e30).all())


# the reference's long_500k KDE decode cell (launch/dryrun.py): yi's heads,
# a 524,288-slot cache, top_p 16, bk 512, stride 16 (1,024 blocks)
LONG_500K = (1, 32, 4, 524288, 128, 512, 16, 524288)
#: (q dtype, cache dtype) of the bf16 instances
BF16_INSTANCES = [(torch.bfloat16, torch.bfloat16),
                  (torch.float32, torch.bfloat16),
                  (torch.bfloat16, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LSE_SHAPES + [LONG_500K])
@pytest.mark.parametrize("dtypes", BF16_INSTANCES)
def test_kde_decode_bf16_equals_f32_on_upcast_inputs(cuda, shape, dtypes):
    """A bf16 instance of the fused decode kernel equals the f32 instance
    on the upcast inputs, bitwise: out rounded to q's dtype, the f32
    estimates equal (the kernel upcasts where it loads a row and runs the
    f32 arithmetic after)."""
    b, hq, hkv, s, dh, bk, stride, kv_valid = shape
    top_p = 16 if s == LONG_500K[3] else 4
    gen = torch.Generator(device=cuda).manual_seed(7 * s + dh)
    q = _randn(gen, (b, hq, dh), cuda, dtypes[0])
    k = _randn(gen, (b, hkv, s, dh), cuda, dtypes[1], scale=0.3)
    v = _randn(gen, (b, hkv, s, dh), cuda, dtypes[1])
    kw = dict(top_p=top_p, bk=bk, stride=stride, with_est=True)
    for kv in sorted({kv_valid, max(1, kv_valid // 2 + 3)}):
        out, est = kk.kde_decode_cuda(q, k, v, kv_valid=kv, **kw)
        want, want_est = kk.kde_decode_cuda(q.float(), k.float(), v.float(),
                                            kv_valid=kv, **kw)
        assert out.dtype == q.dtype
        assert torch.equal(out, want.to(q.dtype)), (dtypes, kv)
        assert torch.equal(est, want_est), (dtypes, kv)
        assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_kde_decode_refuses_other_dtypes(cuda):
    """f16 operands, and k and v of different dtypes, are refused before
    any launch."""
    q = torch.zeros((1, 8, 64), device=cuda)
    k = torch.zeros((1, 2, 64, 64), device=cuda)
    kw = dict(top_p=2, bk=16, stride=4, kv_valid=64)
    kk.reset_launches()
    for args, match in (((q.half(), k, k), "float32 or bfloat16"),
                        ((q, k.half(), k.half()), "float32 or bfloat16"),
                        ((q, k.bfloat16(), k), "share a dtype"),
                        ((q.bfloat16(), k, k.bfloat16()), "share a dtype")):
        with pytest.raises(ValueError, match=match):
            kk.kde_decode_cuda(*args, **kw)
    assert kk.LAUNCHES["kde_decode"] == 0


@pytest.mark.cuda
def test_bf16_decode_step_launches_once_per_layer(cuda):
    """The reduced yi-6b as configured (bf16, cast_params, the default
    bf16 cache) on the card: a kde decode step is exactly one kde_decode
    launch a layer, with finite f32 logits; the bf16 prefill makes one
    flash launch a layer."""
    cfg = get_reduced("yi_6b")
    model = T.cast_params(T.init_params(cfg, seed=0, device=cuda),
                          torch.bfloat16)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))
    fk.reset_launches()
    with torch.inference_mode():
        T.forward(model, cfg, {"tokens": toks}, impl="flash")
    assert fk.LAUNCHES["flash_attention"] == cfg.num_layers
    cache = T.init_cache(cfg, 2, 64, device=cuda)
    assert cache["k"].dtype == torch.bfloat16
    step = make_decode_step(cfg, impl="kde",
                            kde_cfg={"top_p": 2, "bk": 16, "stride": 4})
    cur = torch.as_tensor(toks[:, :1], device=cuda)
    for pos in range(3):
        kk.reset_launches()
        nxt, logits, cache = step(model, cache, cur, pos)
        torch.cuda.synchronize()
        assert kk.LAUNCHES == {"kde_decode": cfg.num_layers}
        assert logits.dtype == torch.float32
        assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
        cur = nxt[:, None]


#: share of outputs allowed off the f64 product's bf16 rounding: an f32 sum
#: rounded once misses it only where the product lies within the f32 error
#: of a rounding midpoint (tools/gemv_reduction_probe.py prints the shares)
RN_MISS_SHARE = 0.01


def _rn_misses(got, x, w):
    """(max bf16 steps, share of outputs) off the float64 product x @ w
    rounded once to bf16."""
    want = (x.double() @ w.double()).to(torch.bfloat16)
    return (int(bf16_steps(got, want).max()),
            float((got != want).double().mean()))


def _gemv(x, w, reduced):
    """x @ w with cuBLAS's bf16 reduced-precision reduction on
    (``reduced``) or under ``layers.f32_accumulation``; the flag restored
    on exit."""
    from repro_torch.models import layers as TL
    mm = torch.backends.cuda.matmul
    before = mm.allow_bf16_reduced_precision_reduction
    if reduced:
        mm.allow_bf16_reduced_precision_reduction = True
        try:
            return x @ w
        finally:
            mm.allow_bf16_reduced_precision_reduction = before
    with TL.f32_accumulation():
        assert mm.allow_bf16_reduced_precision_reduction is False
        got = x @ w
    assert mm.allow_bf16_reduced_precision_reduction is before
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("kn", [(11008, 4096), (4096, 11008)])
def test_bf16_gemv_accumulates_in_f32(cuda, m, kn):
    """The decode GEMVs at yi-6b's widths (M = 1 and 4, K up to d_ff)
    under ``layers.f32_accumulation`` (the scope of forward and
    decode_step), positive operands: every output within one bf16 step of
    the float64 product rounded to bf16, and at most RN_MISS_SHARE of them
    off it, as an f32 sum rounded once.  (At these shapes cuBLAS gives the
    same bits with the flag on; the next test shows the limit catching a
    bf16 reduction where cuBLAS takes one.)"""
    k, n = kn
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.rand((m, k), generator=gen, device=cuda).bfloat16()
    w = torch.rand((k, n), generator=gen, device=cuda).bfloat16()
    steps, share = _rn_misses(_gemv(x, w, reduced=False), x, w)
    assert steps <= 1 and share <= RN_MISS_SHARE, (steps, share)


@pytest.mark.cuda
@pytest.mark.parametrize("m, n", [(64, 16), (64, 256), (256, 256)])
def test_bf16_reduction_shows_without_f32_accumulation(cuda, m, n):
    """The control of the test above: at K = 65,536 and few output tiles
    cuBLAS splits K, and with the reduced-precision flag on it sums the
    partials in bf16, so more than RN_MISS_SHARE of the outputs miss the
    float64 product's bf16 rounding (N(0, 1) operands: the partials
    cancel); under ``f32_accumulation`` the same product stays within
    it."""
    k = 65536
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    w = torch.randn((k, n), generator=gen, device=cuda).bfloat16()
    _, share = _rn_misses(_gemv(x, w, reduced=False), x, w)
    assert share <= RN_MISS_SHARE, share
    _, share = _rn_misses(_gemv(x, w, reduced=True), x, w)
    assert share > RN_MISS_SHARE, share


@pytest.mark.cuda
@pytest.mark.parametrize("kv_valid", [None, 3000])
def test_kde_attention_runs_on_the_kernel(cuda, kv_valid):
    """kde_attention on the card (one launch of the fused decode kernel) vs
    the plain-torch mirror on the same tensors, atol 2e-5 (the
    reference's)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, (2, 32, 128), cuda)
    k = _randn(gen, (2, 4, 8192, 128), cuda, scale=0.3)
    v = _randn(gen, (2, 4, 8192, 128), cuda)
    kw = dict(top_p=4, bk=256, stride=16, kv_valid=kv_valid)
    kk.reset_launches()
    got = kops.kde_attention(q, k, v, **kw)
    assert kk.LAUNCHES == {"kde_decode": 1}
    torch.testing.assert_close(got, kops.kde_attention_ref(q, k, v, **kw),
                               rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_reduced_lm_runs_on_the_kernels(cuda):
    """The reduced yi-6b on the card: forward with flash (one launch per
    layer) against xla at atol 1e-4; the serve driver with --attention kde
    launches the fused decode kernel once per layer and decode step, and
    nothing else of the KDE path."""
    cfg = dataclasses.replace(get_reduced("yi_6b"), dtype="float32")
    model = T.init_params(cfg, seed=0, device=cuda)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 200))
    fk.reset_launches()
    with torch.inference_mode():
        flash, _ = T.forward(model, cfg, {"tokens": toks}, impl="flash")
        xla, _ = T.forward(model, cfg, {"tokens": toks}, impl="xla")
    assert fk.LAUNCHES["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(flash, xla, rtol=0, atol=1e-4)
    args = serve.parser().parse_args(["--reduced", "--batch", "2",
                                      "--prompt-len", "40", "--gen", "5",
                                      "--attention", "kde"])
    kk.reset_launches()
    res = serve.run_lm(args)
    assert kk.LAUNCHES == {"kde_decode": cfg.num_layers * (40 + 5 - 1)}
    assert res["tokens"].shape == (2, 5)
    assert bool(torch.isfinite(res["prompt_logits"][:, :cfg.vocab_size])
                .all())


# (b, hq, hkv, S, dh, bk, stride, top_p): the serve shape, the S = 32768
# production setting at yi's heads, a 131072-key cache at the serve
# settings (4096 blocks), 68 (batch, kv-head) clusters (2 CTAs each) at S =
# 32768, groups of 1 and 32, dh not a multiple of 32, bk not a multiple of
# stride, top_p >= nb, one block
DECODE_SHAPES = [(4, 32, 4, 544, 128, 32, 4, 4),
                 (1, 32, 4, 32768, 128, 256, 16, 16),
                 (4, 32, 4, 131072, 128, 32, 4, 4),
                 (17, 32, 4, 32768, 128, 32, 4, 4),
                 (2, 4, 4, 1024, 64, 128, 8, 3), (2, 32, 1, 1024, 64, 128, 8, 2),
                 (1, 6, 2, 480, 100, 96, 8, 2), (1, 4, 4, 240, 16, 30, 4, 9),
                 (3, 8, 2, 64, 32, 64, 4, 2)]


def _decode_check(q, k, v, top_p, bk, stride, kv_valid):
    kw = dict(top_p=top_p, bk=bk, stride=stride, kv_valid=kv_valid)
    kk.reset_launches()
    out, est = kk.kde_decode_cuda(q, k, v, with_est=True, **kw)
    torch.cuda.synchronize()
    assert kk.LAUNCHES == {"kde_decode": 1}
    want, want_est = kk.kde_decode_plain(q, k, v, with_est=True, **kw)
    torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(est, want_est, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(est, kk.block_lse_plain(
        q, k, scale=q.shape[-1] ** -0.5, stride=stride, kv_valid=kv_valid,
        bk=bk), rtol=RTOL, atol=ATOL)
    dead = -(-kv_valid // bk)
    assert bool((est[..., dead:] == -1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_kde_decode_kernel_matches_plain(cuda, shape):
    """The fused decode kernel (out and its step-1 estimates) vs its plain
    version (the four-step torch pipeline) and block_lse_plain, rtol 2e-4 /
    atol 1e-5, at a full cache and a partial one; q and the cache are
    strided views, as the model hands them."""
    b, hq, hkv, s, dh, bk, stride, top_p = shape
    gen = torch.Generator(device=cuda).manual_seed(s + dh + top_p)
    q = _randn(gen, (b, 1, hq, dh), cuda)[:, 0]
    k = _randn(gen, (2, b, hkv, s, dh), cuda, scale=0.3)[1]
    v = _randn(gen, (2, b, hkv, s, dh), cuda)[0]
    for kv_valid in (s, max(1, s // 2 + 3)):
        _decode_check(q, k, v, top_p, bk, stride, kv_valid)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_valid", [1, 31, 32, 33, 527, 544])
def test_kde_decode_kernel_over_serve_steps(cuda, kv_valid):
    """The serve shape (yi's heads, cache 544, bk 32, stride 4, top_p 4)
    at the decode steps around block edges: fully-masked blocks tie at
    -1e30 and may be selected in any order without changing the output."""
    gen = torch.Generator(device=cuda).manual_seed(kv_valid)
    q = _randn(gen, (4, 32, 128), cuda)
    k = _randn(gen, (4, 4, 544, 128), cuda, scale=0.3)
    v = _randn(gen, (4, 4, 544, 128), cuda)
    _decode_check(q, k, v, 4, 32, 4, kv_valid)


@pytest.mark.cuda
@pytest.mark.parametrize("top_p", [1, 2])
def test_kde_decode_kernel_ties_go_to_the_lower_block(cuda, top_p):
    """Blocks 1, 3 and 5 hold the same keys (exact scores): the kernel's
    estimates tie bit for bit and the selection takes the lower block
    first, as the plain version's stable sort and lax.top_k do."""
    rng = np.random.default_rng(31)
    b, hkv, group, dh, bk = 1, 2, 4, 16, 16
    q = rng.integers(-2, 3, (b, hkv * group, dh)).astype(np.float32) / 2
    k = rng.integers(-2, 3, (b, hkv, 8 * bk, dh)).astype(np.float32) / 8
    v = rng.normal(0, 1, (b, hkv, 8 * bk, dh)).astype(np.float32)
    sign = np.sign(q.reshape(b, hkv, group, dh).sum(2))
    k[:, :, bk:2 * bk] += sign[:, :, None, :] / 2
    k[:, :, 3 * bk:4 * bk] = k[:, :, bk:2 * bk]
    k[:, :, 5 * bk:6 * bk] = k[:, :, bk:2 * bk]
    q, k, v = (torch.as_tensor(a, device=cuda) for a in (q, k, v))
    _, est = kk.kde_decode_cuda(q, k, v, top_p=top_p, bk=bk, stride=4,
                                kv_valid=8 * bk, with_est=True)
    assert bool((est[..., 1] == est[..., 3]).all())
    assert bool((est[..., 1] == est[..., 5]).all())
    _decode_check(q, k, v, top_p, bk, 4, 8 * bk)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [DECODE_SHAPES[i] for i in (0, 1, 2, 4, 7)])
@pytest.mark.parametrize("kernel", ["cluster", "spread"])
def test_kde_decode_either_kernel_matches_plain(cuda, shape, kernel):
    """Each of the two kernels, forced past the plan's choice (the cluster
    kernel at the serve shape, the spread kernel at batch 1), against the
    plain pipeline at a full and a partial cache, rtol 2e-4 / atol 1e-5."""
    b, hq, hkv, s, dh, bk, stride, top_p = shape
    gen = torch.Generator(device=cuda).manual_seed(s + 3 * dh)
    q = _randn(gen, (b, hq, dh), cuda)
    k = _randn(gen, (b, hkv, s, dh), cuda, scale=0.3)
    v = _randn(gen, (b, hkv, s, dh), cuda)
    grid = kk.decode_grid(q, k, v, top_p=top_p, bk=bk, stride=stride,
                          kernel=kernel)
    assert grid["kernel"] == kernel
    for kv_valid in (s, max(1, s // 2 + 3)):
        kw = dict(top_p=top_p, bk=bk, stride=stride, kv_valid=kv_valid)
        out, est = kk.kde_decode_cuda(q, k, v, with_est=True, kernel=kernel,
                                      **kw)
        want, want_est = kk.kde_decode_plain(q, k, v, with_est=True, **kw)
        torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(est, want_est, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [131072, 524288])
def test_kde_decode_long_500k_settings_at_slice_boundaries(cuda, s):
    """The long_500k settings (yi's heads, bk 512, stride 16, top_p 16) on
    one layer's bf16 cache: the spread kernel over every SM's worth of
    CTAs, kv_valid at a CTA's slice boundary and one key either side, and
    (S = 131072) top_p >= the block count.  est against the plain pipeline
    at rtol 2e-4 / atol 1e-5, out within one bf16 step of it, and both
    bitwise the f32 instance's on the upcast inputs."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    q = _randn(gen, (1, 32, 128), cuda, torch.bfloat16)
    k = _randn(gen, (1, 4, s, 128), cuda, torch.bfloat16)
    v = _randn(gen, (1, 4, s, 128), cuda, torch.bfloat16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    nb = s // 512
    for top_p in (16, nb) if s == 131072 else (16,):
        grid = kk.decode_grid(q, k, v, top_p=top_p, bk=512, stride=16)
        assert grid["kernel"] == "spread"
        assert grid["ctas"] == min(sms // 4, 128) * 4
        edge = grid["blocks_per_cta"] * 512
        for kv_valid in (edge - 1, edge, edge + 1, s):
            kw = dict(top_p=top_p, bk=512, stride=16, kv_valid=kv_valid)
            out, est = kk.kde_decode_cuda(q, k, v, with_est=True, **kw)
            o32, e32 = kk.kde_decode_cuda(q.float(), k.float(), v.float(),
                                          with_est=True, **kw)
            assert torch.equal(out, o32.to(torch.bfloat16)), kv_valid
            assert torch.equal(est, e32), kv_valid
            want, want_est = kk.kde_decode_plain(q, k, v, with_est=True,
                                                 **kw)
            torch.testing.assert_close(est, want_est, rtol=RTOL, atol=ATOL)
            assert_bf16_close(out, want, ATOL, f"S {s} kv {kv_valid}")
            dead = -(-kv_valid // 512)
            assert bool((est[..., dead:] == -1e30).all())


@pytest.mark.cuda
def test_kde_decode_refuses_a_cache_too_long_for_a_cluster(cuda):
    """A cache whose per-block shared memory exceeds a cluster of 8 CTAs
    (2^20 keys in blocks of 32 at a group of 8) is refused by the cluster
    kernel's plan, before any launch, and runs on the spread kernel, which
    the plan takes for it; past the spread kernel's shared memory (2^25
    keys here) the plan refuses the cache.  The caches are stride-0
    views."""
    q = torch.zeros((1, 32, 128), device=cuda)

    def cache(s):
        return torch.zeros((1, 4, 1, 128), device=cuda).expand(1, 4, s, 128)

    kw = dict(top_p=4, bk=32, stride=4)
    for s, fits in ((1 << 19, True), (1 << 20, False)):
        kk.reset_launches()
        if fits:
            out = kk.kde_decode_cuda(q, cache(s), cache(s), kv_valid=s,
                                     kernel="cluster", **kw)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(out).all())
            assert kk.LAUNCHES["kde_decode"] == 1
        else:
            with pytest.raises(ValueError, match="do not fit"):
                kk.kde_decode_cuda(q, cache(s), cache(s), kv_valid=s,
                                   kernel="cluster", **kw)
            assert kk.LAUNCHES["kde_decode"] == 0
    k = cache(1 << 20)
    assert kk.decode_grid(q, k, k, **kw)["kernel"] == "spread"
    out = kk.kde_decode_cuda(q, k, k, kv_valid=1 << 20, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    kk.reset_launches()
    with pytest.raises(ValueError, match="do not fit"):
        kk.kde_decode_cuda(q, cache(1 << 25), cache(1 << 25),
                           kv_valid=1 << 25, **kw)
    assert kk.LAUNCHES["kde_decode"] == 0


@pytest.mark.cuda
def test_kde_decode_runs_a_million_key_cache_against_plain(cuda):
    """2^20 keys in blocks of 32 (past the cluster kernel's shared memory;
    the reference takes any length): the plan's kernel against the plain
    pipeline at a full and a partial cache, out and est at rtol 2e-4 /
    atol 1e-5."""
    s = 1 << 20
    gen = torch.Generator(device=cuda).manual_seed(20)
    q = _randn(gen, (1, 32, 128), cuda)
    k = _randn(gen, (1, 4, s, 128), cuda, scale=0.3)
    v = _randn(gen, (1, 4, s, 128), cuda)
    for kv_valid in (s, s // 2 + 5):
        _decode_check(q, k, v, 4, 32, 4, kv_valid)


def _off_boundaries(bs, u, tie=1e-5):
    """Rows whose block uniform lies farther than ``tie`` from every
    cumulative boundary of their sums: sums taken in another order draw
    the same block there."""
    c = torch.cumsum(bs.double(), dim=1)
    tot = c[:, -1:]
    return ~((u.double()[:, None] * tot - c).abs() <= tie * tot).any(dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gaussian", "laplacian"])
def test_stratified_fused_sample_on_the_card(cuda, kind):
    """The stratified depth-2 step on the card (its cross term a cuBLAS
    GEMM in IEEE f32) against the CPU plain path with the same noise, at a
    ragged n: level-1 sums at rtol 2e-4 / atol 1e-5 and counter words
    equal; neighbors equal and probabilities at rtol 2e-4 on every row
    whose block uniform is not within 1e-5 of a boundary."""
    gen = torch.Generator().manual_seed(17)
    n, d, bs, w = 65536 + 300, 16, 256, 1024
    nb = -(-n // bs)
    x = torch.randn(n, d, generator=gen) * 0.5
    src = torch.randint(0, n, (w,), generator=gen)
    noise = sops.draw_sample_noise(w, nb, gen, "cpu", exact=False,
                                   block_size=bs)
    inv = 1.0 / (0.3 * d) if kind == "laplacian" else 1.0 / (0.5 * d ** 0.5)
    cfg = dict(kind=kind, inv_bw=inv, beta=1.0, pairwise=None,
               block_size=bs, num_blocks=nb, n=n, s=16, exact=False)
    want = sops.fused_sample(x, (x * x).sum(-1), src, *noise, **cfg)
    xc = x.to(cuda)
    got = sops.fused_sample(xc, (xc * xc).sum(-1), src.to(cuda),
                            *[a.to(cuda) for a in noise], **cfg)
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=RTOL, atol=ATOL)
    assert torch.equal(got[3].cpu(), want[3])
    keep = _off_boundaries(want[2], noise[1])
    assert int(keep.sum()) > 0.98 * w
    assert torch.equal(got[0].cpu()[keep], want[0][keep])
    torch.testing.assert_close(got[1].cpu()[keep], want[1][keep], rtol=RTOL,
                               atol=0.0)


@pytest.mark.cuda
def test_rskde_query_through_the_rowsum_kernel(cuda):
    """``RSKDE`` on the card reads the rows the CPU twin reads (one numpy
    generator a seed) and reduces them through the rowsum kernel, one
    launch a query: the plain version's answers at rtol 2e-4 / atol 1e-5,
    at the rs row norms' shape (1024 queries, 80 rows, d = 784)."""
    x = np.random.default_rng(0).uniform(size=(4096, 784)).astype(
        np.float32)
    ker = laplacian(0.3 * 784)
    card = RSKDE(x, ker, 80, seed=3, device=cuda)
    plain = RSKDE(x, ker, 80, seed=3, device="cpu")
    y = torch.as_tensor(x[:1024])
    before = rk.LAUNCHES["rowsum"]
    for _ in range(2):
        torch.testing.assert_close(card.query(y).cpu(), plain.query(y),
                                   rtol=RTOL, atol=ATOL)
    assert rk.LAUNCHES["rowsum"] - before == 2
    assert card.evals == plain.evals == 2 * 1024 * 80


@pytest.mark.cuda
def test_sample_exact_on_the_card(cuda):
    """The Theorem 4.12 rounds on the card against the CPU plain path, on
    the same cached stratified sums and noise: the counter words' evals
    and draws equal, at most 0.1% of the rows differ (a proposal or an
    accept test at a near-tie of sums taken in another order) and the
    fallback counts by no more than that; ``NeighborSampler.sample_exact``
    runs on the card on a stratified sampler."""
    gen = torch.Generator().manual_seed(23)
    n, d, bs, w, rounds = 20000 + 17, 8, 128, 2048, 8
    nb = -(-n // bs)
    x = torch.randn(n, d, generator=gen) * 0.5
    src = torch.randint(0, n, (w,), generator=gen)
    cfg = dict(kind="gaussian", inv_bw=1.0, beta=1.0, pairwise=None,
               block_size=bs, n=n)
    sums, _ = sops.masked_block_sums(
        x, (x * x).sum(-1), src, torch.rand((nb, bs), generator=gen),
        num_blocks=nb, s=16, exact=False, **cfg)
    noise = sops.draw_exact_noise(w, rounds, gen, "cpu")
    want = sops.fused_sample_exact(x, (x * x).sum(-1), src, sums, *noise,
                                   rounds=rounds, slack=2.0, **cfg)
    xc = x.to(cuda)
    got = sops.fused_sample_exact(xc, (xc * xc).sum(-1), src.to(cuda),
                                  sums.to(cuda),
                                  *[a.to(cuda) for a in noise],
                                  rounds=rounds, slack=2.0, **cfg)
    differ = int((got[0].cpu() != want[0]).sum())
    assert differ <= w // 1000, differ
    assert torch.equal(got[1].cpu()[1:4], want[1][1:4])
    assert abs(int(got[2]) - int(want[2])) <= differ
    nbr = NeighborSampler(x, gaussian(1.0), seed=1, device=cuda)
    v = nbr.sample_exact(src.numpy(), rounds=rounds, slack=2.0)
    assert v.shape == (w,) and np.all(v != src.numpy())
    assert np.all((v >= 0) & (v < n)) and nbr.exact_draws == w


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gaussian", "laplacian"])
def test_incidence_row_norms_on_the_card(cuda, kind):
    """``incidence_row_norms`` builds its kernel matrix on the card by
    default, from a numpy array or a CUDA tensor: the CPU result at rtol
    2e-4 / atol 1e-5."""
    x = np.random.default_rng(5).normal(size=(300, 16)).astype(np.float32)
    ker = laplacian(0.3 * 16) if kind == "laplacian" else gaussian(2.0)
    want = incidence_row_norms(ker, x, device="cpu")
    for arg in (x, torch.as_tensor(x, device=cuda)):
        np.testing.assert_allclose(incidence_row_norms(ker, arg), want,
                                   rtol=RTOL, atol=ATOL)


#: the graph phase's reads: (exact level-1, level1, rejection rounds) and
#: the launches one walk step and one triangle scan make
GRAPH_READS = {
    "sample_block_step": ((True, "blocked", 0), {"sample_block": 1},
                          {"masked_blocksum": 1}),
    "masked_blocksum_exact_step": ((True, "blocked", 4),
                                   {"masked_blocksum": 1},
                                   {"masked_blocksum": 1}),
    "hashed_step": ((False, "hash", 0), {"weighted_kv": 1},
                    {"weighted_kv": 1}),
}


def _launched(fn):
    """(fn's result, the kernel launches it made, zeros left out)."""
    for mod in (rk, sk, hk):
        mod.reset_launches()
    out = fn()
    counts = {**rk.LAUNCHES, **sk.LAUNCHES, **hk.LAUNCHES}
    return out, {k: v for k, v in counts.items() if v}


@pytest.mark.cuda
@pytest.mark.parametrize("read", sorted(GRAPH_READS))
def test_graph_step_and_triangle_scan_on_the_card(cuda, read):
    """One walk step and one ``triangle_edge_scan`` on the card against
    the CPU plain path with the same noise, on the graph phase's reads:
    the launches ``chip_smoke.py`` asserts (one sample-block launch an
    exact-block step, one masked-blocksum launch an exact step with
    rejection rounds or an exact triangle scan, one weighted-kv launch a
    hashed read), counter words equal, at most 0.1% of the walkers (and of
    the triangle rows) off the plain version's draws -- a near-tie of
    sums taken in another order -- and the oriented pairs equal."""
    (exact, level1, rounds), step_launches, tri_launches = GRAPH_READS[read]
    gen = torch.Generator().manual_seed(29)
    n, d, bs, w, m, draws, nf = 20000 + 17, 16, 128, 2048, 1024, 8, 2
    nb = -(-n // bs)
    x = torch.randn(n, d, generator=gen) * 0.5
    starts = torch.randint(0, n, (w,), generator=gen)
    states = {}
    if level1 == "hash":
        states = {dev: hops.build_hash_state(x, gaussian(1.0), max_bucket=64,
                                             seed=11, device=dev)[0]
                  for dev in ("cpu", cuda)}
    cfg = dict(kind="gaussian", inv_bw=1.0, beta=1.0, pairwise=None,
               block_size=bs, num_blocks=nb, n=n, s=16, exact=exact,
               level1=level1, num_far=nf)
    noise = sops.draw_walk_noise(1, w, nb, gen, "cpu", n=n, rounds=rounds,
                                 exact=exact, level1=level1, num_far=nf,
                                 block_size=bs, s=16)
    want = sops.walk_scan(x, (x * x).sum(-1), starts, noise,
                          states.get("cpu"), rounds=rounds, slack=2.0, **cfg)
    xc = x.to(cuda)
    noise_c = (None, [tuple(None if a is None else a.to(cuda)
                            for a in noise[1][0])])
    got, counts = _launched(lambda: sops.walk_scan(
        xc, (xc * xc).sum(-1), starts.to(cuda), noise_c, states.get(cuda),
        rounds=rounds, slack=2.0, **cfg))
    assert counts == step_launches, counts
    assert int((got[0].cpu() != want[0]).sum()) <= w // 1000
    assert torch.equal(got[2].cpu()[1:4], want[2][1:4])
    assert abs(int(got[3]) - int(want[3])) <= w // 1000

    u = torch.randint(0, n, (m,), generator=gen)
    v = (u + 1 + torch.randint(0, n - 1, (m,), generator=gen)) % n
    degs = torch.rand(n, generator=gen) * 50.0 + 1.0
    l1 = sops._level1_noise(m, nb, gen, "cpu", level1=level1, exact=exact,
                            num_far=nf, block_size=bs)
    tri = (l1, torch.rand((draws, m), generator=gen),
           torch.rand((draws, m), generator=gen))
    want = sops.triangle_edge_scan(x, (x * x).sum(-1), u, v, degs, tri,
                                   states.get("cpu"), **cfg)
    got, counts = _launched(lambda: sops.triangle_edge_scan(
        xc, (xc * xc).sum(-1), u.to(cuda), v.to(cuda), degs.to(cuda),
        tuple(None if a is None else a.to(cuda) for a in tri),
        states.get(cuda), **cfg))
    assert counts == tri_launches, counts
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    off = ~torch.isclose(got[2].cpu(), want[2], rtol=RTOL, atol=1e-7)
    assert int(off.sum()) <= m // 1000 + 1, int(off.sum())
    assert torch.equal(got[3].cpu()[1:4], want[3][1:4])


# --------------------------------------------------------------------- #
# streaming (DESIGN.md §12): dead slots in the middle of the data and the
# hashed overflow region
# --------------------------------------------------------------------- #
def _dead_mid(n, d, dev, seed=0):
    """A ``DynamicDataset`` of n rows (capacity n + 100) whose deleted
    slots sit in the middle: the whole block [512, 768) at bn 256 and
    every 17th row elsewhere; returns (dataset, dead mask)."""
    from repro_torch.core.dataset import DynamicDataset
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=gen) * 0.4
    ds = DynamicDataset(x, capacity=n + 100, device=dev)
    dead = np.union1d(np.arange(512, 768), np.arange(3, n, 17))
    ds.delete_rows(dead)
    return ds, torch.as_tensor(~ds.live_host, device=dev)


def _live_queries(ds, m):
    """m queries near live rows (each row plus N(0, 0.05^2) noise, so no
    pair is a point against itself: there the exponential kind's sqrt of
    the cancelled d2 differs between any two summation orders) and the
    rows' slots."""
    idx = torch.as_tensor(ds.live_slots()[::7][:m].astype(np.int64),
                          device=ds.device)
    gen = torch.Generator(device=ds.device).manual_seed(m)
    q = ds.x_pad[idx] + 0.05 * torch.randn(
        (m, ds.d), generator=gen, device=ds.device)
    return q.contiguous(), idx


def _dead_slot_checks(ds, dead, kind, precision, bn=256):
    """Every rowsum / blocksum / sampler kernel on queries near live rows
    against ``ds.x_pad``: dead columns give exactly 0 (one-column
    blocksums), no
    output is NaN, a block of dead slots sums to exactly 0 (masked: the
    floor) and is never drawn, and each kernel equals its plain version
    (bf16: within the flip slack of the live pairs)."""
    x = ds.x_pad
    q, idx = _live_queries(ds, 130)
    inv_bw = 1.5 / q.shape[1] ** 0.5 if kind != "laplacian" else 0.5
    args = (kind, inv_bw, 0.7)
    bf16 = precision == "bf16"
    slack = None
    if bf16:
        slack = torch.where(dead[None, :], 0.0, torch.nan_to_num(
            sref.bf16_flip_slack(q, x, kind, inv_bw), nan=0.0))
    close = ((lambda got, want, s: _bf16_close(got, want, s)) if bf16 else
             (lambda got, want, s: torch.testing.assert_close(
                 got, want, rtol=RTOL, atol=ATOL)))
    cols = rk.blocksum_cuda(q, x, *args, 1, precision)
    assert bool(torch.isfinite(cols).all())
    assert float(cols[:, dead].abs().max()) == 0.0
    close(cols, rk.blocksum_plain(q, x, *args, 1, precision), slack)
    rows = rk.rowsum_cuda(q, x, *args, precision)
    assert bool(torch.isfinite(rows).all())
    close(rows, rk.rowsum_plain(q, x, *args, precision),
          None if slack is None else slack.sum(1))
    bslack = None if slack is None else torch.nn.functional.pad(
        slack, (0, -x.shape[0] % bn)).view(q.shape[0], -1, bn).sum(-1)
    bsum = rk.blocksum_cuda(q, x, *args, bn, precision)
    assert float(bsum[:, 2].abs().max()) == 0.0        # the dead block
    close(bsum, rk.blocksum_plain(q, x, *args, bn, precision), bslack)
    own = idx // bn
    msum = sk.masked_blocksum_cuda(q, x, own, *args, bn, precision)
    assert bool(torch.isfinite(msum).all())
    floor = torch.tensor(sref.BLOCK_SUM_FLOOR, dtype=torch.float32)
    assert torch.equal(msum[:, 2].cpu(), floor.expand(q.shape[0]))
    close(msum, sk.masked_blocksum_plain(q, x, own, *args, bn, precision),
          bslack)
    g = gumbel(msum.shape, torch.Generator(device=x.device).manual_seed(1),
               x.device)
    blk, pb, tot, bs = sk.sample_block_cuda(q, x, own, g, *args, bn,
                                            precision)
    assert not bool((blk == 2).any()) and bool(torch.isfinite(pb).all())
    close(bs, msum, bslack)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 19, 32, 36])
@pytest.mark.parametrize("kind", KINDS)
def test_dead_slots_in_the_middle_give_zero_mass(cuda, kind, d):
    """Deleted slots (the sentinel: +1e30 in every coordinate, squared
    norm inf) in the middle of the data and of a block, in every tile of
    the f32 kernels: the wide tile (d = 8, 16, 32), the generic one (d =
    19) and the deep one (d = 36)."""
    ds, dead = _dead_mid(3000, d, cuda)
    _dead_slot_checks(ds, dead, kind, "f32")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 19, 32, 36])
@pytest.mark.parametrize("kind", L2_KINDS)
def test_dead_slots_in_the_middle_give_zero_mass_bf16(cuda, kind, d):
    """The same in the bf16 instances: the tensor-core tile (d = 8, 16,
    32), the generic and deep bf16 tiles (d = 19, 36); the exp table's
    read at -inf is exactly 0."""
    ds, dead = _dead_mid(3000, d, cuda, seed=1)
    _dead_slot_checks(ds, dead, kind, "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_weighted_kv_at_the_overflow_width(cuda, precision):
    """The weighted kernels at a streaming hash state's width (t = 256
    NEAR slots + a 4,301-column overflow region + 64 FAR, the streaming
    phase's capacity): against their plain versions, with columns on dead
    slots in the middle reading exactly 0 (f32 rows, and the bf16 copy)."""
    ds, dead = _dead_mid(275313 - 100, 8, cuda, seed=2)
    x = ds.x_pad
    gen = torch.Generator(device=cuda).manual_seed(4)
    m, t = 64, 256 + 4301 + 64
    q, _ = _live_queries(ds, m)
    cols = torch.randint(0, x.shape[0], (m, t), generator=gen,
                         dtype=torch.int32, device=cuda)
    wgt = torch.rand((m, t), generator=gen, device=cuda) * 64.0
    rows = x if precision == "f32" else \
        sref.round_bf16(x).to(torch.bfloat16)
    for name in ("weighted_kv", "weighted_kv_sum"):
        args = (q, rows, cols, wgt, "gaussian", 1.0, 1.0)
        got = getattr(hk, name + "_cuda")(*args, precision=precision)
        want = getattr(hk, name + "_plain")(*args, precision=precision)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=RTOL,
                                   atol=1e-6 * float(want.abs().max()))
        if name == "weighted_kv":
            assert float(got[dead[cols.long()]].abs().max()) == 0.0


@pytest.mark.cuda
def test_bf16_streaming_hash_copy_follows_updates(cuda):
    """A bf16 streaming hash estimator after updates, deletes and
    inserts: its bf16 copy equals the rounded current rows bitwise, and a
    query through the kernel equals the same query on a freshly rounded
    copy, bitwise (a stale copy would read the moved rows' old
    coordinates)."""
    from repro_torch.core.dataset import DynamicDataset
    from repro_torch.core.kde.hashed import HashedKDE
    gen = torch.Generator().manual_seed(5)
    x0 = torch.randn(4096, 16, generator=gen) * 0.5
    ds = DynamicDataset(x0, capacity=4500, device=cuda)
    est = HashedKDE(None, gaussian(1.0), seed=3, dataset=ds,
                    precision="bf16")
    ds.update_rows(np.arange(0, 400, 2), (x0[1:401:2] + 0.3).numpy())
    ds.delete_rows(np.arange(1000, 1100))
    ds.insert_rows((x0[:50] - 0.2).numpy())
    y = ds.x_pad[:64].contiguous()
    hk.reset_launches()
    est.query(y)
    assert hk.LAUNCHES["weighted_kv_sum_bf16"] == 1
    fresh = sref.round_bf16(ds.x_pad).to(torch.bfloat16)
    assert torch.equal(est.state.x_bf16.view(torch.int16),
                       fresh.view(torch.int16))
    fidx = torch.randint(0, ds.n, (64, 64), generator=torch.Generator(
        device=cuda).manual_seed(6), dtype=torch.int32, device=cuda)
    cfg = {k: v for k, v in est._cfg.items() if k != "pairwise"}
    a, _, _ = hops.hashed_query(ds.x_pad, y, est.state, fidx, **cfg)
    b, _, _ = hops.hashed_query(ds.x_pad, y,
                                est.state._replace(x_bf16=fresh), fidx,
                                **cfg)
    assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# the tenant axis of the level-1 kernels (the serving layer's groups)
# --------------------------------------------------------------------- #
TENANT_KERNELS = {
    "sample_block": (sk.sample_block_cuda, sk.tile_rows),
    "masked_blocksum": (sk.masked_blocksum_cuda, sk.tile_rows),
    "blocksum": (rk.blocksum_cuda, rk.blocksum_tile_rows),
}


def _tenant_inputs(dev, tenants, d, n=3000, bn=256, seed=0):
    """A (T, n, d) arena and ragged tenant runs of query rows (tenant t
    has 37 + 61 t rows, interleaved), with own blocks and Gumbel noise."""
    gen = torch.Generator(device=dev).manual_seed(seed * 100 + d)
    xa = torch.randn(tenants, n, d, generator=gen, device=dev) * 0.4
    t = np.concatenate([np.full(37 + 61 * i, i) for i in range(tenants)])
    t = np.random.default_rng(seed).permutation(t)
    src = torch.randint(0, n, (len(t),), generator=gen, device=dev)
    q = xa[torch.as_tensor(t, device=dev), src]
    nb = -(-n // bn)
    return xa, t, q, src // bn, gumbel((len(t), nb), gen, dev), bn


def _tenant_call(name, xa, t, q, own, g, bn):
    fn, rows = TENANT_KERNELS[name]
    extra = {"sample_block": (own, g), "masked_blocksum": (own,),
             "blocksum": ()}[name]
    return sops.tenant_launch(fn, q, xa, torch.as_tensor(t), *extra,
                              bm=rows(xa.shape[2]), kind="gaussian",
                              inv_bw=1.0, beta=1.0, bn=bn), extra


@pytest.mark.cuda
@pytest.mark.parametrize("tenants", [1, 2, 4])
@pytest.mark.parametrize("d", [8, 19, 36])
@pytest.mark.parametrize("name", sorted(TENANT_KERNELS))
def test_tenant_axis_equals_per_tenant_launches(cuda, name, d, tenants):
    """One tenant-axis launch over ragged tenant runs is bitwise the
    launches on each tenant's rows alone (d 8: the wide tile; 19: the
    generic tile; 36: blocksum's deep tile), and within phase 2's
    tolerances of the plain version on the same operands."""
    xa, t, q, own, g, bn = _tenant_inputs(cuda, tenants, d)
    fn, rows = TENANT_KERNELS[name]
    got, extra = _tenant_call(name, xa, t, q, own, g, bn)
    got = got if isinstance(got, tuple) else (got,)
    for ti in range(tenants):
        idx = torch.as_tensor(np.where(t == ti)[0], device=cuda)
        want = fn(q[idx], xa[ti], *[a[idx] for a in extra], "gaussian",
                  1.0, 1.0, bn)
        for a, b in zip(got, want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a[idx], b), (name, ti)
    plain = {"sample_block": sk.sample_block_plain,
             "masked_blocksum": sk.masked_blocksum_plain,
             "blocksum": rk.blocksum_plain}[name]
    want = sops.tenant_launch(plain, q, xa, torch.as_tensor(t), *extra,
                              bm=rows(d), kind="gaussian", inv_bw=1.0,
                              beta=1.0, bn=bn)
    if name == "sample_block":
        # the sums and totals against plain, the draws except at near
        # ties, p_blk the kernel's own sum of the drawn block over its own
        # total (the ratio of two values each within rtol of plain may
        # differ from plain's ratio by twice that)
        blk, pb, tot, bs = got
        torch.testing.assert_close(bs, want[3], rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(tot, want[2], rtol=RTOL, atol=ATOL)
        top2 = torch.topk(torch.log(want[3]) + g, 2, dim=1).values
        assert bool(((blk == want[0]) | (top2[:, 0] - top2[:, 1] <= 1e-5))
                    .all())
        torch.testing.assert_close(
            pb, torch.gather(bs, 1, blk[:, None])[:, 0] / tot, rtol=1e-6,
            atol=0.0)
    else:
        torch.testing.assert_close(got[0], want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TENANT_KERNELS))
def test_tenant_axis_group_is_one_launch(cuda, name):
    """A tenant-axis call over 4 tenants is one kernel launch (the
    wrapper's count and the profiler's kernel events)."""
    from repro_torch.kernels.profiling import device_kernels
    xa, t, q, own, g, bn = _tenant_inputs(cuda, 4, 16)
    mod = sk if name != "blocksum" else rk
    mod.reset_launches()
    _tenant_call(name, xa, t, q, own, g, bn)
    assert mod.LAUNCHES[name] == 1
    ks = device_kernels(lambda: _tenant_call(name, xa, t, q, own, g, bn), 4)
    tag = "sampler_" if name != "blocksum" else "blocksum"
    assert sum(c for k, (c, _) in ks.items() if tag in k) == 4, ks


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TENANT_KERNELS))
def test_null_offset_launch_is_the_single_dataset_launch(cuda, name):
    """A launch without ``tile_base`` is the single-dataset launch: equal
    to a one-tenant arena launch with every offset 0, and to itself."""
    fn, rows = TENANT_KERNELS[name]
    xa, t, q, own, g, bn = _tenant_inputs(cuda, 1, 16)
    extra = {"sample_block": (own, g), "masked_blocksum": (own,),
             "blocksum": ()}[name]
    one = fn(q, xa[0], *extra, "gaussian", 1.0, 1.0, bn)
    tiles = -(-q.shape[0] // rows(16))
    zero = torch.zeros(tiles, dtype=torch.int32, device=cuda)
    axis = fn(q, xa, *extra, "gaussian", 1.0, 1.0, bn, tile_base=zero)
    again = fn(q, xa[0], *extra, "gaussian", 1.0, 1.0, bn)
    for a, b, c in zip(*(o if isinstance(o, tuple) else (o,)
                         for o in (one, axis, again))):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_tenant_axis_sample_block_on_two_streams_at_once(cuda):
    """Two streams launching tenant-axis sample-block groups concurrently:
    each stream's arrival counters cover its own groups' tiles, so every
    draw and sum equals the stream's first launch bitwise and the plain
    version within tolerance."""
    calls = [_tenant_inputs(cuda, 3, 16, seed=s) for s in (1, 2)]
    wants = [_tenant_call("sample_block", *c)[0] for c in calls]
    plains = [sops.tenant_launch(sk.sample_block_plain, c[2], c[0],
                                 torch.as_tensor(c[1]), c[3], c[4],
                                 bm=sk.tile_rows(16), kind="gaussian",
                                 inv_bw=1.0, beta=1.0, bn=c[5])
              for c in calls]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    gots = [[], []]
    for _ in range(8):
        for i, (st, c) in enumerate(zip(streams, calls)):
            with torch.cuda.stream(st):
                gots[i].append(_tenant_call("sample_block", *c)[0])
    torch.cuda.synchronize()
    for got, want, plain, c in zip(gots, wants, plains, calls):
        _assert_sample_block(want, plain, c[4])
        for gt in got:
            for a, b in zip(gt, want):
                assert torch.equal(a, b)


@pytest.mark.cuda
def test_served_group_launches_each_kernel_once(cuda):
    """A tick of three exact tenants (one sample, query, walk and prob_of
    request each) is one group an op, and each group launches its
    tenant-axis kernel once (the walk once a step); every request is
    served and each sample equals the single-request program on its
    noise."""
    from repro_torch.core.serving import KernelGraphServable, _host_gen
    srv = KernelGraphServable(device=cuda)
    rng = np.random.default_rng(0)
    for i in range(3):
        srv.add_tenant(f"t{i}", rng.normal(0, 0.5, (4096, 16)).astype(
            np.float32) + 0.2 * i, gaussian(1.0), block_size=256,
            exact_blocks=True, seed=i)
    reqs = []
    for i in range(3):
        reqs.append(srv.submit(f"t{i}", "sample", seed=10 + i,
                               src=rng.integers(0, 4096, 16)))
        srv.submit(f"t{i}", "query", seed=20 + i,
                   y=rng.normal(0, 0.5, (8, 16)).astype(np.float32))
        srv.submit(f"t{i}", "walk", seed=30 + i, length=3,
                   starts=rng.integers(0, 4096, 8))
        srv.submit(f"t{i}", "prob_of", seed=40 + i,
                   src=rng.integers(0, 4096, 16),
                   dst=rng.integers(0, 4096, 16))
    sk.reset_launches()
    rk.reset_launches()
    st = srv.tick()
    assert st["failed"] == 0 and st["groups"] == 4, st
    assert (sk.LAUNCHES["sample_block"], sk.LAUNCHES["masked_blocksum"],
            rk.LAUNCHES["blocksum"]) == (1 + 3, 1, 1)
    for r in reqs:
        nbr = srv.tenant(r.tenant).nbr
        noise = tuple(u.to(cuda) for u in sops.draw_sample_noise(
            16, nbr.num_blocks, _host_gen(r.seed), "cpu",
            **nbr._noise_cfg))
        nb, p, _, _ = sops.fused_sample(
            nbr.x, nbr.x_sq, torch.as_tensor(r.payload["src"], device=cuda),
            *noise, **nbr._cfg)
        assert np.array_equal(nb.cpu().numpy(), r.result[0])
        np.testing.assert_allclose(r.result[1], p.cpu().numpy(), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TENANT_KERNELS))
def test_tenant_axis_refuses_bf16(cuda, name):
    """The bf16 instances take no tenant axis: a bf16 call with
    ``tile_base`` raises ValueError before any launch."""
    xa, t, q, own, g, bn = _tenant_inputs(cuda, 2, 16)
    fn, rows = TENANT_KERNELS[name]
    extra = {"sample_block": (own, g), "masked_blocksum": (own,),
             "blocksum": ()}[name]
    base = torch.zeros(-(-q.shape[0] // rows(16)), dtype=torch.int32,
                       device=cuda)
    with pytest.raises(ValueError, match="f32 instances only"):
        fn(q, xa, *extra, "gaussian", 1.0, 1.0, bn, "bf16", tile_base=base)


@pytest.mark.cuda
def test_timer_fences_on_the_card(cuda, monkeypatch):
    """obs.metrics.Timer synchronizes the device that holds the returned
    tensors."""
    from repro_torch.obs import metrics
    seen = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: (seen.append(dev), real(dev)))
    t = metrics.Timer("card")
    out = t.time(lambda: (torch.ones(256, 256, device=cuda) @
                          torch.ones(256, 256, device=cuda), 3))
    assert seen == [cuda.index or 0] and out[0].is_cuda
    assert t.wall_us >= t.dispatch_us > 0


# ------------------------------------------------------------------ #
# the training slice on the card
#: (b, hq, hkv, s, dh): a ragged GQA shape and the train phase's head dim
#: at 512 keys (granite-3-2b's heads)
FLASH_GRAD_SHAPES = [(2, 4, 2, 77, 32), (1, 32, 8, 512, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_GRAD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gradients_on_the_kernel_match_plain(cuda, shape, dtype):
    """Gradients through the flash ``autograd.Function`` on the card (the
    kernel's forward: one launch; the backward through ``attention_ref``)
    against the same call on the CPU's plain path: out as the forward
    tests hold it, dq / dk / dv at rtol 2e-4 / atol 1e-5 (f32).  In bf16
    out and dq lie within one bf16 step; dk and dv within twice the plain
    path's own bf16 error, max |plain - f32 path| (the f32 path: the same
    gradients of the bf16 inputs taken in f32 and rounded once), since the
    reference's VJP rounds each head's k / v gradient to bf16 before the
    GQA group's sum (``repeat`` on bf16 k / v), so two f32 summation
    orders may differ by a step a head."""
    b, hq, hkv, s, dh = shape
    gen = torch.Generator(device=cuda).manual_seed(s * 10 + dh)
    q = _randn(gen, (b, hq, s, dh), cuda, dtype)
    k = _randn(gen, (b, hkv, s, dh), cuda, dtype)
    v = _randn(gen, (b, hkv, s, dh), cuda, dtype)
    w = _randn(gen, (b, hq, s, dh), cuda)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        args = [t.to(dev).detach().requires_grad_() for t in (q, k, v)]
        fk.reset_launches()
        out = fops.flash_attention(*args, True)
        grads = torch.autograd.grad((out.float() * w.to(dev)).sum(), args)
        outs[dev.type] = (out.detach().cpu(), [g.cpu() for g in grads])
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert fk.LAUNCHES["flash_attention"] == 1
    (got, gg), (want, wg) = outs["cuda"], outs["cpu"]
    if dtype == torch.bfloat16:
        args = [t.detach().cpu().float().requires_grad_() for t in (q, k, v)]
        out32 = fops.flash_attention(*args, True)
        # out's cotangent as the bf16 path sees it: w rounded to bf16
        g32 = torch.autograd.grad(
            (out32 * w.cpu().to(dtype).float()).sum(), args)
    for i, (name, a, c) in enumerate([("out", got, want)] + list(zip(
            ("dq", "dk", "dv"), gg, wg))):
        assert a.dtype == dtype, name
        if dtype == torch.float32:
            torch.testing.assert_close(a, c, rtol=RTOL, atol=ATOL, msg=name)
        elif name in ("out", "dq"):
            assert_bf16_close(a, c, ATOL, name)
        else:
            own = float((c.float() - g32[i - 1]).abs().max())
            diff = float((a.float() - c.float()).abs().max())
            assert diff <= 2 * own + ATOL, (name, diff, own)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One ``make_train_step(impl="flash")`` step of the reduced yi-6b on
    the card against the same step on the CPU, from the same weights and
    batch: 2 flash launches (remat: forward and recompute), loss and grad
    norm at rtol 1e-5, and parameters within 10x the CPU's own xla-vs-flash
    difference after the step (the train-step tests' rule)."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import make_train_step
    cfg = dataclasses.replace(get_reduced("yi_6b"), dtype="float32")
    batch = make_batch(cfg, ShapeConfig("t", 64, 2, "train"), 0)
    adamw = topt.AdamWConfig(lr=1e-3, warmup_steps=1)

    def run(dev, impl):
        model = T.init_params(cfg, seed=0, device="cpu").to(dev)
        step = make_train_step(cfg, adamw, impl=impl)
        model, _, m = step(model, topt.init_adamw(model), batch)
        return {k: p.detach().cpu() for k, p in model.named_parameters()}, m

    fk.reset_launches()
    got, m = run(cuda, "flash")
    torch.cuda.synchronize()
    assert fk.LAUNCHES["flash_attention"] == 2 * cfg.num_layers
    want, mw = run("cpu", "flash")
    other, _ = run("cpu", "xla")
    gap = max(float((want[k] - other[k]).abs().max()) for k in want)
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(m[key].cpu(), mw[key], rtol=1e-5, atol=0)
    diff = max(float((got[k] - want[k]).abs().max()) for k in want)
    assert diff <= 10 * max(gap, 1e-7), (diff, gap)


@pytest.mark.cuda
def test_custom_kind_sampler_on_the_card_launches_no_kernel(cuda):
    """A custom kind's ``NeighborSampler`` (exact level 1) on the card
    runs its ``pairwise`` closure: every kernel counter reads 0 after
    sample / prob_of / a walk, and ``prob_of`` equals the CPU sampler's at
    rtol 2e-4 (ROADMAP.md section 3)."""
    def pairwise(a, b):
        d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2 * a @ b.T
        return torch.exp(-torch.clamp(d2, min=0.0))

    kern = dataclasses.replace(gaussian(1.0), name="mykind",
                               pairwise=pairwise)
    x = np.random.default_rng(0).standard_normal((256, 4)).astype(np.float32)
    src = np.arange(0, 256, 8)
    dst = (src * 7 + 3) % 256
    want = NeighborSampler(x, kern, seed=0, exact_blocks=True,
                           device="cpu").prob_of(src, dst)
    nbr = NeighborSampler(x, kern, seed=0, exact_blocks=True, device=cuda)
    for mod in (rk, sk, hk, fk):
        mod.reset_launches()
    nb, p = nbr.sample(src)
    got = nbr.prob_of(src, dst)
    nbr.walk(src, 2)
    torch.cuda.synchronize()
    counts = {**rk.LAUNCHES, **sk.LAUNCHES, **hk.LAUNCHES, **fk.LAUNCHES}
    assert not any(counts.values()), counts
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.isfinite(p).all() and (nb != src).all()
