"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need a CUDA device and skip without one; on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(This file imports no JAX, so it runs where only PyTorch is installed.)
"""
import numpy as np
import pytest
import torch

from repro_torch.core.kernels_fn import gaussian
from repro_torch.core.sampling.edge import NeighborSampler
from repro_torch.core.sparsify import spectral_sparsify
from repro_torch.kernels.kde_hash import kernel as hk
from repro_torch.kernels.kde_rowsum import kernel as rk
from repro_torch.kernels.kde_sampler import kernel as sk
from repro_torch.kernels.kde_sampler.ops import gumbel

RTOL, ATOL = 2e-4, 1e-5
KINDS = ["gaussian", "exponential", "laplacian", "rational_quadratic"]
SHAPES = [(37, 301, 19, 70), (64, 1024, 16, 256), (20, 203, 784, 50)]
# (m, n, t, d) of the weighted gathered kernels: ragged, the degree-query
# width (t = 128 + 64), and the laplacian's mnist_like width
HASH_SHAPES = [(37, 301, 45, 19), (64, 4096, 192, 16), (20, 203, 33, 784)]


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(kind, shape, dev):
    m, n, d, bn = shape
    gen = torch.Generator(device=dev).manual_seed(m * 1000 + d)
    q = torch.randn(m, d, generator=gen, device=dev) * 0.3
    x = torch.randn(n, d, generator=gen, device=dev) * 0.3
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
    assert hk.LAUNCHES == {"weighted_kv_sum": 0, "weighted_kv": 1}
    np.testing.assert_allclose(nbr.prob_of(src, v), p, rtol=1e-6)
    hk.reset_launches()
    g = spectral_sparsify(x, gaussian(1.0), num_edges=4096, estimator="hash",
                          device=cuda)
    assert hk.LAUNCHES == {"weighted_kv_sum": 3, "weighted_kv": 4}
    assert np.all(np.isfinite(g.weight)) and g.num_edges == 4096
