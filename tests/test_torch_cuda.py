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
from repro_torch.core.kernels_fn import gaussian
from repro_torch.core.sampling.edge import NeighborSampler
from repro_torch.core.sparsify import spectral_sparsify
from repro_torch.kernels.kde_hash import kernel as hk
from repro_torch.kernels.kde_rowsum import kernel as rk
from repro_torch.kernels.kde_sampler import kernel as sk
from repro_torch.kernels.kde_sampler.ops import gumbel
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.kde_attention import kernel as kk
from repro_torch.kernels.kde_attention import ops as kops
from repro_torch.launch import serve
from repro_torch.models import transformer as T

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
    CPU: out and lse at rtol 2e-4 / atol 1e-5 for f32 operands, out at atol
    3e-2 (the reference's bf16 tolerance) for bf16; v is a transposed view,
    as the model hands it."""
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
        torch.testing.assert_close(out.cpu().float(), want.float(), rtol=0,
                                   atol=3e-2)
    torch.testing.assert_close(lse.cpu(), want_lse, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_scalar_staging_on_unaligned_rows(cuda, dtype):
    """Operand rows that are not 16-byte aligned (k and v views one element
    into their storage) take the scalar-staged instance and still match the
    plain version; fresh copies take the cp.async instance."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(gen, (1, 4, 200, 64), cuda, dtype)
    kv = _randn(gen, (2, 2 * 200 * 64 + 1), cuda, dtype)
    k, v = (t[1:].view(1, 2, 200, 64) for t in kv)
    kw = dict(causal=True, scale=0.125, kv_valid=200, offset=0)
    assert fk.instantiation(q, k, v).endswith("scalar")
    assert fk.instantiation(q, k.clone(), v.clone()).endswith("cp.async")
    out, lse = fk.flash_attention_cuda(q, k, v, **kw)
    want, want_lse = fk.flash_attention_plain(q, k, v, **kw)
    atol = ATOL if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=RTOL if
                               dtype == torch.float32 else 0, atol=atol)
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LSE_SHAPES)
def test_block_lse_kernel_matches_plain(cuda, shape):
    """The block-lse kernel vs its plain version: rtol 2e-4 / atol 1e-5;
    blocks with no valid key come out at -1e30 exactly."""
    b, hq, hkv, s, dh, bk, stride, kv_valid = shape
    gen = torch.Generator(device=cuda).manual_seed(s + dh)
    q = _randn(gen, (b, hq, dh), cuda)
    k = _randn(gen, (b, hkv, s, dh), cuda, scale=0.3)
    kw = dict(scale=dh ** -0.5, stride=stride, kv_valid=kv_valid, bk=bk)
    kk.reset_launches()
    got = kk.block_lse_cuda(q, k, **kw)
    torch.cuda.synchronize()
    assert kk.LAUNCHES["block_lse"] == 1
    want = kk.block_lse_plain(q, k, **kw)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    dead = -(-kv_valid // bk)
    assert bool((got[..., dead:] == -1e30).all())


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
    assert kk.LAUNCHES == {"block_lse": 0, "kde_decode": 1}
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
    assert kk.LAUNCHES == {"block_lse": 0,
                           "kde_decode": cfg.num_layers * (40 + 5 - 1)}
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
    assert kk.LAUNCHES == {"block_lse": 0, "kde_decode": 1}
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
def test_kde_decode_refuses_a_cache_too_long_for_a_cluster(cuda):
    """A cache whose per-block shared memory exceeds a cluster of 8 CTAs
    (2^20 keys in blocks of 32 at a group of 8) is refused by the plan,
    before any launch; 2^19 keys fit.  The cache is a stride-0 view."""
    q = torch.zeros((1, 32, 128), device=cuda)
    for s, fits in ((1 << 19, True), (1 << 20, False)):
        k = torch.zeros((1, 4, 1, 128), device=cuda).expand(1, 4, s, 128)
        kk.reset_launches()
        if fits:
            out = kk.kde_decode_cuda(q, k, k, top_p=4, bk=32, stride=4,
                                     kv_valid=s)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(out).all())
            assert kk.LAUNCHES["kde_decode"] == 1
        else:
            with pytest.raises(ValueError, match="do not fit"):
                kk.kde_decode_cuda(q, k, k, top_p=4, bk=32, stride=4,
                                   kv_valid=s)
            assert kk.LAUNCHES["kde_decode"] == 0
