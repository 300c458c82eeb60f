"""The arithmetic of the flash kernel's bf16 body (tensor cores: exact bf16
products summed in f32, p split into bf16 hi + lo for PV) against the JAX
reference's Pallas kernel in interpret mode on bf16 inputs.

The CUDA body cannot run here; ``flash_attention.kernel.flash_bf16_model``
repeats its arithmetic in plain torch ops (key tiles of 64, an online
softmax rescaled once a tile), and ``tests/test_torch_cuda.py`` holds the
kernel to the plain version on the card.  Tolerance: one bf16 step of the
reference's out (``testing.assert_bf16_close``, atol 1e-5 near zero), as
the card's checks; lse at the reference's 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro_torch.kernels.flash_attention import kernel as tfk
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.testing import assert_bf16_close

_jflash = jax.jit(jfa.flash_attention, static_argnums=(3, 4, 5, 6, 7))

# (b, hq, hkv, sq, skv, dh, bq = bk): the reference's flash sweep, the
# (5, 37) offset quirk, and two shapes whose rows have no valid key
# (negative offsets: each such row averages v over every padded key)
SHAPES = [(2, 4, 2, 64, 64, 32, 64), (1, 8, 2, 1, 300, 64, 64),
          (2, 4, 4, 100, 228, 16, 64), (1, 2, 1, 17, 17, 8, 64),
          (1, 2, 1, 5, 37, 16, 64), (1, 4, 2, 100, 40, 32, 128),
          (1, 2, 2, 200, 17, 16, 128), (1, 2, 1, 300, 300, 128, 128)]


def _qkv(seed, b, hq, hkv, sq, skv, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1, shape).astype(jnp.bfloat16) for shape in
                 ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh)))


def _t(a):
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("shape", SHAPES)
def test_tensor_core_model_matches_reference_interpret(shape):
    """The bf16 body's arithmetic, through the reference's padding and
    offset (``ops.flash_args``), against the reference's Pallas kernel in
    interpret mode on the same bf16 inputs: out within one bf16 step, lse
    within 1e-4."""
    *dims, blk = shape
    q, k, v = _qkv(sum(shape), *dims)
    want, want_lse = _jflash(q, k, v, True, blk, blk, True, True)
    tq, tk, tv = _t(q), _t(k), _t(v)
    kp, vp, kw = tfa.flash_args(tq, tk, tv, True, blk, blk)
    got, lse = tfk.flash_bf16_model(tq, kp, vp, **kw)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, _t(np.asarray(want)), 1e-5, f"model {shape}")
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-4,
                               rtol=1e-6)
    # the same model against the plain version (single f32 PV): one step
    plain, _ = tfk.flash_attention_plain(tq, kp, vp, **kw)
    assert_bf16_close(got, plain, 1e-5, f"model vs plain {shape}")


def test_rows_without_valid_keys_take_p_hi_one():
    """A row with no valid key has p = exp(0) = 1 for every masked key:
    the split gives p_hi = 1, p_lo = 0, so the model's out is the mean of
    v over the padded keys exactly as the plain version's, and lse -1e30."""
    q, k, v = _qkv(7, 1, 4, 2, 100, 40, 32)
    tq, tk, tv = _t(q), _t(k), _t(v)
    kp, vp, kw = tfa.flash_args(tq, tk, tv)
    assert kw["offset"] < 0
    got, lse = tfk.flash_bf16_model(tq, kp, vp, **kw)
    dead = lse == -1e30
    assert bool(dead.any())
    hi, lo = tfk.split_bf16(torch.ones(3))
    assert torch.equal(hi, torch.ones(3)) and torch.equal(lo, torch.zeros(3))
    mean = vp.float().repeat_interleave(2, dim=1).mean(2, keepdim=True)
    want = mean.expand_as(got.float()).to(torch.bfloat16)
    assert torch.equal(got[dead], want[dead])


def test_hi_lo_split_reconstructs_p():
    """p_hi + p_lo is p to 2^-16 relative (about 2^-17 expected) over the
    whole range a probability takes, [1e-30, 1], where one rounding to
    bf16 leaves up to 2^-9."""
    g = torch.Generator().manual_seed(0)
    p = torch.exp(-torch.rand(200_000, generator=g) * float(np.log(1e30)))
    p = torch.cat([p, torch.tensor([1.0, 1e-30, 0.5, 1.0 - 2 ** -24])])
    hi, lo = tfk.split_bf16(p)
    rel = ((hi.double() + lo.double()) - p.double()).abs() / p.double()
    assert float(rel.max()) <= 2.0 ** -16
    assert float(((hi.double() - p.double()).abs() / p.double()).max()) \
        > 2.0 ** -10                 # a single rounding is far coarser
