"""The port's attention kernels' plain versions (``repro_torch.kernels.
flash_attention``, ``repro_torch.kernels.kde_attention``) against the JAX
reference on the same numpy inputs.

The reference's two Pallas kernels run in interpret mode here, as its own
tests run them.  On the CPU the port's wrappers take their plain versions;
the CUDA kernels are held to those on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Tolerances are the reference's own: f32 outputs atol
2e-5 (its flash sweep and its kde pipeline-vs-mirror check), bf16 3e-2,
lse 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro.kernels.kde_attention import kernel as jkk
from repro.kernels.kde_attention import ops as jka
from repro.kernels.kde_attention import ref as jkr
from repro_torch.kernels.flash_attention import kernel as tfk
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.kde_attention import kernel as tkk
from repro_torch.kernels.kde_attention import ops as tka
from repro_torch.kernels.kde_attention import ref as tkr

_jflash = jax.jit(jfa.flash_attention, static_argnums=(3, 4, 5, 6, 7))
_jattn_ref = jax.jit(jfa.attention_ref, static_argnames=("causal", "scale",
                                                         "kv_valid"))
_jblock_lse = jax.jit(jkk.block_lse_pallas,
                      static_argnames=("scale", "stride", "kv_valid", "bk",
                                       "interpret"))
_jblock_lse_ref = jax.jit(jkr.block_lse_ref,
                          static_argnames=("scale", "stride", "kv_valid",
                                           "bk"))
_jexact = jax.jit(jkr.exact_decode_attention, static_argnames=("kv_valid",))
_jkde_ref = jax.jit(jkr.kde_attention_ref,
                    static_argnames=("top_p", "bk", "stride", "kv_valid"))

FLASH_SWEEP = [
    (2, 4, 2, 64, 64, 32),       # GQA, square causal
    (1, 8, 2, 1, 300, 64),       # decode: 1 query vs long cache
    (2, 4, 4, 100, 228, 16),     # MHA, ragged shapes
    (1, 2, 1, 17, 17, 8),        # tiny odd
]
KDE_SHAPES = [  # b, hq, hkv, S, dh, bk, stride, top_p
    (2, 8, 2, 2048, 64, 128, 8, 4),
    (1, 4, 4, 1024, 32, 256, 16, 2),
    (2, 2, 1, 512, 16, 64, 4, 3),
]


def _qkv(seed, b, hq, hkv, sq, skv, dh, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, hq, sq, dh)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, skv, dh)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, skv, dh)).astype(np.float32)
    if dtype == "bf16":
        q, k, v = (a.astype(jnp.bfloat16) for a in (q, k, v))
    return q, k, v


def _t(a):
    """numpy (f32 or bf16) -> torch tensor of the same dtype, on the CPU."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.float().numpy()


# ----------------------------------------------------------- flash attention
@pytest.mark.parametrize("shape", FLASH_SWEEP)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_matches_reference_interpret(shape, dtype):
    """out (and lse, f32) of the port's flash against the reference's
    Pallas kernel in interpret mode, bq = bk = 64 as its sweep."""
    q, k, v = _qkv(sum(shape), *shape,
                   dtype=np.float32 if dtype == "f32" else "bf16")
    want, want_lse = _jflash(q, k, v, True, 64, 64, True, True)
    got, got_lse = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                       bq=64, bk=64, with_lse=True)
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    tol = 2e-5 if dtype == "f32" else 3e-2
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol)
    np.testing.assert_allclose(_np(got_lse), np.asarray(want_lse), atol=1e-4)


def test_flash_lse_against_attention_ref():
    """The reference's own lse check (bq = bk = 32, square causal)."""
    q, k, v = _qkv(11, 1, 2, 2, 32, 32, 16)
    _, lse = tfa.flash_attention(_t(q), _t(k), _t(v), True, 32, 32,
                                 with_lse=True)
    _, want = _jattn_ref(q, k, v, causal=True, scale=1 / np.sqrt(16))
    np.testing.assert_allclose(_np(lse), np.asarray(want), atol=1e-4)
    _, port_ref = tfa.attention_ref(_t(q), _t(k), _t(v), causal=True,
                                    scale=1 / np.sqrt(16))
    np.testing.assert_allclose(_np(port_ref), np.asarray(want), atol=1e-4)


def test_flash_offset_quirk_mirrors_the_reference():
    """(sq, skv) = (5, 37), bq = bk = 64: the reference's kernel places the
    queries at padded skv - padded sq = 64 - 8, not at skv - sq = 32, so it
    differs from attention_ref; the port mirrors the kernel."""
    q, k, v = _qkv(5, 1, 2, 1, 5, 37, 16)
    want = np.asarray(_jflash(q, k, v, True, 64, 64, True, False))
    got = _np(tfa.flash_attention(_t(q), _t(k), _t(v), True, 64, 64))
    np.testing.assert_allclose(got, want, atol=2e-5)
    ref, _ = tfa.attention_ref(_t(q), _t(k), _t(v), causal=True,
                               scale=1 / np.sqrt(16))
    assert np.abs(got - _np(ref)).max() > 0.05


@pytest.mark.parametrize("shape", [(1, 4, 2, 100, 40, 32),
                                   (1, 2, 2, 200, 17, 16)])
def test_flash_rows_without_valid_keys(shape):
    """Negative offsets leave query rows with no valid key: the sentinel
    gives them the mean of v over every padded key (p = exp(0) = 1), as the
    Pallas body does, and lse -1e30."""
    q, k, v = _qkv(7, *shape)
    want, want_lse = _jflash(q, k, v, True, 128, 128, True, True)
    got, lse = tfa.flash_attention(_t(q), _t(k), _t(v), with_lse=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(_np(lse), np.asarray(want_lse), atol=1e-4,
                               rtol=1e-6)
    assert float(lse.min()) == float(np.float32(-1e30))


def test_flash_plain_strided_operands():
    """The plain version reads transposed (b, h, s, dh) views, as the model
    hands it v, and pads k / v as the reference does."""
    q, k, v = _qkv(3, 2, 4, 2, 24, 24, 16)
    vt = _t(v).transpose(1, 2).contiguous().transpose(1, 2)
    assert not vt.is_contiguous()
    got = tfa.flash_attention(_t(q), _t(k), vt)
    want = np.asarray(_jflash(q, k, v, True, 128, 128, True, False))
    np.testing.assert_allclose(_np(got), want, atol=2e-5)


def test_flash_raises_on_requires_grad():
    q, k, v = (_t(a) for a in _qkv(1, 1, 2, 1, 8, 8, 8))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        tfa.flash_attention(q, k, v)
    with torch.no_grad():
        tfa.flash_attention(q, k, v)


def test_flash_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper launches or raises: a CPU tensor is refused, never
    routed to the plain version."""
    q, k, v = (_t(a) for a in _qkv(1, 1, 2, 1, 8, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfk.flash_attention_cuda(q, k, v, causal=True, scale=1.0,
                                 kv_valid=8, offset=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkk.block_lse_cuda(q[:, :, 0], k, scale=1.0, stride=2, kv_valid=8,
                           bk=4)


# ------------------------------------------------------------------ block lse
def _decode_inputs(seed, b, hq, hkv, s, dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, hq, dh)).astype(np.float32)
    k = rng.normal(0, 0.3, (b, hkv, s, dh)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, s, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("shape", KDE_SHAPES + [(4, 32, 4, 544, 128, 32, 4,
                                                 4)])
@pytest.mark.parametrize("partial", [False, True])
def test_block_lse_matches_reference(shape, partial):
    """The plain block-lse against the Pallas kernel (interpret) and the
    jnp mirror; ``partial`` sets kv_valid inside the second block, so the
    later blocks are fully masked (-1e30 exactly).  The last shape is the
    serve driver's (yi-6b heads, bk 32, stride 4, cache 544)."""
    b, hq, hkv, s, dh, bk, stride, _ = shape
    q, k, _ = _decode_inputs(sum(shape), b, hq, hkv, s, dh)
    kv_valid = bk + 3 if partial else s
    kw = dict(scale=1 / np.sqrt(dh), stride=stride, kv_valid=kv_valid, bk=bk)
    got = _np(tkk.block_lse_plain(_t(q), _t(k), **kw))
    np.testing.assert_allclose(got, np.asarray(
        _jblock_lse(q, k, interpret=True, **kw)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(_jblock_lse_ref(q, k, **kw)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(tkr.block_lse_ref(_t(q), _t(k), **kw)),
                               got, rtol=2e-5, atol=2e-5)
    if partial:
        assert np.all(got[..., 2:] == np.float32(-1e30))


# --------------------------------------------------------------- kde attention
@pytest.mark.parametrize("shape", KDE_SHAPES)
@pytest.mark.parametrize("partial", [False, True])
def test_kde_attention_matches_reference(shape, partial):
    """The port's kde_attention (plain block-lse on the CPU) against the
    reference's Pallas pipeline in interpret mode and its jnp mirror, atol
    2e-5 (the reference's pipeline-vs-mirror tolerance).  ``partial``
    leaves kv_valid in the third block: the fully-masked blocks tie at
    -1e30 in the top-P selection, which the output does not depend on."""
    b, hq, hkv, s, dh, bk, stride, top_p = shape
    q, k, v = _decode_inputs(sum(shape), b, hq, hkv, s, dh)
    kv_valid = 2 * bk + 5 if partial else None
    kw = dict(top_p=top_p, bk=bk, stride=stride, kv_valid=kv_valid)
    got = _np(tka.kde_attention(_t(q), _t(k), _t(v), **kw))
    want = jka.kde_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(_jkde_ref(q, k, v, **kw)),
                               atol=2e-5)
    np.testing.assert_allclose(
        _np(tkr.kde_attention_ref(_t(q), _t(k), _t(v), **kw)), got,
        atol=2e-5)


def test_kde_attention_approximates_exact_on_peaked():
    """The reference's peaked-mass bound: with the mass in two planted
    blocks, top-P blocks + KDE residual stay within 0.2 x max|exact|."""
    b, hq, hkv, s, dh = 1, 4, 2, 4096, 32
    rng = np.random.default_rng(17)
    q = rng.normal(0, 1, (b, hq, dh)).astype(np.float32)
    k = rng.normal(0, 0.05, (b, hkv, s, dh)).astype(np.float32)
    for h in range(hkv):
        qv = q.reshape(b, hkv, hq // hkv, dh).mean(2)[0, h]
        k[0, h, 100:140] += 8.0 * qv / np.linalg.norm(qv)
        k[0, h, 3000:3020] += 6.0 * qv / np.linalg.norm(qv)
    v = rng.normal(0, 1, (b, hkv, s, dh)).astype(np.float32)
    out = _np(tka.kde_attention(_t(q), _t(k), _t(v), top_p=8, bk=256,
                                stride=8))
    exact = _np(tka.exact_decode_attention(_t(q), _t(k), _t(v)))
    np.testing.assert_allclose(exact, np.asarray(_jexact(q, k, v)),
                               atol=2e-5)
    assert np.abs(out - exact).max() < 0.2 * np.abs(exact).max()


def test_kde_attention_exact_when_all_blocks_selected():
    """top_p = all blocks -> no residual -> exact attention (atol 1e-4, the
    reference's)."""
    q, k, v = _decode_inputs(23, 1, 2, 2, 256, 16)
    k *= 0.5 / 0.3
    out = _np(tka.kde_attention(_t(q), _t(k), _t(v), top_p=4, bk=64,
                                stride=4))
    exact = _np(tka.exact_decode_attention(_t(q), _t(k), _t(v)))
    np.testing.assert_allclose(out, exact, atol=1e-4)
    np.testing.assert_allclose(
        _np(tka.exact_decode_attention(_t(q), _t(k), _t(v), kv_valid=100)),
        np.asarray(_jexact(q, k, v, kv_valid=100)), atol=2e-5)
