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
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        tfa.flash_attention(q, k, v)
    with torch.no_grad():
        tfa.flash_attention(q, k, v)


def test_flash_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrappers launch or raise: a CPU tensor is refused, never
    routed to the plain version (the KDE decode's bf16 operands too)."""
    q, k, v = (_t(a) for a in _qkv(1, 1, 2, 1, 8, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfk.flash_attention_cuda(q, k, v, causal=True, scale=1.0,
                                 kv_valid=8, offset=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkk.kde_decode_cuda(q[:, :, 0].bfloat16(), k.bfloat16(),
                            v.bfloat16(), top_p=1, bk=4, stride=2,
                            kv_valid=8)


def test_flash_instantiation_follows_alignment():
    """The kernel instance a call takes: cp.async staging when every
    operand row is 16-byte aligned, else the scalar-staged instance of the
    same template; the head dim picks the compile-time bucket."""
    q, k, v = (_t(a) for a in _qkv(2, 1, 4, 2, 16, 16, 128))
    vt = v.transpose(1, 2).contiguous().transpose(1, 2)
    assert tfk.instantiation(q, k, vt) == "float32 dh<=128 cp.async"
    q, k, v = (_t(a) for a in _qkv(2, 1, 4, 2, 16, 16, 30))
    assert tfk.instantiation(q, k, v) == "float32 dh<=32 scalar"
    q, k, v = (_t(a) for a in _qkv(2, 1, 4, 2, 16, 17, 64))
    assert tfk.instantiation(q, k[:, :, 1:], v[:, :, 1:]) == \
        "float32 dh<=64 cp.async"
    flat = torch.zeros(1 + k.numel())
    shifted = flat[1:].view(k.shape)             # rows 4 bytes off 16
    assert tfk.instantiation(q, shifted, v) == "float32 dh<=64 scalar"
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(2, 1, 2, 1, 8, 8, 16))
    assert tfk.instantiation(q, k, v) == "bfloat16 dh<=32 cp.async"
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(2, 1, 2, 1, 8, 8, 12))
    assert tfk.instantiation(q, k, v) == "bfloat16 dh<=32 scalar"


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


_jkde = jax.jit(jka.kde_attention,
               static_argnames=("top_p", "bk", "stride", "kv_valid",
                                "interpret"))
# the fused decode kernel's plain version against the reference pipeline:
# b 2, hkv 2, S = 8 blocks of bk 16, dh 16, stride 4, top_p 3
DEC_BK, DEC_NB, DEC_DH, DEC_STRIDE, DEC_TOP_P = 16, 8, 16, 4, 3


def _decode_case(seed, group, top_p=DEC_TOP_P, kv_valid=None):
    b, hkv = 2, 2
    s = DEC_BK * DEC_NB
    q, k, v = _decode_inputs(seed, b, hkv * group, hkv, s, DEC_DH)
    kw = dict(top_p=top_p, bk=DEC_BK, stride=DEC_STRIDE,
              kv_valid=s if kv_valid is None else kv_valid)
    got, est = tkk.kde_decode_plain(_t(q), _t(k), _t(v), with_est=True, **kw)
    want = _jkde(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 interpret=True, **kw)
    want_est = _jblock_lse(q, k, scale=1 / np.sqrt(DEC_DH), stride=DEC_STRIDE,
                           kv_valid=kw["kv_valid"], bk=DEC_BK, interpret=True)
    return _np(got), np.asarray(want), _np(est), np.asarray(want_est)


@pytest.mark.parametrize("kv_valid", [1, DEC_BK - 1, DEC_BK, DEC_BK + 1,
                                      DEC_BK * DEC_NB])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_kde_decode_plain_matches_reference(group, kv_valid):
    """``kde_decode_plain`` (the fused kernel's plain version, and the CPU
    path of ``ops.kde_attention``) against the reference's kde_attention
    with its block-lse kernel in Pallas interpret mode: out and the step-1
    estimates at rtol 2e-4 / atol 2e-5, over GQA groups of 1, 4 and 8 and
    kv_valid at 1, bk - 1, bk, bk + 1 and S (early decode steps leave
    fully-masked blocks tied at -1e30 in the selection)."""
    got, want, est, want_est = _decode_case(100 + group, group,
                                            kv_valid=kv_valid)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(est, want_est, rtol=2e-4, atol=2e-5)
    dead = -(-kv_valid // DEC_BK)
    assert np.all(est[..., dead:] == np.float32(-1e30))


@pytest.mark.parametrize("top_p", [DEC_NB, DEC_NB + 3])
def test_kde_decode_plain_top_p_covers_every_block(top_p):
    """top_p >= nb selects every block: no residual mass, and the
    reference's min(top_p, nb) clamp."""
    got, want, _, _ = _decode_case(7, 4, top_p=top_p)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def _tied_case():
    """Blocks 1, 3 and 5 of every kv-head hold the same keys, aligned with
    the group's mean query, so they tie for the top of the selection at a
    finite value; values differ between blocks.  Entries are small
    multiples of powers of two, so every score is exact in f32."""
    b, hkv, group = 1, 2, 4
    rng = np.random.default_rng(31)
    s = DEC_BK * DEC_NB
    q = rng.integers(-2, 3, (b, hkv * group, DEC_DH)).astype(np.float32) / 2
    k = rng.integers(-2, 3, (b, hkv, s, DEC_DH)).astype(np.float32) / 8
    v = rng.normal(0, 1, (b, hkv, s, DEC_DH)).astype(np.float32)
    sign = np.sign(q.reshape(b, hkv, group, DEC_DH).sum(2))
    for blk in (1, 3, 5):
        k[:, :, blk * DEC_BK:(blk + 1) * DEC_BK] = \
            k[:, :, DEC_BK:2 * DEC_BK] if blk != 1 else \
            k[:, :, DEC_BK:2 * DEC_BK] + sign[:, :, None, :] / 2
    return q, k, v


@pytest.mark.parametrize("top_p", [1, 2])
def test_kde_decode_ties_go_to_the_lower_block(top_p):
    """Finite ties between block estimates: the top-P selection takes the
    lower block index first, as ``lax.top_k`` does, so the plain pipeline
    matches the reference at a selection boundary that cuts a tied set."""
    q, k, v = _tied_case()
    kw = dict(top_p=top_p, bk=DEC_BK, stride=DEC_STRIDE, kv_valid=k.shape[2])
    got, est = tkk.kde_decode_plain(_t(q), _t(k), _t(v), with_est=True, **kw)
    est_kv = tkr._group_lse(est, 4)
    assert bool((est_kv[..., 1] == est_kv[..., 3]).all())
    assert bool((est_kv[..., 1] == est_kv[..., 5]).all())
    assert bool((est_kv[..., 1] > est_kv[..., 0]).all())
    assert tkr.top_blocks(est_kv, 3).tolist() == [[[1, 3, 5]] * 2]
    want = _jkde(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 interpret=True, **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(_np(got), np.asarray(_jkde_ref(q, k, v, **kw)),
                               rtol=2e-4, atol=2e-5)


def test_top_blocks_orders_as_lax_top_k():
    """Ties at a finite value and at the -1e30 sentinel go to the lower
    index, as ``lax.top_k`` orders them."""
    est = np.array([[[1.0, 3.0, 3.0, 2.0, 3.0, -1e30, -1e30, 2.0]]],
                   np.float32)
    for p in range(1, 9):
        _, want = jax.lax.top_k(jnp.asarray(est), p)
        assert tkr.top_blocks(_t(est), p).tolist() == \
            np.asarray(want).tolist()


def test_kde_decode_cuda_wrapper_rejects_cpu_tensors():
    """The fused kernel's wrapper launches or raises: CPU tensors are
    refused, never routed to the plain version."""
    q, k, v = _decode_inputs(1, 1, 4, 2, 64, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkk.kde_decode_cuda(_t(q), _t(k), _t(v), top_p=2, bk=16, stride=4,
                            kv_valid=64)


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
