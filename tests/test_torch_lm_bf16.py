"""The port's bf16 LM (``models.layers.dtype_of``, ``transformer.cast_params``,
the bf16 ``init_cache`` default, ``convert.params_from_reference`` on a
cast tree) and the bf16 operands of the KDE decode plain version, against
the JAX reference on the reduced dense configs.

The reference's bf16 model is its ``cast_params`` tree run under its bf16
config; the port gets the same bits through ``params_from_reference``.
The bound on the port's logits is the reference's own bf16 error on the
same inputs, max |port - ref_bf16| <= max |ref_bf16 - ref_f32| over the
real vocab, with ref_f32 the reference's f32 model on the uncast weights.
ref_bf16 is the reference compiled as written, every bf16 op rounding to
bf16 (``xla_allow_excess_precision`` off for that compile): by default
XLA may keep f32 between the ops of a fused chain, which rounds at other
places than the program says.  Against that compile the port's decode
steps agree to 6e-8, held at DECODE_REL of the largest logit; its prefill
differs by f32 ulps of RoPE's cos / sin (XLA's and torch's own
polynomials), which flip a few bf16 roundings, held at PREFILL_SHARE of
the bf16 gap.  A control runs the port's ops in f32 on the same bf16
weights and must miss both.
The KDE decode's plain version upcasts exactly as the reference's kernel
and ops do, so its bf16 out lies within one bf16 step of the reference's
and its f32 estimates at rtol 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels.kde_attention import kernel as jkk
from repro.kernels.kde_attention import ops as jka
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels.kde_attention import kernel as tkk
from repro_torch.models import layers as TL
from repro_torch.testing import bf16_steps
from repro_torch.models import transformer as TT
from repro_torch.train.train_step import make_decode_step, make_prefill_step

ARCHS = ["yi_6b", "granite_3_2b", "qwen2_5_14b", "chatglm3_6b"]
KDE_CFG = {"top_p": 4, "bk": 16, "stride": 2}

_jkde = jax.jit(jka.kde_attention,
                static_argnames=("top_p", "bk", "stride", "kv_valid",
                                 "interpret"))
_jblock_lse = jax.jit(jkk.block_lse_pallas,
                      static_argnames=("scale", "stride", "kv_valid", "bk",
                                       "interpret"))

#: the reference compiled as written: every bf16 op rounds
_STRICT = {"xla_allow_excess_precision": False}
_MODELS = {}


def _strict(fn, *args):
    """``fn`` jitted and compiled for ``args`` with ``_STRICT``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=_STRICT)


def _models(arch):
    """(reference bf16 config, its f32 twin, the reference's f32 params,
    its cast_params tree, the port's bf16 config, the port's model built
    from the cast tree) for the reduced config (cached)."""
    if arch not in _MODELS:
        jc = jbase.get_reduced(arch)
        assert jc.dtype == "bfloat16"
        params = JT.init_params(jax.random.PRNGKey(0), jc)
        cast = JT.cast_params(params, jnp.bfloat16)
        tc = tbase.get_reduced(arch)
        model = convert.params_from_reference(
            jax.tree.map(np.asarray, cast), tc, device="cpu")
        _MODELS[arch] = (jc, dataclasses.replace(jc, dtype="float32"),
                         params, cast, tc, model)
    return _MODELS[arch]


def _tensors(model):
    return dict(model.named_parameters())


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


#: the prefill's max |port - ref_bf16| as a share of the bf16 gap at most:
#: measured 0-0.37 for the port (RoPE cos / sin ulps), 0.69-0.81 for the
#: port's ops run in f32 on the bf16 weights
PREFILL_SHARE = 0.5
#: the decode steps' max |port - ref_bf16| over max |ref_bf16| at most:
#: measured 4e-8-1.2e-7 for the port, 5e-3-7e-3 in f32 on the bf16 weights
DECODE_REL = 1e-5


def _gaps(got, ref_bf16, ref_f32, vocab, what):
    """(max |got - ref_bf16|, the bound max |ref_bf16 - ref_f32|, max
    |ref_bf16|) over the real vocab; got finite."""
    got = np.asarray(got, np.float32)[..., :vocab]
    ref_bf16 = np.asarray(ref_bf16, np.float32)[..., :vocab]
    ref_f32 = np.asarray(ref_f32, np.float32)[..., :vocab]
    assert np.isfinite(got).all(), what
    return (np.abs(got - ref_bf16).max(), np.abs(ref_bf16 - ref_f32).max(),
            np.abs(ref_bf16).max())


def _prefill_ok(got, refs, vocab):
    """The prefill's gap within the reference's own bf16 error, and within
    PREFILL_SHARE of it."""
    gap, bound, _ = _gaps(got, *refs, vocab, "prefill")
    return gap <= bound and gap <= PREFILL_SHARE * bound, (gap, bound)


def _decode_ok(got, refs, vocab):
    """A decode step's gap within the reference's own bf16 error, and
    within DECODE_REL of max |ref_bf16|."""
    gap, bound, top = _gaps(got, *refs, vocab, "decode")
    return gap <= bound and gap <= DECODE_REL * top, (gap, bound, top)


_REFS = {}


def _prefill_refs(arch):
    """(tokens, the reference's bf16 logits, its f32 logits) of a 2 x 24
    prefill (cached)."""
    key = ("prefill", arch)
    if key not in _REFS:
        jc, jc32, params, cast, tc, _ = _models(arch)
        toks = tpipe.make_batch(tc, tbase.ShapeConfig("t", 24, 2, "prefill"),
                                0, 0)["tokens"]

        def ref(p, cfg, compile_):
            t = jnp.asarray(toks)
            return np.asarray(compile_(lambda p, t: JT.forward(
                p, cfg, {"tokens": t}, impl="xla")[0], p, t)(p, t))
        _REFS[key] = (toks, ref(cast, jc, _strict),
                      ref(params, jc32, lambda fn, *a: jax.jit(fn)))
    return _REFS[key]


def _decode_refs(arch):
    """(token, {impl: (the reference's bf16 logits, its f32 logits)}) of
    one decode step at position 48 of a length-128 cache warmed by 48 xla
    steps (cached)."""
    key = ("decode", arch)
    if key in _REFS:
        return _REFS[key]
    jc, jc32, params, cast, tc, _ = _models(arch)
    tok = np.random.default_rng(1).integers(0, tc.vocab_size, (1, 1))
    tok = tok.astype(np.int32)

    def jstep(cfg, impl, p, c):
        fn = lambda p, t, c, pos: JT.decode_step(  # noqa: E731
            p, cfg, t, c, pos, impl=impl,
            kde_cfg=KDE_CFG if impl == "kde" else None)
        if cfg.dtype == "float32":
            return jax.jit(fn)
        return _strict(fn, p, tok, c, jnp.int32(0))

    warm = {}
    for name, cfg, p, dtype in (("bf16", jc, cast, jnp.bfloat16),
                                ("f32", jc32, params, jnp.float32)):
        c = JT.init_cache(cfg, 1, 128, dtype)
        step = jstep(cfg, "xla", p, c)
        for pos in range(48):
            _, c = step(p, tok, c, jnp.int32(pos))
        warm[name] = (cfg, p, c)
    refs = {impl: tuple(np.asarray(jstep(cfg, impl, p, c)(
        p, tok, c, jnp.int32(48))[0]) for cfg, p, c in
        (warm["bf16"], warm["f32"])) for impl in ("xla", "kde")}
    _REFS[key] = (tok, refs)
    return _REFS[key]


def _port_decode(model, cfg, cache, tok):
    """{impl: logits} of the port's decode step at position 48 of
    ``cache`` warmed by 48 xla steps."""
    warm = make_decode_step(cfg, impl="xla")
    for pos in range(48):
        warm(model, cache, tok, pos)
    got = {}
    for impl in ("xla", "kde"):
        _, got[impl], _ = make_decode_step(
            cfg, impl=impl, kde_cfg=KDE_CFG if impl == "kde" else None)(
                model, {n: t.clone() for n, t in cache.items()}, tok, 48)
    return got


# ------------------------------------------------------------------ params
@pytest.mark.parametrize("arch", ARCHS)
def test_cast_params_matches_reference(arch):
    """cast_params on the port's f32 model equals the reference's
    cast_params tree leaf by leaf, bitwise: every layer parameter (the
    reference stacks them, so its norms and biases have two dims) and
    embed / lm_head in bf16, final_norm f32."""
    jc, _, params, cast, tc, model = _models(arch)
    f32 = convert.params_from_reference(jax.tree.map(np.asarray, params), tc,
                                        device="cpu")
    assert all(t.dtype == torch.float32 for t in f32.parameters())
    got = _tensors(TT.cast_params(f32, torch.bfloat16))
    want = _tensors(model)
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert t.dtype == want[name].dtype, name
        assert torch.equal(_bits(t), _bits(want[name])), name
    assert want["final_norm"].dtype == torch.float32
    assert want["layers.0.ln1"].dtype == torch.bfloat16
    # the cast tree read by dtype name: bits kept
    np.testing.assert_array_equal(
        want["embed"].view(torch.int16).numpy(),
        np.asarray(cast["embed"]).view(np.int16))
    np.testing.assert_array_equal(want["final_norm"].numpy(),
                                  np.asarray(cast["final_norm"]))


def test_cast_params_shares_what_it_does_not_cast():
    """A cast to the model's own dtype, or of final_norm, makes no copy."""
    *_, model = _models("yi_6b")
    again = TT.cast_params(model, torch.bfloat16)
    assert again.embed.data_ptr() == model.embed.data_ptr()
    assert again.final_norm.data_ptr() == model.final_norm.data_ptr()


def test_dtype_of_and_init_cache_mirror_the_reference():
    """dtype_of: bf16 for "bfloat16", f32 otherwise; init_cache defaults to
    bf16, as the reference's."""
    cfg = tbase.get_reduced("yi_6b")
    assert TL.dtype_of(cfg) == torch.bfloat16
    assert TL.dtype_of(dataclasses.replace(cfg, dtype="float32")) == \
        torch.float32
    cache = TT.init_cache(cfg, 2, 32, device="cpu")
    want = JT.init_cache(jbase.get_reduced("yi_6b"), 2, 32)
    for name in ("k", "v"):
        assert cache[name].dtype == torch.bfloat16
        assert want[name].dtype == jnp.bfloat16
        assert tuple(cache[name].shape) == want[name].shape
        assert not bool(cache[name].any())


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_bf16_forward_matches_reference(arch, impl):
    """The port's bf16 forward (xla, and flash through the plain flash
    version) against the reference's bf16 forward(impl="xla"): within the
    reference's own bf16-vs-f32 gap on the same tokens, and within
    PREFILL_SHARE of it; bf16 activations, f32 logits."""
    *_, tc, model = _models(arch)
    toks, *refs = _prefill_refs(arch)
    with torch.inference_mode():
        got, _ = TT.forward(model, tc, {"tokens": toks}, impl=impl)
    assert got.dtype == torch.float32
    ok, gaps = _prefill_ok(got.numpy(), refs, tc.vocab_size)
    assert ok, (arch, impl, gaps)
    last = make_prefill_step(tc, impl=impl)(model, {"tokens": toks})
    np.testing.assert_array_equal(last.numpy(), got[:, -1:].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_matches_reference(arch):
    """decode_step in bf16 (a bf16 cache of length 128 warmed by 48 xla
    steps, then one xla and one kde step, top_p 4, bk 16, stride 2): logits
    against the reference's bf16 decode_step (its kde through the jnp
    mirror), within the reference's bf16-vs-f32 gap (its f32 twin warmed
    the same way) and within DECODE_REL of max |logit|."""
    *_, tc, model = _models(arch)
    tok, refs = _decode_refs(arch)
    cache = TT.init_cache(tc, 1, 128, device="cpu")
    assert cache["k"].dtype == torch.bfloat16
    for impl, got in _port_decode(model, tc, cache, tok).items():
        assert got.dtype == torch.float32
        ok, gaps = _decode_ok(got.numpy(), refs[impl], tc.vocab_size)
        assert ok, (arch, impl, gaps)


@pytest.mark.parametrize("arch", ARCHS)
def test_bounds_reject_f32_activations(arch):
    """The control of the two tests above: the port's ops run in f32 on
    the same bf16 weights (an f32 config, an f32 cache) miss the prefill's
    PREFILL_SHARE and every decode step's DECODE_REL, though they stay
    within the reference's bf16 gap."""
    *_, tc, model = _models(arch)
    tc32 = dataclasses.replace(tc, dtype="float32")
    m32 = TT.cast_params(model, torch.float32)
    toks, *refs = _prefill_refs(arch)
    with torch.inference_mode():
        got, _ = TT.forward(m32, tc32, {"tokens": toks}, impl="xla")
    ok, (gap, bound) = _prefill_ok(got.numpy(), refs, tc.vocab_size)
    assert not ok and gap <= bound, (arch, gap, bound)
    tok, drefs = _decode_refs(arch)
    cache = TT.init_cache(tc32, 1, 128, torch.float32, device="cpu")
    for impl, got in _port_decode(m32, tc32, cache, tok).items():
        ok, (gap, bound, _) = _decode_ok(got.numpy(), drefs[impl],
                                         tc.vocab_size)
        assert not ok and gap <= bound, (arch, impl, gap, bound)


def test_bf16_config_builds_and_serves_on_the_cpu():
    """The reduced yi-6b as configured (bf16): init_params draws f32
    weights, cast_params casts them, and a flash prefill, 4 xla and 4 kde
    decode steps on the bf16 cache run on the CPU with finite f32 logits
    and bf16 activations in the cache."""
    cfg = tbase.get_reduced("yi_6b")
    model = TT.cast_params(TT.init_params(cfg, seed=3, device="cpu"),
                           TL.dtype_of(cfg))
    assert model.layers[0].attn.wq.dtype == torch.bfloat16
    toks = tpipe.make_batch(cfg, tbase.ShapeConfig("t", 16, 2, "prefill"), 0,
                            1)["tokens"]
    logits = make_prefill_step(cfg, impl="flash")(model, {"tokens": toks})
    assert logits.dtype == torch.float32 and logits.shape == \
        (2, 1, cfg.padded_vocab)
    for impl in ("xla", "kde"):
        cache = TT.init_cache(cfg, 2, 32, device="cpu")
        step = make_decode_step(cfg, impl=impl,
                                kde_cfg={"top_p": 2, "bk": 8, "stride": 2})
        cur = torch.as_tensor(toks[:, :1])
        for pos in range(4):
            nxt, logits, cache = step(model, cache, cur, pos)
            cur = nxt[:, None]
            assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
        assert bool(cache["k"][:, :, :, :4].any())
        assert not bool(cache["k"][:, :, :, 4:].any())


def test_forward_and_decode_accumulate_in_f32(monkeypatch):
    """forward and decode_step run their matmuls with cuBLAS's bf16
    reduced-precision reduction off (layers.f32_accumulation), and leave
    the flag as they found it."""
    seen = []
    swiglu = TL.swiglu

    def probe(p, x):
        seen.append(torch.backends.cuda.matmul
                    .allow_bf16_reduced_precision_reduction)
        return swiglu(p, x)

    monkeypatch.setattr(TL, "swiglu", probe)
    mm = torch.backends.cuda.matmul
    old = mm.allow_bf16_reduced_precision_reduction
    try:
        mm.allow_bf16_reduced_precision_reduction = True
        cfg = tbase.get_reduced("yi_6b")
        *_, model = _models("yi_6b")
        toks = np.zeros((1, 4), np.int32)
        with torch.inference_mode():
            TT.forward(model, cfg, {"tokens": toks})
            TT.decode_step(model, cfg, toks[:, :1],
                           TT.init_cache(cfg, 1, 8, device="cpu"), 0)
        assert seen == [False] * (2 * cfg.num_layers)
        assert mm.allow_bf16_reduced_precision_reduction is True
    finally:
        mm.allow_bf16_reduced_precision_reduction = old


# ---------------------------------------------------------- kde decode bf16
DEC_BK, DEC_NB, DEC_DH, DEC_STRIDE, DEC_TOP_P = 16, 8, 16, 4, 3


def _decode_arrays(seed, group, planted=False):
    """numpy f32 q (2, 2 g, dh), k / v (2, 2, S, dh) rounded through bf16;
    ``planted`` adds the bench_attention-style peaked mass (two key runs
    along each group's mean query)."""
    b, hkv, s = 2, 2, DEC_BK * DEC_NB
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, hkv * group, DEC_DH)).astype(np.float32)
    k = rng.normal(0, 0.3, (b, hkv, s, DEC_DH)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, s, DEC_DH)).astype(np.float32)
    if planted:
        qv = q.reshape(b, hkv, group, DEC_DH).mean(2)
        qv /= np.linalg.norm(qv, axis=-1, keepdims=True)
        k[:, :, 20:30] += 4.0 * qv[:, :, None]
        k[:, :, 90:96] += 3.0 * qv[:, :, None]
    return tuple(np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v))


@pytest.mark.parametrize("q_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("kv_valid", [DEC_BK + 5, DEC_BK * DEC_NB])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_kde_decode_plain_bf16_matches_reference(group, kv_valid, q_dtype):
    """kde_decode_plain on a bf16 cache with bf16 (or f32) q against the
    reference's kde_attention on the same arrays, its block-lse kernel in
    Pallas interpret mode: out in q's dtype within one bf16 step (f32 q:
    rtol 2e-4 / atol 2e-5, the f32 test's), the step-1 estimates against
    block_lse_pallas at rtol 2e-5."""
    q, k, v = _decode_arrays(200 + group, group)
    if q_dtype == "f32":
        q = q.astype(np.float32)
    kw = dict(top_p=DEC_TOP_P, bk=DEC_BK, stride=DEC_STRIDE,
              kv_valid=kv_valid)
    tq, tk, tv = (_torch(a) for a in (q, k, v))
    got, est = tkk.kde_decode_plain(tq, tk, tv, with_est=True, **kw)
    want = _jkde(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 interpret=True, **kw)
    want_est = _jblock_lse(jnp.asarray(q), jnp.asarray(k),
                           scale=1 / np.sqrt(DEC_DH), stride=DEC_STRIDE,
                           kv_valid=kv_valid, bk=DEC_BK, interpret=True)
    assert got.dtype == tq.dtype and est.dtype == torch.float32
    if q_dtype == "bf16":
        assert want.dtype == jnp.bfloat16
        assert int(bf16_steps(got, _torch(np.asarray(want))).max()) <= 1
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-5)
    np.testing.assert_allclose(est.numpy(), np.asarray(want_est), rtol=2e-5,
                               atol=2e-5)
    assert np.all(est.numpy()[..., -(-kv_valid // DEC_BK):] ==
                  np.float32(-1e30))


@pytest.mark.parametrize("group", [1, 8])
def test_kde_decode_plain_bf16_on_planted_keys(group):
    """Planted keys (the peaked mass the selection is for), bf16 q and
    cache: out within one bf16 step of the reference's interpret-mode
    pipeline, estimates at rtol 2e-5."""
    q, k, v = _decode_arrays(300 + group, group, planted=True)
    kw = dict(top_p=2, bk=DEC_BK, stride=DEC_STRIDE,
              kv_valid=DEC_BK * DEC_NB)
    got, est = tkk.kde_decode_plain(_torch(q), _torch(k), _torch(v),
                                    with_est=True, **kw)
    want = _jkde(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 interpret=True, **kw)
    want_est = _jblock_lse(jnp.asarray(q), jnp.asarray(k),
                           scale=1 / np.sqrt(DEC_DH), stride=DEC_STRIDE,
                           kv_valid=kw["kv_valid"], bk=DEC_BK, interpret=True)
    assert int(bf16_steps(got, _torch(np.asarray(want))).max()) <= 1
    np.testing.assert_allclose(est.numpy(), np.asarray(want_est), rtol=2e-5,
                               atol=2e-5)


def _torch(a):
    """numpy (f32 or bf16) -> a CPU tensor of the same dtype, bits kept."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.int16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))
