"""The port's LM serving path (``repro_torch.configs``, ``data.pipeline``,
``models``, ``train.train_step``, ``launch.serve``) against the JAX
reference, on the reduced dense GQA configs with the reference's own
random weights carried across by ``convert.params_from_reference``.

yi_6b is the served model; granite_3_2b (padded vocab, tied head),
qwen2_5_14b (QKV bias) and chatglm3_6b (glm2d RoPE) cover the other
branches of the same path.  Logits agree at atol 1e-4 over the real vocab
(f32 matmuls summed in another order); the reference's flash runs in
interpret mode, its KDE decode through its jnp mirror, the port's through
``kde_attention.ops`` (the plain block-lse on the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.launch import serve as jserve
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.train.train_step import make_decode_step, make_prefill_step

ARCHS = ["yi_6b", "granite_3_2b", "qwen2_5_14b", "chatglm3_6b"]
ATOL = 1e-4
KDE_CFG = {"top_p": 4, "bk": 16, "stride": 2}
_ATTN_STATIC = ("causal", "q_offset", "kv_valid")
_jxla_attention = jax.jit(JL.xla_attention, static_argnames=_ATTN_STATIC)
_jxla_chunked = jax.jit(JL.xla_attention_chunked,
                        static_argnames=_ATTN_STATIC)


def _cfgs(arch):
    """(reference, port) reduced f32 configs."""
    jc = dataclasses.replace(jbase.get_reduced(arch), dtype="float32")
    tc = dataclasses.replace(tbase.get_reduced(arch), dtype="float32")
    return jc, tc


_MODELS = {}


def _models(arch):
    """(reference params, port model) for the reduced config, the port's
    weights converted from the reference's PRNGKey(0) init (cached)."""
    if arch not in _MODELS:
        jc, tc = _cfgs(arch)
        params = JT.init_params(jax.random.PRNGKey(0), jc)
        tree = jax.tree.map(np.asarray, params)
        _MODELS[arch] = (params, convert.params_from_reference(
            tree, tc, device="cpu"))
    return _MODELS[arch]


def _tokens(cfg, b, s, seed=0):
    shape = tbase.ShapeConfig("t", s, b, "prefill")
    return tpipe.make_batch(cfg, shape, 0, seed)["tokens"]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for jget, tget in ((jbase.get_config, tbase.get_config),
                       (jbase.get_reduced, tbase.get_reduced)):
        jc, tc = jget(arch), tget(arch)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert (jc.hd, jc.padded_vocab, jc.param_count()) == \
            (tc.hd, tc.padded_vocab, tc.param_count())
    assert tbase.SHAPES == {k: tbase.ShapeConfig(**dataclasses.asdict(v))
                            for k, v in jbase.SHAPES.items()}


def test_yi_6b_is_the_served_width():
    cfg = tbase.get_config("yi_6b")
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_ff,
            cfg.padded_vocab, cfg.num_layers) == \
        (4096, 32, 4, 128, 11008, 64000, 32)
    assert round(cfg.param_count() / 1e9, 2) == 6.06
    assert tbase.get_config("granite_3_2b").padded_vocab == 49664


@pytest.mark.parametrize("arch,seq,batch,step,seed", [
    ("yi_6b", 64, 4, 0, 0), ("granite_3_2b", 37, 3, 5, 11),
    ("chatglm3_6b", 512, 2, 1, 2)])
def test_make_batch_bit_equal(arch, seq, batch, step, seed):
    for full in (True, False):
        jc = jbase.get_config(arch) if full else jbase.get_reduced(arch)
        tc = tbase.get_config(arch) if full else tbase.get_reduced(arch)
        js = jbase.ShapeConfig("s", seq, batch, "prefill")
        ts = tbase.ShapeConfig("s", seq, batch, "prefill")
        want = jpipe.make_batch(jc, js, step, seed)
        got = tpipe.make_batch(tc, ts, step, seed)
        assert got.keys() == want.keys()
        assert got["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert tpipe.token_split(tc, ts) == jpipe.token_split(jc, js)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_matches_reference(arch, impl):
    """The port's forward (xla, and flash through the plain flash version)
    against the reference's forward(impl="xla"); the prefill step returns
    the last position."""
    jc, tc = _cfgs(arch)
    params, model = _models(arch)
    toks = _tokens(tc, 2, 24)
    want = np.asarray(jax.jit(lambda p, t: JT.forward(
        p, jc, {"tokens": t}, impl="xla")[0])(params, jnp.asarray(toks)))
    with torch.inference_mode():
        got, aux = TT.forward(model, tc, {"tokens": toks}, impl=impl)
    v = tc.vocab_size
    assert got.shape == want.shape and aux == 0.0
    np.testing.assert_allclose(got[..., :v].numpy(), want[..., :v],
                               atol=ATOL)
    if tc.padded_vocab != v:
        assert bool((got[..., v:] == np.float32(-1e30)).all())
    last = make_prefill_step(tc, impl=impl)(model, {"tokens": toks})
    np.testing.assert_array_equal(last.numpy(), got[:, -1:].numpy())


def test_forward_flash_matches_reference_flash():
    """One forward(impl="flash") against the reference's own flash forward,
    its Pallas kernel in interpret mode (ragged length: k / v padded)."""
    jc, tc = _cfgs("yi_6b")
    params, model = _models("yi_6b")
    toks = _tokens(tc, 2, 40, seed=3)
    want = np.asarray(jax.jit(lambda p, t: JT.forward(
        p, jc, {"tokens": t}, impl="flash")[0])(params, jnp.asarray(toks)))
    with torch.inference_mode():
        got, _ = TT.forward(model, tc, {"tokens": toks}, impl="flash")
    v = tc.vocab_size
    np.testing.assert_allclose(got[..., :v].numpy(), want[..., :v],
                               atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """decode_step on a 64-token warmed cache of length 128, then one xla
    and one kde step (top_p 4, bk 16, stride 2, as the reference's layer
    test): logits and caches against the reference's decode_step."""
    jc, tc = _cfgs(arch)
    params, model = _models(arch)
    tok = np.random.default_rng(0).integers(0, tc.vocab_size, (1, 1))
    tok = tok.astype(np.int32)
    jstep = {impl: jax.jit(lambda p, t, c, pos, impl=impl: JT.decode_step(
        p, jc, t, c, pos, impl=impl,
        kde_cfg=KDE_CFG if impl == "kde" else None)) for impl in ("xla",
                                                                  "kde")}
    jcache = JT.init_cache(jc, 1, 128, jnp.float32)
    tcache = TT.init_cache(tc, 1, 128, torch.float32, device="cpu")
    tstep = make_decode_step(tc, impl="xla")
    for pos in range(64):
        _, jcache = jstep["xla"](params, tok, jcache, jnp.int32(pos))
        tstep(model, tcache, tok, pos)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), atol=ATOL)
    v = tc.vocab_size
    for impl in ("xla", "kde"):
        want, _ = jstep[impl](params, tok, jcache, jnp.int32(64))
        before = tcache["k"].clone()
        nxt, got, _ = make_decode_step(
            tc, impl=impl, kde_cfg=KDE_CFG if impl == "kde" else None)(
                model, tcache, tok, 64)
        np.testing.assert_allclose(got[..., :v].numpy(),
                                   np.asarray(want)[..., :v], atol=ATOL)
        assert int(nxt[0]) == int(np.argmax(np.asarray(want)[0, -1]))
        # the step wrote position 64 in place and nothing else
        changed = (tcache["k"] != before).any(dim=(0, 1, 2, 4))
        assert changed.nonzero().flatten().tolist() in ([], [64])


def test_layers_match_reference():
    """rmsnorm, both RoPE styles, dense and chunked attention (a ragged
    last chunk, a query offset and kv_valid) against the reference."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 2, (2, 5, 16)).astype(np.float32)
    g = rng.normal(1, 0.1, (16,)).astype(np.float32)
    np.testing.assert_allclose(
        TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), 1e-5).numpy(),
        np.asarray(JL.rmsnorm(x, g, 1e-5)), rtol=1e-6, atol=1e-6)
    h = rng.normal(0, 1, (2, 3, 7, 16)).astype(np.float32)
    pos = np.arange(7) + 100
    for style in ("full", "glm2d"):
        np.testing.assert_allclose(
            TL.apply_rope(torch.from_numpy(h), torch.from_numpy(pos),
                          style).numpy(),
            np.asarray(JL.apply_rope(h, jnp.asarray(pos), style)),
            atol=2e-5)
    q = rng.normal(0, 1, (1, 4, 9, 16)).astype(np.float32)
    k = rng.normal(0, 1, (1, 2, 300, 16)).astype(np.float32)
    v = rng.normal(0, 1, (1, 2, 300, 16)).astype(np.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for kw in (dict(causal=True, q_offset=250, kv_valid=259),
               dict(causal=False), dict(causal=True, q_offset=-20)):
        want = np.asarray(_jxla_attention(q, k, v, **kw))
        np.testing.assert_allclose(TL.xla_attention(tq, tk, tv, **kw).numpy(),
                                   want, atol=2e-5)
        np.testing.assert_allclose(
            TL.xla_attention_chunked(tq, tk, tv, **kw).numpy(),
            np.asarray(_jxla_chunked(q, k, v, **kw)), atol=2e-5)


def _reference_generations(argv, capsys):
    assert jserve.main(argv) == 0
    line = [s for s in capsys.readouterr().out.splitlines()
            if s.startswith("[serve] sample generations:")]
    assert len(line) == 1
    return line[0]


@pytest.mark.parametrize("attention", ["xla", "kde"])
def test_serve_generations_match_reference(attention, capsys):
    """The port's serve driver (CPU, the reference's weights) gives the
    reference driver's generations with the same flags."""
    argv = ["--reduced", "--batch", "2", "--prompt-len", "32", "--gen", "4",
            "--attention", attention]
    want = _reference_generations(argv, capsys)
    args = tserve.parser().parse_args(argv + ["--device", "cpu"])
    cfg, max_len = tserve.serve_config(args)
    assert max_len == (64 if attention == "kde" else 36)
    jc = dataclasses.replace(jbase.get_reduced("yi_6b"), dtype="float32")
    tree = jax.tree.map(np.asarray,
                        JT.init_params(jax.random.PRNGKey(0), jc))
    res = tserve.run_lm(args, model=convert.params_from_reference(
        tree, cfg, device="cpu"))
    assert res["tokens"].shape == (2, 4)
    assert f"[serve] sample generations: {res['tokens'][:2].tolist()}" == want
    assert res["prompt_logits"].shape == (2, cfg.padded_vocab)
    assert res["first_decode_logits"].shape == (2, cfg.padded_vocab)


def test_serve_main_on_cpu(capsys):
    """The port's own CLI with its random init, on the CPU."""
    assert tserve.main(["--device", "cpu", "--reduced", "--batch", "2",
                        "--prompt-len", "8", "--gen", "3", "--attention",
                        "kde", "--kde-bk", "8"]) == 0
    out = capsys.readouterr().out
    assert "[serve] arch=yi_6b attention=kde batch=2 prompt=8 gen=3" in out
    assert "[serve] sample generations:" in out


def test_out_of_slice_options_raise():
    """The other families, the unported serve mode (``--robust``) and a
    CUDA default without a card raise (the bf16 config builds and serves:
    ``tests/test_torch_lm_bf16.py``; the graph-serving modes are ported:
    ``tests/test_torch_serving.py``)."""
    f32 = dataclasses.replace(tbase.get_reduced("yi_6b"), dtype="float32")
    for bad in (dict(num_experts=4, experts_per_token=2),
                dict(ssm_kind="mamba2"), dict(encoder_layers=2),
                dict(frontend="vision")):
        with pytest.raises(NotImplementedError, match="queue 1 item 12"):
            TT.init_params(dataclasses.replace(f32, **bad), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        tbase.get_config("rwkv6_3b")
    args = tserve.parser().parse_args(["--device", "cpu", "--reduced",
                                       "--robust"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserve.run_lm(args)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TT.init_params(f32)
