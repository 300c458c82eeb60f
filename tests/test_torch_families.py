"""The port's non-dense LM families against the JAX reference: the MoE
configs (granite-moe, qwen3-moe), RWKV6, the Mamba2 hybrid (zamba2), the
enc-dec audio config (seamless) and the vision-frontend config (internvl2),
each reduced, in f32, with the reference's ``PRNGKey(0)`` weights carried
across by ``convert.params_from_reference``.

``forward`` (chunked and scan mixers; xla, and flash through the plain
flash version) and 8 ``decode_step``s (xla and kde) agree with the
reference's at atol 1e-4 over the real vocab (f32 sums in other orders).
The reference's own forward-vs-decode gap (the hybrid's shared block after
vs before its segments; the MoE capacity drops of a long forward) is
mirrored: the port's gap equals the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.models import transformer as TT
from repro_torch.train.train_step import make_decode_step, make_prefill_step

FAMILIES = ["granite_moe_1b_a400m", "qwen3_moe_235b_a22b", "rwkv6_3b",
            "zamba2_7b", "seamless_m4t_medium", "internvl2_1b"]
ATOL = 1e-4
KDE_CFG = {"top_p": 2, "bk": 8, "stride": 2}
SHAPE = tbase.ShapeConfig("t", 32, 2, "prefill")
STEPS = 8
MAX_LEN = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this module: its many tiny ops run
    several times slower on torch's thread pool when the test workers
    share the machine's cores (a reduced MoE block: 5 ms on 8 threads, 0.4
    ms on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(reference config, port config, reference params, port model, the
    2 x 32 batch) of the reduced f32 config."""
    jc = dataclasses.replace(jbase.get_reduced(arch), dtype="float32")
    tc = dataclasses.replace(tbase.get_reduced(arch), dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(0), jc)
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          tc, device="cpu")
    return jc, tc, params, model, tpipe.make_batch(tc, SHAPE, 0)


def _close(got, want, vocab, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got)[..., :vocab],
                               np.asarray(want)[..., :vocab], atol=atol,
                               rtol=0)


@functools.lru_cache(maxsize=None)
def _reference_forward(arch, seq_mixer):
    jc, _, params, _, batch = _setup(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, aux = jax.jit(lambda p, b: JT.forward(
        p, jc, b, impl="xla", remat=False, seq_mixer=seq_mixer))(params, jb)
    return np.asarray(logits), float(aux)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference(arch, impl):
    """forward (the chunked mixers) with the frontend prefix sliced off,
    and the MoE aux loss; the prefill step returns the last position."""
    _, tc, _, model, batch = _setup(arch)
    want, jaux = _reference_forward(arch, "chunked")
    with torch.inference_mode():
        got, aux = TT.forward(model, tc, batch, impl=impl)
    assert got.shape == want.shape == (2, tpipe.token_split(
        tc, SHAPE)["tokens"], tc.padded_vocab)
    _close(got, want, tc.vocab_size)
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-5, atol=1e-7)
    assert (jaux > 0) == tc.is_moe
    last = make_prefill_step(tc, impl=impl)(model, batch)
    np.testing.assert_array_equal(last.numpy(), got[:, -1:].numpy())


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_7b"])
def test_forward_scan_mixer_matches_reference(arch):
    """``seq_mixer`` other than "chunked" runs the scan, as the
    reference's forward reads it."""
    _, tc, _, model, batch = _setup(arch)
    want, _ = _reference_forward(arch, "scan")
    with torch.inference_mode():
        got, _ = TT.forward(model, tc, batch, seq_mixer="scan")
        chunked, _ = TT.forward(model, tc, batch)
    _close(got, want, tc.vocab_size)
    _close(make_prefill_step(tc, seq_mixer="scan")(model, batch),
           want[:, -1:], tc.vocab_size)
    _close(got, chunked, tc.vocab_size, atol=1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_cache_matches_reference(arch):
    """Every entry's shape and dtype (bf16 by default, the SSM states in
    f32; the enc-dec memory of enc_len rows), all zeros."""
    cfg, jcfg = tbase.get_reduced(arch), jbase.get_reduced(arch)
    for dtype, jdtype in ((None, None), (torch.float32, jnp.float32)):
        kw, jkw = ({}, {}) if dtype is None else (
            {"dtype": dtype}, {"dtype": jdtype})
        got = TT.init_cache(cfg, 3, 16, enc_len=5, device="cpu", **kw)
        want = JT.init_cache(jcfg, 3, 16, enc_len=5, **jkw)
        assert got.keys() == want.keys()
        for name, t in got.items():
            assert tuple(t.shape) == want[name].shape, name
            assert str(t.dtype).removeprefix("torch.") == \
                want[name].dtype.name, name
            assert not bool(t.any())
    assert ("memory" in got) == cfg.is_encdec


@functools.lru_cache(maxsize=None)
def _reference_decode(arch, impl):
    """(memory or None, the logits of STEPS reference decode steps on the
    batch's first tokens)."""
    jc, _, params, _, batch = _setup(arch)
    cache = JT.init_cache(jc, 2, MAX_LEN, jnp.float32, enc_len=8)
    memory = None
    if jc.is_encdec:
        memory = jax.jit(lambda p, f: JT._run_encoder(p, jc, f, "xla"))(
            params, jnp.asarray(batch["frontend"]))
        cache["memory"] = memory
    step = jax.jit(lambda p, t, c, pos: JT.decode_step(
        p, jc, t, c, pos, impl=impl,
        kde_cfg=KDE_CFG if impl == "kde" else None))
    out = []
    for pos in range(STEPS):
        logits, cache = step(params, jnp.asarray(
            batch["tokens"][:, pos:pos + 1]), cache, jnp.int32(pos))
        out.append(np.asarray(logits))
    return None if memory is None else np.asarray(memory), out


def _port_decode(arch, impl, model=None):
    _, tc, _, tmodel, batch = _setup(arch)
    model = model or tmodel
    cache = TT.init_cache(tc, 2, MAX_LEN, torch.float32, enc_len=8,
                          device="cpu")
    if tc.is_encdec:
        with torch.inference_mode():
            cache["memory"] = TT._run_encoder(model, tc, batch["frontend"],
                                              "xla")
    step = make_decode_step(tc, impl=impl,
                            kde_cfg=KDE_CFG if impl == "kde" else None)
    out = []
    for pos in range(STEPS):
        _, logits, cache = step(model, cache, batch["tokens"][:, pos:pos + 1],
                                pos)
        out.append(logits.numpy())
    return cache, out


@pytest.mark.parametrize("impl", ["xla", "kde"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_reference(arch, impl):
    """8 decode steps from an empty cache (the enc-dec memory from the
    encoder over the frontend embeddings): every step's logits."""
    _, tc, *_ = _setup(arch)
    memory, want = _reference_decode(arch, impl)
    cache, got = _port_decode(arch, impl)
    if memory is not None:
        _close(cache["memory"], memory, None, atol=1e-5)
    for g, w in zip(got, want):
        _close(g, w, tc.vocab_size)


#: the reference's own forward-vs-decode gap at 8 tokens over the real
#: vocab: large where it mirrors a behaviour (the hybrid's order; the MoE
#: drops of a long forward), f32 noise elsewhere
GAP_MIRRORED = {"zamba2_7b": True, "granite_moe_1b_a400m": True,
                "qwen3_moe_235b_a22b": True, "rwkv6_3b": False}


@pytest.mark.parametrize("arch", sorted(GAP_MIRRORED))
def test_forward_decode_gap_mirrors_the_reference(arch):
    """The forward's logits on 8 tokens against the 8 decode steps' (xla):
    the port's gap equals the reference's within 2 ATOL, and is large
    exactly where the reference's is (the hybrid applies its shared block
    after layer 0 in the forward and before it in decode; the forward
    drops MoE tokens over capacity, a one-token step never does)."""
    jc, tc, params, model, batch = _setup(arch)
    toks = batch["tokens"][:, :STEPS]
    want_fwd = np.asarray(jax.jit(lambda p, t: JT.forward(
        p, jc, {"tokens": t}, remat=False)[0])(params, jnp.asarray(toks)))
    with torch.inference_mode():
        got_fwd = TT.forward(model, tc, {"tokens": toks})[0].numpy()
    _, want_dec = _reference_decode(arch, "xla")
    _, got_dec = _port_decode(arch, "xla")
    v = tc.vocab_size
    want_gap = np.abs(want_fwd - np.concatenate(want_dec, 1))[..., :v]
    got_gap = np.abs(got_fwd - np.concatenate(got_dec, 1))[..., :v]
    np.testing.assert_allclose(got_gap, want_gap, atol=2 * ATOL, rtol=0)
    assert (want_gap.max() > 1e-2) == GAP_MIRRORED[arch], want_gap.max()
