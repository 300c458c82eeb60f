"""The port's SSM mixers (``repro_torch.models.ssm``: RWKV6 and Mamba2,
each as a scan and in chunked form) against the JAX reference's, on the
reference's own ``init_*`` weights carried across as tensors.

Outputs and states agree at atol 2e-5 (f32 sums in other orders, XLA's
and torch's own exp); the decay and ``dt`` math is f32 whatever x's dtype,
the states f32, the RWKV shift state in x's dtype.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import ssm as JS
from repro_torch.configs import base as tbase
from repro_torch.models import ssm as TS

ATOL = 2e-5


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


def _cfgs(arch, **kw):
    jc = dataclasses.replace(jbase.get_reduced(arch), dtype="float32", **kw)
    tc = dataclasses.replace(tbase.get_reduced(arch), dtype="float32", **kw)
    return jc, tc


def _port(kind, params):
    """The reference's parameter dict as the port's module."""
    cls, names = ((TS.RWKV6, ("mu", "wr", "wk", "wv", "wg", "ww", "w0", "u",
                              "wo")) if kind == "rwkv6" else
                  (TS.Mamba2, ("in_proj", "bc_proj", "dt_proj", "dt_bias",
                               "a_log", "d_skip", "out_proj")))
    return cls(*(torch.tensor(np.asarray(params[n])) for n in names))


def _setup(kind, seed=0, **kw):
    arch = "rwkv6_3b" if kind == "rwkv6" else "zamba2_7b"
    jc, tc = _cfgs(arch, **kw)
    init = JS.init_rwkv6 if kind == "rwkv6" else JS.init_mamba2
    params = init(jax.random.PRNGKey(seed), jc)
    return jc, tc, params, _port(kind, params)


def _x(b, s, d, seed=1, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, (b, s, d)).astype(
        np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("kind", ["rwkv6", "mamba2"])
def test_init_matches_reference(kind):
    """``init_*``: the reference's leaves, shapes and constants (mu 0.5, w0
    -2, dt_bias 0, a_log = log linspace, d_skip 1), the random leaves at
    the reference's scales."""
    jc, tc, params, _ = _setup(kind)
    init = TS.init_rwkv6 if kind == "rwkv6" else TS.init_mamba2
    got = dict(init(torch.Generator().manual_seed(0), tc).named_parameters())
    assert got.keys() == params.keys()
    for name, t in got.items():
        want = np.asarray(params[name])
        assert tuple(t.shape) == want.shape and t.dtype == torch.float32
        if name in ("mu", "w0", "dt_bias", "a_log", "d_skip"):
            np.testing.assert_allclose(t.detach().numpy(), want, rtol=1e-6)
        else:
            np.testing.assert_allclose(t.detach().std().item(), want.std(),
                                       rtol=0.25)


@pytest.mark.parametrize("s,chunk", [(16, 128), (32, 16), (48, 16)])
def test_rwkv6_matches_reference(s, chunk):
    """rwkv6_scan (out, state, shift) and rwkv6_chunked (chunk 16 over
    several chunks too) against the reference's."""
    jc, tc, params, p = _setup("rwkv6")
    x = _x(2, s, tc.d_model)
    want, wstate, wshift = jax.jit(lambda p, x: JS.rwkv6_scan(p, jc, x))(
        params, x)
    got, state, shift = TS.rwkv6_scan(p, tc, torch.from_numpy(x))
    _close(got, want)
    _close(state, wstate)
    _close(shift, wshift, 0)
    assert state.dtype == torch.float32 and shift.dtype == torch.float32
    want_c = jax.jit(lambda p, x: JS.rwkv6_chunked(p, jc, x, chunk))(params, x)
    _close(TS.rwkv6_chunked(p, tc, torch.from_numpy(x), chunk), want_c)
    _close(TS.rwkv6_chunked(p, tc, torch.from_numpy(x), chunk), want)


@pytest.mark.parametrize("s,chunk", [(16, 128), (32, 16), (48, 16)])
def test_mamba2_matches_reference(s, chunk):
    """mamba2_scan (out, state) and mamba2_chunked against the
    reference's."""
    jc, tc, params, p = _setup("mamba2")
    x = _x(2, s, tc.d_model)
    want, wstate = jax.jit(lambda p, x: JS.mamba2_scan(p, jc, x))(params, x)
    got, state = TS.mamba2_scan(p, tc, torch.from_numpy(x))
    _close(got, want)
    _close(state, wstate)
    want_c = jax.jit(lambda p, x: JS.mamba2_chunked(p, jc, x, chunk))(
        params, x)
    _close(TS.mamba2_chunked(p, tc, torch.from_numpy(x), chunk), want_c)


@pytest.mark.parametrize("kind", ["rwkv6", "mamba2"])
def test_state_carried_across_calls(kind):
    """A scan over 24 tokens equals a scan over 10 then 14 with the
    states carried (the decode carry), in both packages."""
    jc, tc, params, p = _setup(kind)
    x = _x(2, 24, tc.d_model, seed=3)
    xt = torch.from_numpy(x)
    if kind == "rwkv6":
        want, ws, wsh = JS.rwkv6_scan(params, jc, x[:, 10:],
                                      *JS.rwkv6_scan(params, jc, x[:, :10])[1:])
        _, s0, sh0 = TS.rwkv6_scan(p, tc, xt[:, :10])
        got, s1, sh1 = TS.rwkv6_scan(p, tc, xt[:, 10:], state=s0,
                                     shift_state=sh0)
        whole = TS.rwkv6_scan(p, tc, xt)
        _close(sh1, wsh, 0)
    else:
        want, ws = JS.mamba2_scan(params, jc, x[:, 10:],
                                  JS.mamba2_scan(params, jc, x[:, :10])[1])
        _, s0 = TS.mamba2_scan(p, tc, xt[:, :10])
        got, s1 = TS.mamba2_scan(p, tc, xt[:, 10:], state=s0)
        whole = TS.mamba2_scan(p, tc, xt)
    _close(got, want)
    _close(s1, ws)
    torch.testing.assert_close(got, whole[0][:, 10:], atol=ATOL, rtol=0)
    torch.testing.assert_close(s1, whole[1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["rwkv6", "mamba2"])
def test_strong_decay_hits_the_clamp_as_the_reference(kind):
    """Inputs at 3x scale drive the chunked log decays past the -30 clamp
    within a chunk of 32; the port clamps in the same places, so the
    chunked outputs still agree (and stay finite)."""
    jc, tc, params, p = _setup(kind, seed=2)
    x = _x(1, 64, tc.d_model, seed=5, scale=3.0)
    chunked = JS.rwkv6_chunked if kind == "rwkv6" else JS.mamba2_chunked
    tchunked = TS.rwkv6_chunked if kind == "rwkv6" else TS.mamba2_chunked
    want = np.asarray(chunked(params, jc, x, 32))
    got = tchunked(p, tc, torch.from_numpy(x), 32)
    assert np.isfinite(want).all()
    _close(got, want, 2e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("kind", ["rwkv6", "mamba2"])
def test_bf16_inputs_keep_the_reference_dtypes(kind):
    """bf16 x (bf16 weights): outputs in bf16, states f32 (the shift state
    bf16), within one bf16 step of the reference's own bf16 run at the
    outputs' scale."""
    jc, tc, params, _ = _setup(kind)
    jc16 = dataclasses.replace(jc, dtype="bfloat16")
    cast = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 1
                        else a, params)
    p = _port(kind, jax.tree.map(lambda a: np.asarray(a, np.float32), cast))
    for t in p.parameters():
        t.data = t.data.to(torch.bfloat16)
    x = _x(2, 16, tc.d_model).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    if kind == "rwkv6":
        want, ws, wsh = JS.rwkv6_scan(cast, jc16, jnp.asarray(x))
        got, s, sh = TS.rwkv6_scan(p, tc, xt)
        assert sh.dtype == torch.bfloat16 and wsh.dtype == jnp.bfloat16
    else:
        want, ws = JS.mamba2_scan(cast, jc16, jnp.asarray(x))
        got, s = TS.mamba2_scan(p, tc, xt)
    assert got.dtype == torch.bfloat16 and s.dtype == torch.float32
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(ws), rtol=0,
                               atol=1e-2 * np.abs(np.asarray(ws)).max())


@pytest.mark.parametrize("fn", ["rwkv6_chunked", "mamba2_chunked"])
def test_chunk_must_divide_the_sequence(fn):
    """The reference asserts s % min(chunk, s) == 0; the port raises
    ValueError."""
    kind = fn.split("_")[0]
    _, tc, _, p = _setup(kind)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        getattr(TS, fn)(p, tc, torch.zeros(1, 24, tc.d_model), 16)


def test_rwkv6_chunked_clamp_is_the_reference_s():
    """A base decay of w0 = -1 drives a channel's log decay past the -30
    clamp within a chunk of 128.  The reference's chunked form clamps
    exp(lp_t) but not exp(-lp_s), so there it leaves the scan by orders of
    magnitude (ROADMAP.md section 3); the port's chunked form equals the
    reference's (rtol 1e-4 of its largest entry), its scan the reference's
    scan, and in chunks of 32 (no clamp) both forms agree."""
    jc, tc, params, _ = _setup("rwkv6")
    params = dict(params, w0=jnp.full_like(params["w0"], -1.0))
    p = _port("rwkv6", params)
    x = _x(1, 128, tc.d_model, seed=5)
    want = np.asarray(JS.rwkv6_chunked(params, jc, x, 128))
    scan = np.asarray(JS.rwkv6_scan(params, jc, x)[0])
    assert np.abs(want - scan).max() > 1e3 * np.abs(scan).max()
    got = TS.rwkv6_chunked(p, tc, torch.from_numpy(x), 128)
    _close(got, want, 1e-4 * np.abs(want).max())
    _close(TS.rwkv6_scan(p, tc, torch.from_numpy(x))[0], scan)
    _close(TS.rwkv6_chunked(p, tc, torch.from_numpy(x), 32), scan)
