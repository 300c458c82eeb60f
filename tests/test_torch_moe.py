"""The port's MoE blocks and cross attention (``repro_torch.models.layers``)
against the JAX reference's, on the reference's own ``init_mlp`` /
``init_attention`` weights.

``moe_block`` is the reference's single-device dispatch
(``_moe_block_gspmd``): capacity ``max(int(cf s k / e), 1)`` a group,
token-major slots, drops past capacity, the softmax over the top-k logits,
the aux loss of the top-1 choices.  Outputs agree at atol 2e-5, the aux
loss at rtol 1e-5; ties in the router go to the lower expert, as
``jax.lax.top_k`` orders them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as JL
from repro_torch.configs import base as tbase
from repro_torch.models import layers as TL

ATOL = 2e-5
ARCHS = ["granite_moe_1b_a400m", "qwen3_moe_235b_a22b"]


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


def _setup(arch, seed=0):
    jc = dataclasses.replace(jbase.get_reduced(arch), dtype="float32")
    tc = dataclasses.replace(tbase.get_reduced(arch), dtype="float32")
    params = JL.init_mlp(jax.random.PRNGKey(seed), jc)
    p = TL.MoE(*(torch.tensor(np.asarray(params[n]))
                 for n in ("router", "w1", "w3", "w2")))
    return jc, tc, params, p


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).normal(0, 1, (b, s, d)).astype(
        np.float32)


def _dropped(params, jc, x, cf):
    """Requests the reference's dispatch drops (slot >= cap)."""
    b, s, _ = x.shape
    e, k = jc.num_experts, jc.experts_per_token
    cap = max(int(cf * s * k / e), 1)
    logits = x @ np.asarray(params["router"])
    idx = np.asarray(jax.lax.top_k(jnp.asarray(logits), k)[1]).reshape(b, -1)
    drops = 0
    for g in range(b):
        counts = np.zeros(e, int)
        for eid in idx[g]:
            drops += counts[eid] >= cap
            counts[eid] += 1
    return drops


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, cf):
    """moe_block at capacity factors 0.5 (requests dropped), 1.25 (the
    default: qwen3-moe's reduced config drops here) and 8.0 (none dropped,
    equal to moe_block_dense), out and aux."""
    jc, tc, params, p = _setup(arch)
    x = _x(2, 24, tc.d_model)
    want, waux = jax.jit(lambda p, x: JL.moe_block(p, jc, x, cf))(params, x)
    got, aux = TL.moe_block(p, tc, torch.from_numpy(x), cf)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(waux), rtol=1e-5)
    drops = _dropped(params, jc, x, cf)
    assert drops > 0 if cf == 0.5 or arch.startswith("qwen3") and cf == 1.25 \
        else drops == 0, drops
    if cf == 8.0:
        dense, _ = TL.moe_block_dense(p, tc, torch.from_numpy(x))
        torch.testing.assert_close(got, dense, atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_dense_matches_reference(arch):
    """The all-experts oracle and its aux loss."""
    jc, tc, params, p = _setup(arch, seed=4)
    x = _x(3, 5, tc.d_model, seed=2)
    want, waux = jax.jit(lambda p, x: JL.moe_block_dense(p, jc, x))(params, x)
    got, aux = TL.moe_block_dense(p, tc, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(waux), rtol=1e-5)


def test_router_ties_go_to_the_lower_expert():
    """A router whose columns repeat (experts 0 = 3 and 1 = 5 score
    alike for every token): the top-k picks, the slots, the drops and the
    outputs are the reference's, which take the lower expert on a tie;
    the experts' weights differ, so a wrong pick shows in the output."""
    jc, tc, params, p = _setup("qwen3_moe_235b_a22b", seed=3)
    router = np.asarray(params["router"]).copy()
    router[:, 3] = router[:, 0]
    router[:, 5] = router[:, 1]
    params = dict(params, router=jnp.asarray(router))
    with torch.no_grad():
        p.router.copy_(torch.from_numpy(router))
    x = _x(2, 16, tc.d_model, seed=6)
    logits = x @ router
    _, jidx = jax.lax.top_k(jnp.asarray(logits), jc.experts_per_token)
    _, tidx = TL._top_k(torch.from_numpy(logits), tc.experts_per_token)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert np.isin(np.asarray(jidx), [0, 1]).any()
    for cf in (1.25, 8.0):
        want, waux = JL.moe_block(params, jc, x, cf)
        got, aux = TL.moe_block(p, tc, torch.from_numpy(x), cf)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(aux.item(), float(waux), rtol=1e-5)


def test_moe_decode_token_is_never_dropped():
    """At s = 1 (a decode step) cap = max(int(1.25 k / e), 1) = 1 and the
    token's k experts are distinct: nothing is dropped, so moe_block
    equals moe_block_dense, as in the reference."""
    jc, tc, params, p = _setup("granite_moe_1b_a400m", seed=5)
    x = _x(4, 1, tc.d_model, seed=7)
    assert _dropped(params, jc, x, 1.25) == 0
    got, _ = TL.moe_block(p, tc, torch.from_numpy(x))
    dense, _ = TL.moe_block_dense(p, tc, torch.from_numpy(x))
    torch.testing.assert_close(got, dense, atol=ATOL, rtol=0)
    want, _ = JL.moe_block(params, jc, x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def test_moe_gradients_match_reference():
    """d(sum(out * w) + aux) by x and every MoE weight against
    ``jax.grad`` of the reference's block (drops included)."""
    jc, tc, params, p = _setup("granite_moe_1b_a400m", seed=8)
    x = _x(2, 12, tc.d_model, seed=9)
    w = _x(2, 12, tc.d_model, seed=10)

    def jloss(params, x):
        out, aux = JL.moe_block(params, jc, x)
        return jnp.sum(out * w) + aux

    jgx, jgp = jax.jit(jax.grad(lambda a, b: jloss(b, a), argnums=(0, 1)))(
        x, params)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = TL.moe_block(p, tc, xt)
    names = ("router", "w1", "w3", "w2")
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                [xt] + [getattr(p, n) for n in names])
    for got, want in zip(grads, [jgx] + [jgp[n] for n in names]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-5 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("enc_len", [1, 7])
def test_cross_attention_matches_reference(enc_len):
    """The enc-dec decoder's cross attention over a memory of enc_len rows
    (no RoPE, no mask), also with an f32 memory under bf16 queries as the
    reference's promotion gives."""
    jc = dataclasses.replace(jbase.get_reduced("seamless_m4t_medium"),
                             dtype="float32")
    tc = dataclasses.replace(tbase.get_reduced("seamless_m4t_medium"),
                             dtype="float32")
    params = JL.init_attention(jax.random.PRNGKey(2), jc)
    p = TL.Attention(*(torch.tensor(np.asarray(params[n]))
                       for n in ("wq", "wk", "wv", "wo")))
    x = _x(2, 3, tc.d_model, seed=11)
    mem = _x(2, enc_len, tc.d_model, seed=12)
    want = JL.cross_attention_block(params, jc, x, mem)
    got = TL.cross_attention_block(p, tc, torch.from_numpy(x),
                                   torch.from_numpy(mem))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    x16 = jnp.asarray(x, jnp.bfloat16)
    want = JL.cross_attention_block(params, jc, x16, mem)
    got = TL.cross_attention_block(
        p, tc, torch.from_numpy(np.asarray(x16, np.float32)).to(
            torch.bfloat16), torch.from_numpy(mem))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=2 ** -7 * np.abs(np.asarray(
                                   want, np.float32)).max())
