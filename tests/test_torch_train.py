"""The port's training slice in f32 against the JAX reference: the loss,
every gradient of ``loss_fn`` (xla and flash attention, ``remat`` on and
off, ``remat_policy`` "none" and "dots"), the flash and rmsnorm backward
passes, AdamW's weight-decay rule, and the port's package boundary.

Both packages start from the reference's ``init_params`` tree, carried
into the port by ``convert.params_from_reference``; batches are
``make_batch``'s (the same bits in both).  The reference's flash runs in
Pallas interpret mode on the CPU.

Tolerances: the loss at rtol 2e-6 (two f32 sums of 62 logsumexps); each
gradient leaf at 2e-5 of its largest entry (measured 1.2-1.8e-6 on reduced
yi-6b / granite-3-2b: f32 sums in other orders, XLA's and torch's own
exp / rsqrt).
"""
from __future__ import annotations

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels.flash_attention import ops as jfa
from repro.models import transformer as JT
from repro.train import train_step as JS
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["yi_6b", "granite_3_2b"]
SHAPE = tbase.ShapeConfig("t", 32, 2, "train")
#: (remat, remat_policy): the reference reads the policy only with remat
REMATS = [(False, "none"), (True, "none"), (True, "dots")]
LOSS_RTOL = 2e-6
GRAD_REL = 2e-5


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(reference config, port config, reference params, batch) of the
    reduced config in f32."""
    jc = dataclasses.replace(jbase.get_reduced(arch), dtype="float32")
    tc = dataclasses.replace(tbase.get_reduced(arch), dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, params, make_batch(tc, SHAPE, 0)


def _model(tc, params):
    return convert.params_from_reference(jax.tree.map(np.asarray, params),
                                         tc, device="cpu")


def _port_grads(model, tc, batch, **kw):
    """(total, loss, aux, gradients as the reference's tree)."""
    tot, (loss, aux) = TS.loss_fn(model, tc, batch, **kw)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(tot, list(named.values()))
    return tot, loss, aux, convert.named_to_tree(
        dict(zip(named, grads)), tc)


def _rel_err(want, got):
    """max |got - want| / max |want| of each leaf."""
    return jax.tree.map(
        lambda a, b: float(np.max(np.abs(np.asarray(a, np.float64) - b))
                           / max(np.max(np.abs(np.asarray(a))), 1e-30)),
        want, got)


def test_cross_entropy_matches_reference():
    """Mean next-token loss over (b, s, v) logits with a -1e30 padded tail,
    rtol 1e-6."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (2, 9, 40)).astype(np.float32)
    logits[..., 37:] = -1.0e30
    tgt = rng.integers(0, 37, (2, 9)).astype(np.int32)
    want = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(tgt))
    got = TS.cross_entropy(torch.as_tensor(logits), tgt)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("remat,policy", REMATS,
                         ids=[f"remat{int(r)}-{p}" for r, p in REMATS])
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_gradients_match_reference(arch, impl, remat, policy):
    """``loss_fn`` and every gradient against ``jax.grad`` of the
    reference's ``loss_fn`` with the same options."""
    jc, tc, params, batch = _setup(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtot, (jloss, jaux)), jg = jax.jit(jax.value_and_grad(
        lambda p: JS.loss_fn(p, jc, jb, impl=impl, remat=remat,
                             remat_policy=policy), has_aux=True))(params)
    tot, loss, aux, grads = _port_grads(_model(tc, params), tc, batch,
                                        impl=impl, remat=remat,
                                        remat_policy=policy)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tot.item(), float(jtot), rtol=LOSS_RTOL)
    assert float(aux) == float(jaux) == 0.0
    assert jax.tree.structure(jg) == jax.tree.structure(grads)
    worst = max(jax.tree.leaves(_rel_err(jg, grads)))
    assert worst < GRAD_REL, worst


@pytest.mark.parametrize("with_lse", [False, True])
def test_flash_backward_matches_reference(with_lse):
    """The flash custom VJP at a ragged GQA shape (sq = skv = 45, 4 / 2
    heads, dh 16): the port's gradients of sum(out * w) (+ sum(lse * u))
    against ``jax.vjp`` of the reference's ``flash_attention`` (interpret
    mode), rtol 2e-5 / atol 1e-6."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(0, 1, s).astype(np.float32) for s in
               ((1, 4, 45, 16), (1, 2, 45, 16), (1, 2, 45, 16)))
    w = rng.normal(0, 1, (1, 4, 45, 16)).astype(np.float32)
    u = rng.normal(0, 1, (1, 4, 45)).astype(np.float32)

    def jf(q, k, v):
        o = jfa.flash_attention(q, k, v, True, 128, 128, True, with_lse)
        return (o if with_lse else (o,))

    _, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    cot = (jnp.asarray(w), jnp.asarray(u)) if with_lse else (jnp.asarray(w),)
    want = vjp(cot)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, True, with_lse=with_lse)
    obj = (out[0] * torch.as_tensor(w)).sum() + \
        (out[1] * torch.as_tensor(u)).sum() if with_lse \
        else (out * torch.as_tensor(w)).sum()
    got = torch.autograd.grad(obj, (tq, tk, tv))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=1e-6)


def test_rmsnorm_backward_keeps_the_input_dtype():
    """The rmsnorm VJP returns a bf16 x-cotangent for a bf16 x (the gain's
    in the gain's dtype), equal to the reference's custom VJP bit for bit
    on bf16-exact inputs; in f32 both cotangents match the reference's at
    rtol 1e-6."""
    rng = np.random.default_rng(2)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        x = jnp.asarray(rng.normal(0, 1, (2, 5, 32)), jdt)
        gain = jnp.asarray(rng.normal(1, 0.1, (32,)), jnp.float32)
        g = jnp.asarray(rng.normal(0, 1, (2, 5, 32)), jdt)
        from repro.models import layers as JL
        _, vjp = jax.vjp(lambda a, b: JL.rmsnorm(a, b, 1e-5), x, gain)
        jdx, jdg = vjp(g)
        tx = torch.tensor(np.asarray(x.astype(jnp.float32))).to(dt)
        tx.requires_grad_()
        tg = torch.tensor(np.asarray(gain), requires_grad=True)
        out = TL.rmsnorm(tx, tg, 1e-5)
        assert out.dtype == dt
        dx, dg = torch.autograd.grad(
            out, (tx, tg), torch.tensor(np.asarray(
                g.astype(jnp.float32))).to(dt))
        assert dx.dtype == dt and dg.dtype == torch.float32
        np.testing.assert_allclose(dx.float().numpy(),
                                   np.asarray(jdx.astype(jnp.float32)),
                                   rtol=1e-6 if dt == torch.float32 else 0,
                                   atol=1e-6 if dt == torch.float32 else
                                   float(2.0 ** -7 * np.max(np.abs(
                                       np.asarray(jdx, np.float32)))))
        np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), rtol=2e-5,
                                   atol=1e-6)


def test_adamw_decays_every_stacked_parameter():
    """Weight decay follows the reference's stacked tree: with zero
    gradients one step scales every layer parameter -- the layer norm
    gains included -- and embed by (1 - lr * wd) and leaves final_norm
    alone.  A rule that tests the port's own ``p.dim() >= 2`` would leave
    ln1 / ln2 undecayed and fail here."""
    _, tc, params, _ = _setup("granite_3_2b")
    model = _model(tc, params)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = TO.init_adamw(model)
    cfg = TO.AdamWConfig(lr=0.5, weight_decay=0.1, warmup_steps=1)
    grads = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    TO.adamw_update(cfg, model, grads, state)
    for name, p in model.named_parameters():
        factor = 1.0 if name == "final_norm" else 1.0 - 0.5 * 0.1
        torch.testing.assert_close(p.detach(), before[name] * factor,
                                   rtol=1e-6, atol=0.0, msg=name)
    assert any(n.endswith(".ln1") for n in before)


def test_adamw_update_matches_reference():
    """One AdamW update on the same parameters and gradients (clipping
    active: grad norm above 1) against the reference's: parameters, m, v
    and step, rtol 1e-6 / atol 1e-7."""
    from repro.train import optimizer as JO
    jc, tc, params, _ = _setup("yi_6b")
    grads = jax.tree.map(
        lambda p: jnp.asarray(np.random.default_rng(p.size).normal(
            0, 1, p.shape), jnp.float32), params)
    cfg = dict(lr=1e-2, warmup_steps=3)
    jp, js = JO.adamw_update(JO.AdamWConfig(**cfg), params, grads,
                             JO.init_adamw(params))
    model = _model(tc, params)
    tgrads = {k: torch.as_tensor(v) for k, v in convert.tree_to_named(
        jax.tree.map(np.asarray, grads), tc).items()}
    model, ts = TO.adamw_update(TO.AdamWConfig(**cfg), model, tgrads,
                                TO.init_adamw(model))
    ref = convert.adamw_state_to_reference(ts, tc)
    assert int(ref["step"]) == int(js.step) == 1
    for want, got in ((jp, convert.params_to_reference(model)),
                      (js.m, ref["m"]), (js.v, ref["v"])):
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
    np.testing.assert_allclose(
        float(TO.global_norm(tgrads)), float(JO.global_norm(grads)),
        rtol=1e-6)


def test_forward_remat_options_match_reference_logits():
    """``forward`` with every (remat, remat_policy) and the reference's
    SSM default ``seq_mixer`` gives the reference's logits (rtol 1e-5 of
    the largest) and the same logits as the default call, bit for bit;
    a non-default ``seq_mixer`` (the SSM families' scan, ported since the
    families slice) changes nothing on a dense model, in either package."""
    jc, tc, params, batch = _setup("yi_6b")
    model = _model(tc, params)
    want = np.asarray(JT.forward(params, jc, {"tokens": jnp.asarray(
        batch["tokens"])})[0])
    base = TT.forward(model, tc, batch)[0].detach()
    for remat, policy in REMATS:
        got = TT.forward(model, tc, batch, remat=remat,
                         remat_policy=policy, seq_mixer="chunked")[0]
        assert torch.equal(got.detach(), base)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    got = TT.forward(model, tc, batch, seq_mixer="scan")[0]
    assert torch.equal(got.detach(), base)
    np.testing.assert_array_equal(np.asarray(JT.forward(
        params, jc, {"tokens": jnp.asarray(batch["tokens"])},
        seq_mixer="scan")[0]), want)


def test_dots_policy_saves_the_weight_products_only():
    """``remat_policy="dots"`` keeps the 2-D weight products (aten.mm /
    addmm) and recomputes everything else (the batched attention products
    among them), the reference's ``checkpoint_dots_with_no_batch_dims``."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    assert TT._dots_policy(None, aten.mm.default) \
        == CheckpointPolicy.MUST_SAVE
    assert TT._dots_policy(None, aten.addmm.default) \
        == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.exp.default, aten.mul.Tensor):
        assert TT._dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


def test_port_imports_neither_jax_nor_the_reference():
    """A fresh interpreter that imports every module of ``repro_torch``
    (the training slice's among them) has neither ``jax`` nor ``repro`` in
    ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "need = {'repro_torch.train.optimizer', 'repro_torch.ckpt.checkpoint',"
        " 'repro_torch.launch.train', 'repro_torch.train.train_step'}\n"
        "assert need <= set(names), need - set(names)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('OK', len(names))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT), env=env, timeout=300)
    assert p.returncode == 0 and p.stdout.startswith("OK"), \
        p.stdout + p.stderr[-2000:]
