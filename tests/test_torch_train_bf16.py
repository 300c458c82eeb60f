"""The port's training slice in bf16 against the JAX reference, on reduced
yi-6b and granite-3-2b (seq 32, batch 2): ``loss_fn`` and its gradients
(xla and flash; every (remat, remat_policy) on yi-6b, remat off on
granite), and three ``make_train_step`` steps.

Both sides run the reference's ``cast_params`` tree (the port's through
``convert.params_from_reference``: the same bits).  The reference is
compiled as written, ``xla_allow_excess_precision`` off (as in
``test_torch_lm_bf16.py``): by default XLA keeps f32 between the ops of a
fused bf16 chain.

The bounds are the reference's own bf16 error on the same inputs, against
its f32 model on the uncast weights (``ref_f32``):
  * each gradient leaf: max |port - ref_bf16| <= max |ref_bf16 - ref_f32|
    (measured 0.01-0.66 of it);
  * the loss: |port - ref_bf16| <= |ref_bf16 - ref_f32| + 2e-5 (one f32
    sum of bf16 logits; measured 0 and 1.5e-5);
  * after three steps, over the whole tree, parameters, m and v:
    max |port - ref_bf16| <= 2 max |ref_bf16 - ref_f32| (measured 1.0,
    0.7 and 1.5 of it: a bf16 parameter an update rounds to the
    neighbouring value in one package and not the other moves by one
    bf16 step, as much as the f32 run differs).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data.pipeline import make_batch
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS

SHAPE = tbase.ShapeConfig("t", 32, 2, "train")
_STRICT = {"xla_allow_excess_precision": False}
REMATS = [(False, "none"), (True, "none"), (True, "dots")]
CASES = [("yi_6b", impl, r, p) for impl in ("xla", "flash")
         for r, p in REMATS] + \
    [("granite_3_2b", impl, False, "none") for impl in ("xla", "flash")]
LOSS_ATOL = 2e-5
STEP_FACTOR = 2.0
ADAMW = dict(lr=1e-3, warmup_steps=1)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(bf16 config, its f32 twin, f32 params, cast params, port config,
    batches)."""
    jc = jbase.get_reduced(arch)
    assert jc.dtype == "bfloat16"
    params = JT.init_params(jax.random.PRNGKey(0), jc)
    tc = tbase.get_reduced(arch)
    batches = [make_batch(tc, SHAPE, i) for i in range(3)]
    return (jc, dataclasses.replace(jc, dtype="float32"), params,
            JT.cast_params(params, jnp.bfloat16), tc, batches)


def _model(arch):
    *_, cast, tc, _ = _setup(arch)
    return convert.params_from_reference(jax.tree.map(np.asarray, cast), tc,
                                         device="cpu")


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_f32_grads(arch, impl):
    _, jc32, params, _, _, batches = _setup(arch)
    (tot, _), g = jax.jit(jax.value_and_grad(
        lambda p: JS.loss_fn(p, jc32, _jb(batches[0]), impl=impl,
                             remat=False), has_aux=True))(params)
    return float(tot), g


def _leaf_max(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("arch,impl,remat,policy", CASES,
                         ids=[f"{a}-{i}-remat{int(r)}-{p}"
                              for a, i, r, p in CASES])
def test_bf16_loss_fn_gradients_within_the_reference_bf16_error(
        arch, impl, remat, policy):
    jc, _, _, cast, tc, batches = _setup(arch)
    jb = _jb(batches[0])
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JS.loss_fn(p, jc, b, impl=impl, remat=remat,
                                remat_policy=policy), has_aux=True))
    (jtot, _), jg = fn.lower(cast, jb).compile(
        compiler_options=_STRICT)(cast, jb)
    f32_tot, g32 = _ref_f32_grads(arch, impl)
    model = _model(arch)
    tot, _ = TS.loss_fn(model, tc, batches[0], impl=impl, remat=remat,
                        remat_policy=policy)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(tot, list(named.values()))
    assert all(g.dtype == p.dtype for g, p in zip(grads, named.values()))
    got = convert.named_to_tree(dict(zip(named, grads)), tc)
    assert abs(tot.item() - float(jtot)) <= \
        abs(float(jtot) - f32_tot) + LOSS_ATOL
    for a, b, c in zip(jax.tree.leaves(got), jax.tree.leaves(jg),
                       jax.tree.leaves(g32)):
        assert _leaf_max(a, b) <= _leaf_max(b, c), (_leaf_max(a, b),
                                                    _leaf_max(b, c))


@functools.lru_cache(maxsize=None)
def _ref_steps(arch, impl, bf16):
    """The reference's three steps (remat off): (params, state, last
    metrics); bf16 compiled strict."""
    jc, jc32, params, cast, _, batches = _setup(arch)
    cfg, p = (jc, cast) if bf16 else (jc32, params)
    state = JO.init_adamw(p)
    step = jax.jit(JS.make_train_step(cfg, JO.AdamWConfig(**ADAMW),
                                      impl=impl, remat=False))
    if bf16:
        step = step.lower(p, state, _jb(batches[0])).compile(
            compiler_options=_STRICT)
    for b in batches:
        p, state, m = step(p, state, _jb(b))
    return p, state, {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_bf16_train_steps_within_the_reference_bf16_error(impl):
    arch = "yi_6b"
    tc = _setup(arch)[4]
    model = _model(arch)
    state = TO.init_adamw(model)
    step = TS.make_train_step(tc, TO.AdamWConfig(**ADAMW), impl=impl,
                              remat=False)
    for b in _setup(arch)[5]:
        model, state, m = step(model, state, b)
    assert all(p.dtype == torch.bfloat16 for n, p in
               model.named_parameters() if n != "final_norm")
    assert model.final_norm.dtype == torch.float32
    rb, rf = _ref_steps(arch, impl, True), _ref_steps(arch, impl, False)
    got = (convert.params_to_reference(model),
           convert.adamw_state_to_reference(state, tc))
    assert int(got[1]["step"]) == int(rb[1].step) == 3
    for what, a, b, c in (("params", got[0], rb[0], rf[0]),
                          ("m", got[1]["m"], rb[1].m, rf[1].m),
                          ("v", got[1]["v"], rb[1].v, rf[1].v)):
        d = max(_leaf_max(x, y) for x, y in zip(jax.tree.leaves(a),
                                                jax.tree.leaves(b)))
        bound = max(_leaf_max(y, z) for y, z in zip(jax.tree.leaves(b),
                                                    jax.tree.leaves(c)))
        assert d <= STEP_FACTOR * bound, (what, d, bound)
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - rb[2][k]) <= \
            STEP_FACTOR * abs(rb[2][k] - rf[2][k]) + LOSS_ATOL, k
