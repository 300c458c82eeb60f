"""Three ``make_train_step`` steps of the port against the reference's, in
f32 on reduced yi-6b (seq 32, batch 2), both started from the reference's
``init_params`` tree and its zero AdamW state through ``convert``.

Tolerance, derived from the reference itself: after three steps the
reference's own xla and flash train steps on the same inputs differ by
``gap`` (parameters, m and v, each its largest entry difference over the
tree; measured 3.5e-5, 4.7e-8, 4.1e-9 with lr 1e-3): the port's
parameters, m and v must lie within ``STEP_FACTOR * gap`` of the
reference's run with the same options (measured <= 4.5x gap).  The step
counter is equal; loss and grad norm at rtol 1e-5.  ``microbatch=2``
against the reference's ``microbatch=2`` at the same tolerance, and
against the port's ``microbatch=0`` within ``STEP_FACTOR`` times the
reference's own microbatch 2 / 0 difference.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data.pipeline import make_batch
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS

ARCH = "yi_6b"
SHAPE = tbase.ShapeConfig("t", 32, 2, "train")
STEPS = 3
ADAMW = dict(lr=1e-3, warmup_steps=1)
STEP_FACTOR = 10.0
METRIC_RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup():
    jc = dataclasses.replace(jbase.get_reduced(ARCH), dtype="float32")
    tc = dataclasses.replace(tbase.get_reduced(ARCH), dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(0), jc)
    batches = [make_batch(tc, SHAPE, i) for i in range(STEPS)]
    return jc, tc, params, batches


@functools.lru_cache(maxsize=None)
def _ref(impl, remat, microbatch=0):
    """(params, AdamW state, per-step metrics) of the reference's run."""
    jc, _, params, batches = _setup()
    step = jax.jit(JS.make_train_step(jc, JO.AdamWConfig(**ADAMW), impl=impl,
                                      remat=remat, microbatch=microbatch))
    state, metrics = JO.init_adamw(params), []
    for b in batches:
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return params, {"step": state.step, "m": state.m, "v": state.v}, metrics


def _port(impl, remat, microbatch=0):
    """The port's run from the same state: (params, state, metrics), the
    first two as the reference's trees."""
    _, tc, params, batches = _setup()
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          tc, device="cpu")
    state = convert.adamw_state_from_reference(JO.init_adamw(params), model)
    step = TS.make_train_step(tc, TO.AdamWConfig(**ADAMW), impl=impl,
                              remat=remat, microbatch=microbatch)
    metrics = []
    for b in batches:
        model, state, m = step(model, state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return (convert.params_to_reference(model),
            convert.adamw_state_to_reference(state, tc), metrics)


def _diff(a, b) -> float:
    """Largest entry difference over two trees."""
    return max(float(np.max(np.abs(np.asarray(x, np.float64)
                                   - np.asarray(y, np.float64))))
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


@functools.lru_cache(maxsize=None)
def _gap():
    """The reference's own xla-vs-flash difference after the steps:
    (params, m, v)."""
    (pa, sa, _), (pb, sb, _) = _ref("xla", True), _ref("flash", False)
    return _diff(pa, pb), _diff(sa["m"], sb["m"]), _diff(sa["v"], sb["v"])


def _close(got, want, gap):
    (gp, gs, gm), (wp, ws, wm) = got, want
    assert int(gs["step"]) == int(ws["step"]) == STEPS
    for what, a, b, g in (("params", gp, wp, gap[0]),
                          ("m", gs["m"], ws["m"], gap[1]),
                          ("v", gs["v"], ws["v"], gap[2])):
        d = _diff(a, b)
        assert d <= STEP_FACTOR * g, (what, d, g)
    for a, b in zip(gm, wm):
        assert a["aux"] == b["aux"] == 0.0
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=METRIC_RTOL,
                                       err_msg=k)


@pytest.mark.parametrize("impl,remat", [("xla", True), ("flash", False)])
def test_train_steps_match_reference(impl, remat):
    """Three steps: parameters, m, v, step and metrics (xla with remat,
    flash without: both implementations and both remat settings; the
    gradients of every combination are held in ``test_torch_train.py``)."""
    _close(_port(impl, remat), _ref(impl, remat), _gap())


def test_microbatch_matches_reference_and_the_whole_batch():
    """``microbatch=2`` against the reference's ``microbatch=2``, and
    against the port's whole-batch step within the reference's own
    microbatch 2 / 0 difference (times ``STEP_FACTOR``)."""
    got = _port("xla", True, 2)
    _close(got, _ref("xla", True, 2), _gap())
    whole = _port("xla", True, 0)
    ref2, ref0 = _ref("xla", True, 2), _ref("xla", True, 0)
    for i, what in ((0, "params"), (1, "m")):
        a, b = (got[i], whole[i]) if i == 0 else (got[i]["m"],
                                                  whole[i]["m"])
        r = (ref2[0], ref0[0]) if i == 0 else (ref2[1]["m"], ref0[1]["m"])
        assert _diff(a, b) <= STEP_FACTOR * max(_diff(*r), 1e-7), what


def test_loss_falls_over_steps():
    """The port's loss falls at every one of four flash steps on the same
    batch (lr 1e-3, warmup 1)."""
    _, tc, params, batches = _setup()
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          tc, device="cpu")
    state = TO.init_adamw(model)
    step = TS.make_train_step(tc, TO.AdamWConfig(**ADAMW), impl="flash")
    losses = []
    for _ in range(4):
        model, state, m = step(model, state, batches[0])
        losses.append(float(m["loss"]))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
