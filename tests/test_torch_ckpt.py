"""The port's training loop, checkpoints and fault tolerance: the mirrors
of ``tests/test_train_ckpt_ft.py`` (the reference's elastic-restore and
watchdog tests have no twin here: the mesh is ROADMAP.md queue 1 item 10,
and the watchdog is ported and tested in ``test_torch_chaos.py``), and a
checkpoint written by either package restored by the other.

Reduced yi-6b in f32, seq 64, batch 4 (the reference test's shape), on the
CPU.  Tolerances: restores are exact (arrays equal); a run resumed from a
checkpoint equals the unbroken run at atol 1e-6, as the reference test
holds its own.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import base as jbase
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro_torch import convert
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import ShapeConfig, get_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
SHAPE = ShapeConfig("t", 64, 4, "train")


def _setup(arch="yi_6b", seed=0):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    return cfg, T.init_params(cfg, seed=seed, device="cpu")


def _params(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def test_loss_decreases():
    cfg, model = _setup()
    step = make_train_step(cfg, opt.AdamWConfig(lr=2e-3, warmup_steps=5))
    state = opt.init_adamw(model)
    losses = []
    for i in range(30):
        model, state, m = step(model, state, make_batch(cfg, SHAPE, i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_microbatch_equivalence():
    """Gradient accumulation over 4 microbatches ~= one big batch (the
    reference test's bounds: loss within 1e-3, parameters within 5e-3)."""
    cfg, model = _setup()
    batch = make_batch(cfg, SHAPE, 0)
    p0 = _params(model)
    m1, s1 = model, opt.init_adamw(model)
    m1, _, r1 = make_train_step(cfg)(m1, s1, batch)
    p1 = _params(m1)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(p0[k])
    m4, _, r4 = make_train_step(cfg, microbatch=4)(
        model, opt.init_adamw(model), batch)
    assert abs(float(r1["loss"]) - float(r4["loss"])) < 1e-3
    d = max(float((p1[k] - p.detach()).abs().max())
            for k, p in m4.named_parameters())
    assert d < 5e-3


def test_checkpoint_roundtrip(tmp_path):
    cfg, model = _setup()
    state = opt.init_adamw(model)
    model, state, _ = make_train_step(cfg)(model, state,
                                           make_batch(cfg, SHAPE, 0))
    path = str(tmp_path / "ck")
    ckpt.save(path, 7, (model, state))
    assert ckpt.latest_step(path) == 7
    _, fresh = _setup(seed=1)
    (m2, s2), step = ckpt.restore(path, (fresh, opt.init_adamw(fresh)))
    assert step == 7 and int(s2.step) == 1
    for (k, a), (_, b) in zip(model.named_parameters(),
                              m2.named_parameters()):
        assert torch.equal(a, b), k
    for k in state.m:
        assert torch.equal(state.m[k], s2.m[k])
        assert torch.equal(state.v[k], s2.v[k])


def test_checkpoint_keys_are_the_reference_layout(tmp_path):
    """The npz keys of a (model, opt_state) checkpoint are exactly the
    reference's for the same config."""
    cfg, model = _setup()
    path = str(tmp_path / "ck")
    ckpt.save(path, 1, (model, opt.init_adamw(model)))
    jc = dataclasses.replace(jbase.get_reduced("yi_6b"), dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(0), jc)
    jpath = str(tmp_path / "jck")
    jckpt.save(jpath, 1, (params, JO.init_adamw(params)))
    keys = [sorted(np.load(os.path.join(p, "step_00000001", "arrays.npz"))
                   .files) for p in (path, jpath)]
    assert keys[0] == keys[1]


def test_checkpoint_prunes_and_atomic(tmp_path):
    cfg, model = _setup()
    path = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(path, s, model)
    kept = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    assert len(kept) == 3 and ckpt.latest_step(path) == 5
    assert not any(d.endswith(".tmp") for d in os.listdir(path))


def test_restore_refuses_shardings(tmp_path):
    cfg, model = _setup()
    path = str(tmp_path / "ck")
    ckpt.save(path, 1, model)
    with pytest.raises(NotImplementedError, match="item 10"):
        ckpt.restore(path, model, shardings={})


def test_resume_determinism(tmp_path):
    """Train 10; vs train 5 + save + restore + train 5: identical
    parameters (restart-safe data + exact state roundtrip)."""
    cfg, _ = _setup()
    step = make_train_step(cfg)

    def run(model, state, lo, hi):
        for i in range(lo, hi):
            model, state, _ = step(model, state, make_batch(cfg, SHAPE, i))
        return model, state

    mA = _setup()[1]
    mA, _ = run(mA, opt.init_adamw(mA), 0, 10)
    mB = _setup()[1]
    mB, sB = run(mB, opt.init_adamw(mB), 0, 5)
    path = str(tmp_path / "ck")
    ckpt.save(path, 5, (mB, sB))
    fresh = _setup(seed=3)[1]
    (mB, sB), _ = ckpt.restore(path, (fresh, opt.init_adamw(fresh)))
    mB, _ = run(mB, sB, 5, 10)
    for (k, a), (_, b) in zip(mA.named_parameters(), mB.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, err_msg=k)


def test_failure_injection_and_resume(tmp_path, capsys):
    """Kill the driver mid-run (exit 17, a subprocess); rerunning the same
    command resumes and finishes, and its steps' losses equal an unbroken
    run's (rtol 1e-6).  The rerun and the unbroken run call the CLI's
    ``main`` in this process."""
    from repro_torch.launch import train
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ckdir = str(tmp_path / "ck")
    args = ["--device", "cpu", "--arch", "yi_6b", "--reduced", "--steps",
            "12", "--batch", "2", "--seq", "32", "--ckpt-every", "4",
            "--log-every", "1"]
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *args, "--ckpt-dir", ckdir, "--fail-at-step", "6"],
                       env=env, capture_output=True, text=True, cwd=ROOT)
    assert p.returncode == 17, p.stderr[-500:]
    assert "INJECTED FAILURE at step 6" in p.stdout
    assert ckpt.latest_step(ckdir) == 4
    capsys.readouterr()
    assert train.main(args + ["--ckpt-dir", ckdir]) == 0
    rerun = capsys.readouterr().out
    assert "resumed from step 4" in rerun
    assert ckpt.latest_step(ckdir) == 12
    assert train.main(args + ["--ckpt-dir", str(tmp_path / "w")]) == 0
    whole = capsys.readouterr().out

    def losses(out):
        return {int(ln.split("step=")[1].split()[0]):
                float(ln.split("loss=")[1].split()[0])
                for ln in out.splitlines() if ln.startswith("[train] step=")}

    resumed, unbroken = losses(rerun), losses(whole)
    assert sorted(resumed) == list(range(4, 12))
    for s, loss in resumed.items():
        np.testing.assert_allclose(loss, unbroken[s], rtol=1e-6)


def test_launch_train_refuses_a_mesh():
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="item 10"):
        train.main(["--device", "cpu", "--reduced", "--data", "2"])


def test_gradient_compression_error_feedback():
    """int8 compression: biased per step, but error feedback keeps the
    accumulated gradient sum accurate; q, scale and the residual equal the
    reference's (q exactly, the rest at rtol 1e-6)."""
    rng = np.random.default_rng(0)
    g_true = [rng.normal(0, 1, (64, 64)).astype(np.float32)
              for _ in range(20)]
    resid = torch.zeros((64, 64))
    jresid = jnp.zeros((64, 64), jnp.float32)
    acc_comp = np.zeros((64, 64), np.float32)
    for g in g_true:
        q, scale, resid = opt.compress(torch.as_tensor(g), resid)
        jq, jscale, jresid = JO.compress(jnp.asarray(g), jresid)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-6)
        np.testing.assert_allclose(resid.numpy(), np.asarray(jresid),
                                   rtol=1e-6, atol=1e-7)
        acc_comp += opt.decompress(q, scale).numpy()
    acc_true = np.sum(g_true, axis=0)
    rel = np.abs(acc_comp - acc_true).max() / np.abs(acc_true).max()
    assert rel < 0.02, rel
    with pytest.raises(NotImplementedError, match="item 10"):
        opt.compressed_psum({}, {}, "pod")


def _one_step_state():
    """A reference (params, AdamW state) after one train step."""
    from repro.train.train_step import make_train_step as jmake
    jc = dataclasses.replace(jbase.get_reduced("yi_6b"), dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(0), jc)
    b = {k: jnp.asarray(v) for k, v in make_batch(
        _setup()[0], SHAPE, 0).items()}
    params, state, _ = jax.jit(jmake(jc))(params, JO.init_adamw(params), b)
    return params, state


def test_port_restores_a_reference_checkpoint(tmp_path):
    params, state = _one_step_state()
    path = str(tmp_path / "jck")
    jckpt.save(path, 3, (params, state))
    cfg, model = _setup(seed=5)
    (model, tstate), step = ckpt.restore(path, (model, opt.init_adamw(model)))
    assert step == 3 and int(tstate.step) == int(state.step) == 1
    got = convert.params_to_reference(model)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    ref = convert.adamw_state_to_reference(tstate, cfg)
    for f in ("m", "v"):
        for a, b in zip(jax.tree.leaves(ref[f]),
                        jax.tree.leaves(getattr(state, f))):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_reference_restores_a_port_checkpoint(tmp_path):
    cfg, model = _setup()
    state = opt.init_adamw(model)
    model, state, _ = make_train_step(cfg)(model, state,
                                           make_batch(cfg, SHAPE, 0))
    path = str(tmp_path / "ck")
    ckpt.save(path, 4, (model, state))
    jc = dataclasses.replace(jbase.get_reduced("yi_6b"), dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(9), jc)
    (rp, rs), step = jckpt.restore(path, (params, JO.init_adamw(params)))
    assert step == 4 and int(rs.step) == 1
    for a, b in zip(jax.tree.leaves(rp),
                    jax.tree.leaves(convert.params_to_reference(model))):
        np.testing.assert_array_equal(np.asarray(a), b)
    ref = convert.adamw_state_to_reference(state, cfg)
    for f in ("m", "v"):
        for a, b in zip(jax.tree.leaves(getattr(rs, f)),
                        jax.tree.leaves(ref[f])):
            np.testing.assert_array_equal(np.asarray(a), b)
