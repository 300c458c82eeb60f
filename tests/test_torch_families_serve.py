"""The port's serve driver (``repro_torch.launch.serve``) on the non-dense
LM families, and its ``--robust`` screen, against the JAX reference's
driver.

``run_lm`` with the reference's own ``PRNGKey(0)`` weights gives the
reference driver's ``[serve] sample generations`` line with the same flags,
xla and kde, for every family (the enc-dec memory from the encoder over
the frontend embeddings; the vision prefix not replayed, as in the
reference).  ``--robust`` recomputes a step whose logits are not finite
with dense xla attention from the pre-step cache: a planted non-finite KDE
output at one step gives exactly the run whose that step is xla, the
Mamba2 states restored (the port's decode writes them in place).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data.pipeline import make_batch, token_split
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.train.train_step import make_decode_step

FAMILIES = ["granite_moe_1b_a400m", "qwen3_moe_235b_a22b", "rwkv6_3b",
            "zamba2_7b", "seamless_m4t_medium", "internvl2_1b"]
ARGV = ["--reduced", "--batch", "2", "--prompt-len", "24", "--gen", "4"]


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


def _reference_model(arch, cfg):
    jc = dataclasses.replace(jbase.get_reduced(arch), dtype="float32")
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jc))
    return convert.params_from_reference(tree, cfg, device="cpu")


@pytest.mark.parametrize("attention", ["xla", "kde"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_generations_match_reference(arch, attention, capsys):
    """The port's driver on the reference's weights prints the reference
    driver's generations."""
    argv = ARGV + ["--arch", arch, "--attention", attention]
    assert jserve.main(argv) == 0
    want = [s for s in capsys.readouterr().out.splitlines()
            if s.startswith("[serve] sample generations:")]
    args = tserve.parser().parse_args(argv + ["--device", "cpu"])
    cfg, _ = tserve.serve_config(args)
    res = tserve.run_lm(args, model=_reference_model(arch, cfg))
    assert want == [f"[serve] sample generations: "
                    f"{res['tokens'][:2].tolist()}"]
    shape = tbase.ShapeConfig("serve", 24, 2, "prefill")
    assert res["prompt_tokens"] == token_split(cfg, shape)["tokens"]
    assert res["fallbacks"] is None
    if cfg.is_encdec:
        assert tuple(res["cache"]["memory"].shape) == (2, 6, cfg.d_model)


def _plant_nan(monkeypatch, at_call):
    """``kde_decode_attention`` returning NaN on its ``at_call``-th call
    (counted from 0), else the real output; returns the call counter."""
    real = TL.kde_decode_attention
    calls = [0]

    def planted(*a, **kw):
        out = real(*a, **kw)
        calls[0] += 1
        return out * float("nan") if calls[0] - 1 == at_call else out

    monkeypatch.setattr(TL, "kde_decode_attention", planted)
    return calls


def _args(arch, *extra):
    return tserve.parser().parse_args(
        ARGV + ["--arch", arch, "--attention", "kde", "--kde-bk", "8",
                "--device", "cpu", *extra])


@pytest.mark.parametrize("arch", ["zamba2_7b", "granite_moe_1b_a400m"])
def test_robust_recomputes_a_planted_step_from_the_pre_step_state(
        arch, monkeypatch):
    """A NaN planted in the KDE attention of replay step 5: ``--robust``
    counts one fallback, and its generations, prompt logits and final
    cache (K/V and the Mamba2 states) equal a run whose step 5 is an xla
    step and every other a kde step.  Without ``--robust`` the NaN
    reaches the logits."""
    cfg, max_len = tserve.serve_config(_args(arch))
    model = TT.init_params(cfg, seed=1, device="cpu")
    napp = len(TT.init_cache(cfg, 1, 8, device="cpu")["k"])
    calls = _plant_nan(monkeypatch, 5 * napp)
    res = tserve.run_lm(_args(arch, "--robust"), model=model)
    assert res["fallbacks"] == 1 and calls[0] > 5 * napp
    assert np.isfinite(res["prompt_logits"].numpy()).all()

    monkeypatch.undo()
    steps = {impl: make_decode_step(cfg, impl=impl, kde_cfg={
        "top_p": 4, "bk": 8, "stride": 4}) for impl in ("xla", "kde")}
    toks = torch.as_tensor(make_batch(cfg, tbase.ShapeConfig(
        "serve", 24, 2, "prefill"), 0, 0)["tokens"])
    cache = TT.init_cache(cfg, 2, max_len, torch.float32, device="cpu")
    for pos in range(24):
        nxt, logits, cache = steps["xla" if pos == 5 else "kde"](
            model, cache, toks[:, pos:pos + 1], pos)
    torch.testing.assert_close(res["prompt_logits"], logits[:, -1],
                               rtol=0, atol=0)
    out = [nxt]
    for i in range(3):
        nxt, _, cache = steps["kde"](model, cache, nxt[:, None], 24 + i)
        out.append(nxt)
    np.testing.assert_array_equal(res["tokens"], torch.stack(out, 1).numpy())
    for name, t in cache.items():
        torch.testing.assert_close(res["cache"][name], t, rtol=0, atol=0)

    _plant_nan(monkeypatch, 5 * napp)
    res = tserve.run_lm(_args(arch), model=model)
    assert res["fallbacks"] is None
    assert not np.isfinite(res["prompt_logits"].numpy()).all()


def test_robust_on_a_healthy_model_changes_nothing(capsys):
    """No non-finite logits: no fallback, the same generations and cache
    (rwkv6: SSM and shift states snapshotted every step, never restored);
    the CLI prints the count, and xla serving never screens, as the
    reference's driver."""
    for arch in ("rwkv6_3b", "internvl2_1b"):
        cfg, _ = tserve.serve_config(_args(arch))
        model = TT.init_params(cfg, seed=2, device="cpu")
        plain = tserve.run_lm(_args(arch), model=model)
        robust = tserve.run_lm(_args(arch, "--robust"), model=model)
        assert robust["fallbacks"] == 0
        np.testing.assert_array_equal(plain["tokens"], robust["tokens"])
        for name, t in plain["cache"].items():
            torch.testing.assert_close(robust["cache"][name], t, rtol=0,
                                       atol=0)
    assert tserve.main(["--device", "cpu", "--reduced", "--arch", "zamba2_7b",
                        "--batch", "2", "--prompt-len", "8", "--gen", "3",
                        "--attention", "kde", "--kde-bk", "8",
                        "--robust"]) == 0
    out = capsys.readouterr().out
    assert "[serve] arch=zamba2_7b attention=kde batch=2 prompt=8 gen=3" in out
    assert "[serve] robust: 0 step(s) recomputed with dense attention" in out
    args = tserve.parser().parse_args(ARGV + ["--device", "cpu", "--robust"])
    assert tserve.run_lm(args)["fallbacks"] is None
