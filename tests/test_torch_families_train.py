"""The non-dense LM families' training slice against the JAX reference:
``loss_fn`` and every gradient (``impl="xla"``, ``remat=False``),
``cast_params``' dtypes leaf for leaf, a bf16 forward, AdamW's
weight-decay rule on the encoder's and the shared block's gains, and
checkpoints written by either package restored by the other.

Both packages start from the reference's ``PRNGKey(0)`` tree of the
reduced config, carried into the port by ``convert.params_from_reference``;
batches are ``make_batch``'s (the frontend embeddings too).  Tolerances:
the loss at rtol 2e-6, each gradient leaf at 2e-5 of its largest entry
(f32 sums in other orders), as ``test_torch_train.py``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import base as jbase
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch import convert
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import base as tbase
from repro_torch.data.pipeline import make_batch
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS

FAMILIES = ["granite_moe_1b_a400m", "qwen3_moe_235b_a22b", "rwkv6_3b",
            "zamba2_7b", "seamless_m4t_medium", "internvl2_1b"]
SHAPE = tbase.ShapeConfig("t", 16, 2, "train")
LOSS_RTOL = 2e-6
GRAD_REL = 2e-5


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
    """(reference config, port config, reference params, batch) of the
    reduced config in f32."""
    jc = dataclasses.replace(jbase.get_reduced(arch), dtype="float32")
    tc = dataclasses.replace(tbase.get_reduced(arch), dtype="float32")
    return (jc, tc, JT.init_params(jax.random.PRNGKey(0), jc),
            make_batch(tc, SHAPE, 0))


def _model(tc, params):
    return convert.params_from_reference(jax.tree.map(np.asarray, params),
                                         tc, device="cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_fn_gradients_match_reference(arch):
    """``loss_fn`` (loss, aux, the total with aux_weight 0.01) and every
    gradient of the total against ``jax.value_and_grad`` of the
    reference's, the tree structures equal."""
    jc, tc, params, batch = _setup(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtot, (jloss, jaux)), jg = jax.jit(jax.value_and_grad(
        lambda p: JS.loss_fn(p, jc, jb, impl="xla", remat=False),
        has_aux=True))(params)
    model = _model(tc, params)
    tot, (loss, aux) = TS.loss_fn(model, tc, batch, impl="xla", remat=False)
    named = dict(model.named_parameters())
    grads = convert.named_to_tree(dict(zip(named, torch.autograd.grad(
        tot, list(named.values())))), tc)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tot.item(), float(jtot), rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5, atol=1e-8)
    assert (float(jaux) > 0) == tc.is_moe
    assert jax.tree.structure(jg) == jax.tree.structure(grads)
    worst = max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(np.max(np.abs(np.asarray(a, np.float64) - b))
                           / max(np.max(np.abs(np.asarray(a))), 1e-30)),
        jg, grads)))
    assert worst < GRAD_REL, worst


@pytest.mark.parametrize("arch", FAMILIES)
def test_cast_params_dtypes_match_reference(arch):
    """bf16 ``cast_params``: every leaf's dtype is the reference's (its
    stacked tree casts the layer and encoder-layer gains and the SSM
    vectors; the final norms and the shared block's gains stay f32), and
    ``stacked_ndim`` is each leaf's dims in that tree."""
    jc, tc, params, _ = _setup(arch)
    jcast = JT.cast_params(params, jnp.bfloat16)
    model = TT.cast_params(_model(tc, params), torch.bfloat16)
    got = {k: p for k, p in model.named_parameters()}
    ref_names = {}
    for tmpl, path, count in convert._tree_paths(tc):
        leaf = jcast
        for key in path:
            leaf = leaf[key]
        for i in range(count or 1):
            ref_names[tmpl.format(i=i)] = leaf
    assert got.keys() == ref_names.keys()
    for name, p in got.items():
        leaf = ref_names[name]
        assert str(p.dtype).removeprefix("torch.") == leaf.dtype.name, name
        assert TT.stacked_ndim(name, p) == leaf.ndim, name


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "zamba2_7b"])
def test_bf16_forward_matches_reference(arch):
    """The cast model's bf16 forward against the reference's bf16 forward
    on the same cast tree, compiled with ``xla_allow_excess_precision``
    off (every bf16 op rounds, as ``test_torch_lm_bf16.py`` compiles it):
    within the reference's own bf16-vs-f32 gap on the same batch, and
    within half of it."""
    jc32, tc32, params, batch = _setup(arch)
    jc, tc = (dataclasses.replace(c, dtype="bfloat16") for c in (jc32, tc32))
    cast = JT.cast_params(params, jnp.bfloat16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def run(p, c):
        return jax.jit(lambda p: JT.forward(p, c, jb, remat=False)[0]).lower(
            p).compile(compiler_options={"xla_allow_excess_precision":
                                         False})(p)

    ref16 = np.asarray(run(cast, jc), np.float32)
    ref32 = np.asarray(run(params, jc32), np.float32)
    model = convert.params_from_reference(jax.tree.map(np.asarray, cast), tc,
                                          device="cpu")
    with torch.inference_mode():
        got, _ = TT.forward(model, tc, batch)
    v = tc.vocab_size
    gap = np.abs(got.numpy() - ref16)[..., :v].max()
    bound = np.abs(ref16 - ref32)[..., :v].max()
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    assert gap <= 0.5 * bound, (gap, bound)


def test_adamw_decays_the_reference_tree_rule():
    """AdamW on zero gradients moves only the decayed parameters: every
    ``encoder.layers`` gain (stacked in the reference's tree) and every
    layer leaf, not ``encoder.final_norm`` or the final norm; the hybrid's
    ``shared_attn.ln`` / ``ln2`` are not decayed, its matrices are.  The
    update equals the reference's adamw_update."""
    for arch in ("seamless_m4t_medium", "zamba2_7b"):
        jc, tc, params, _ = _setup(arch)
        model = _model(tc, params)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        grads = {k: torch.zeros_like(p) for k, p in
                 model.named_parameters()}
        cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=1)
        TO.adamw_update(cfg, model, grads, TO.init_adamw(model))
        moved = {k for k, p in model.named_parameters()
                 if not torch.equal(p.detach(), before[k])}
        if tc.is_encdec:
            assert "encoder.layers.0.ln1" in moved
            assert "encoder.layers.1.ln2" in moved
            assert "encoder.final_norm" not in moved
        else:
            assert "shared_attn.attn.wq" in moved
            assert {"shared_attn.ln", "shared_attn.ln2"}.isdisjoint(moved)
        assert "layers.0.ln1" in moved and "final_norm" not in moved
        jparams, _ = jax.jit(lambda p: JO.adamw_update(
            JO.AdamWConfig(lr=1e-2, warmup_steps=1), p,
            jax.tree.map(jnp.zeros_like, p), JO.init_adamw(p)))(params)
        want = convert.tree_to_named(jax.tree.map(np.asarray, jparams), tc)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k],
                                       rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("arch", ["zamba2_7b", "seamless_m4t_medium"])
def test_checkpoint_crosses_packages(arch, writer, tmp_path):
    """A (model, AdamW state) checkpoint of a family model written by one
    package restores in the other, every leaf equal: the npz keys are the
    reference's (``0/shared_attn/ln``, ``0/encoder/layers/attn/wq``,
    ``1/.m/...``)."""
    jc, tc, params, batch = _setup(arch)
    model = _model(tc, params)
    step = TS.make_train_step(tc, TO.AdamWConfig(lr=1e-3, warmup_steps=1),
                              remat=False)
    model, state, _ = step(model, TO.init_adamw(model), batch)
    tree = convert.params_to_reference(model)
    jstate = convert.adamw_state_to_reference(state, tc)
    if writer == "port":
        ckpt.save(str(tmp_path), 1, (model, state))
        (got, gstate), at = jckpt.restore(
            str(tmp_path), (params, JO.init_adamw(params)))
        assert at == 1
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
            np.testing.assert_array_equal(np.asarray(b), a)
        for a, b in zip(jax.tree.leaves(jstate["m"]),
                        jax.tree.leaves(gstate.m)):
            np.testing.assert_array_equal(np.asarray(b), a)
    else:
        jckpt.save(str(tmp_path), 1, (
            jax.tree.map(jnp.asarray, tree),
            JO.AdamWState(**jax.tree.map(jnp.asarray, jstate))))
        fresh = _model(tc, params)
        (got, gstate), at = ckpt.restore(str(tmp_path),
                                         (fresh, TO.init_adamw(fresh)))
        assert at == 1
        for (k, a), b in zip(model.named_parameters(), got.parameters()):
            assert torch.equal(a.detach(), b.detach()), k
        for k, t in state.v.items():
            assert torch.equal(t, gstate.v[k]), k
    keys = set(np.load(tmp_path / "step_00000001" / "arrays.npz").files)
    assert ("0/shared_attn/ln" in keys) == (arch == "zamba2_7b")
    assert ("0/encoder/layers/attn/wq" in keys) == (arch != "zamba2_7b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_cli_takes_every_family(arch, capsys):
    """``launch.train --arch <family> --reduced`` on the CPU: two steps
    (the frontend configs' batches carry their embeddings), finite losses,
    a checkpoint of the family's tree."""
    from repro_torch.launch import train as ttrain
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        assert ttrain.main(["--device", "cpu", "--arch", arch, "--reduced",
                            "--steps", "2", "--batch", "2", "--seq", "16",
                            "--log-every", "1", "--ckpt-dir", d]) == 0
        assert ckpt.latest_step(d) == 2
    out = capsys.readouterr().out
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in
              out.splitlines() if ln.startswith("[train] step=")]
    assert len(losses) == 2 and np.isfinite(losses).all()
