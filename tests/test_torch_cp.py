"""Context-parallel prefill (``activation_sharding(seq_mode=True)``): the
sequence split over "model", held to the unsharded forward.

Eight spawned gloo ranks (``torch_mesh_ranks.lm_cp``, no JAX in the
ranks) run the port's seq-mode forward on (2, 4) ("data", "model") and
(1, 8) meshes, its seq-mode gradients and train step, and decode steps
with and without seq mode; the reduced f32 configs hold the reference's
``PRNGKey(0)`` weights (``convert.params_from_reference``).  The
reference's own seq-mode tests (``tests/test_perf_features.py``) cannot
build their mesh on this tree's JAX (``jax.make_mesh`` gives Explicit
axes), so the port is held to the reference's *unsharded* forward, which
is what its seq-mode forward computes.

Tolerances: logits within 2e-3 of the reference's unsharded forward (the
reference's own seq-mode test, its flash in Pallas interpret mode) and
within 1e-5 of max |logit| of the port's unsharded forward; gradients
within 1e-4 of each leaf's max |g| of the unsharded step; the train
step's loss rtol 1e-5 and grad norm rtol 1e-4; decode steps bitwise.
The flash entry at a shard's query offset (``flash_at``, its plain
version on the CPU) is held to the reference's ``xla_attention(
q_offset=)``, forward and gradient.  The dry run traces a seq-mode
prefill on a fake (2, 4) group.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.configs import base as jbase
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.train.train_step import step_grads

jax.config.update("jax_platforms", "cpu")

REF_ATOL = 2e-3
LOGIT_REL = 1e-5
GRAD_REL = 1e-4
#: name -> (arch, mesh, tokens a row, impls) of the seq-mode forwards
FWD = {
    "yi": ("yi_6b", "2x4", 36, ("xla", "flash")),
    "yi_indivisible": ("yi_6b", "2x4", 30, ("xla", "flash")),
    "moe": ("granite_moe_1b_a400m", "2x4", 256, ("xla",)),
    "rwkv": ("rwkv6_3b", "2x4", 256, ("xla",)),
    "zamba": ("zamba2_7b", "2x4", 256, ("xla", "flash")),
    "encdec": ("seamless_m4t_medium", "2x4", 64, ("xla",)),
    "prefix": ("internvl2_1b", "2x4", 64, ("flash",)),
    "heads": ("qwen2_5_14b", "1x8", 64, ("xla", "flash")),
}
GRADS = (("yi_6b", 36), ("granite_moe_1b_a400m", 64), ("internvl2_1b", 64))
BATCH = 4
DEC_LEN = 32
ARCHS = sorted({a for a, *_ in FWD.values()})


def _cfg(pkg, arch):
    return dataclasses.replace(pkg.get_reduced(arch), dtype="float32")


def _batch(arch, seq):
    return make_batch(_cfg(tbase, arch),
                      tbase.ShapeConfig("t", seq, BATCH, "train"), 0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results, the trees and batches they were given."""
    trees = {a: jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(0), _cfg(jbase, a))) for a in ARCHS}
    seqs = {(a, s) for a, _, s, _ in FWD.values()} | set(GRADS)
    pl = dict(trees=trees, fwd=FWD, grads=GRADS,
              batches={(a, s): _batch(a, s) for a, s in seqs},
              dec_tok=np.random.default_rng(0).integers(
                  0, 256, (BATCH, 6)).astype(np.int64),
              dec_len=DEC_LEN)
    res = ranks.spawn("lm_cp", 8, tmp_path_factory.mktemp("cp"), pl,
                      timeout=360)
    return pl, res


_MODELS = {}


def _model(pl, arch):
    """The port's unsharded model of the ranks' tree (cached)."""
    if arch not in _MODELS:
        _MODELS[arch] = convert.params_from_reference(
            pl["trees"][arch], _cfg(tbase, arch), device="cpu")
    return _MODELS[arch]


def _unsharded(pl, arch, seq, impl):
    with torch.inference_mode():
        logits, aux = TT.forward(_model(pl, arch), _cfg(tbase, arch),
                                 pl["batches"][(arch, seq)], impl=impl)
    return logits.numpy(), float(aux)


def _rel(got, want, v):
    return float(np.abs(got[..., :v] - want[..., :v]).max()
                 / np.abs(want[..., :v]).max())


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_seq_mode_forward_matches_the_reference_unsharded(run, impl):
    """Reduced yi-6b's seq-mode forward on (2, 4), 36 tokens (chunks of 9:
    ragged against every block size), against the reference's unsharded
    forward of the same impl (flash in Pallas interpret mode) at the
    reference's seq-mode atol 2e-3, and within 1e-5 of max |logit| of the
    port's unsharded one; the sequence split (one reduce-scatter of the
    embedding, the weights and keys gathered)."""
    pl, res = run
    arch, _, seq, _ = FWD["yi"]
    jc = _cfg(jbase, arch)
    toks = jnp.asarray(pl["batches"][(arch, seq)]["tokens"])
    params = jax.tree.map(jnp.asarray, pl["trees"][arch])
    want = np.asarray(jax.jit(lambda p, t: JT.forward(
        p, jc, {"tokens": t}, impl=impl)[0])(params, toks))
    got = res[0]["fwd"][("yi", impl)]
    v = jc.vocab_size
    assert got["layout"] == "split"
    np.testing.assert_allclose(got["logits"][..., :v], want[..., :v],
                               atol=REF_ATOL)
    assert _rel(got["logits"], _unsharded(pl, arch, seq, impl)[0], v) \
        <= LOGIT_REL
    assert got["cc"]["psum_scatter"] == 1 and got["cc"]["all_gather"] > 0
    for r in res:
        np.testing.assert_array_equal(r["fwd"][("yi", impl)]["logits"],
                                      got["logits"])


@pytest.mark.parametrize("name", ["moe", "rwkv", "zamba", "encdec",
                                  "prefix", "heads"])
def test_seq_mode_families_match_the_unsharded_forward(run, name,
                                                        monkeypatch):
    """Every family under seq mode against the port's unsharded forward
    (1e-5 of max |logit|; the MoE aux 1e-5): granite-moe's dispatch over
    the whole sequence (the unsharded forward drops requests over the
    global capacity, and so must the split one), rwkv6's and zamba2's
    chunked mixers across shard boundaries (chunks of 128, shards of
    64), seamless's enc-dec (the decoder's queries over the whole
    memory), internvl's 16-position prefix (rank 0's chunk is all
    prefix), reduced qwen2.5's 4 heads on a "model" axis of 8."""
    pl, res = run
    arch, _, seq, impls = FWD[name]
    cfg = _cfg(tbase, arch)
    drops = []
    if name == "moe":
        gspmd = TL._moe_block_gspmd

        def count(p, cfg_, x, capacity_factor=1.25):
            logits = x.float() @ p.router.float()
            idx = TL._top_k(logits, cfg_.experts_per_token)[1]
            eid = idx.reshape(x.shape[0], -1)
            load = TL._one_hot(eid, cfg_.num_experts, torch.int32).sum(1)
            cap = max(int(capacity_factor * x.shape[1]
                          * cfg_.experts_per_token / cfg_.num_experts), 1)
            drops.append(int((load - cap).clamp(min=0).sum()))
            return gspmd(p, cfg_, x, capacity_factor)
        monkeypatch.setattr(TL, "_moe_block_gspmd", count)
    for impl in impls:
        want, aux = _unsharded(pl, arch, seq, impl)
        got = res[0]["fwd"][(name, impl)]
        assert got["layout"] == "split", got["layout"]
        assert _rel(got["logits"], want, cfg.vocab_size) <= LOGIT_REL
        assert abs(got["aux"] - aux) <= 1e-5
    if name == "moe":
        assert sum(drops) > 0, drops


def test_indivisible_token_count_computes_replicated(run):
    """30 tokens on a "model" axis of 4: the forward records the
    "replicated" layout and computes the whole sequence on every rank
    (no reduce-scatter of the embedding, no tensor-parallel all-reduce),
    with the unsharded forward's logits."""
    pl, res = run
    arch, _, seq, impls = FWD["yi_indivisible"]
    cfg = _cfg(tbase, arch)
    for impl in impls:
        got = res[0]["fwd"][("yi_indivisible", impl)]
        assert got["layout"] == "replicated"
        assert got["cc"]["psum_scatter"] == 0
        assert _rel(got["logits"], _unsharded(pl, arch, seq, impl)[0],
                    cfg.vocab_size) <= LOGIT_REL
        # the embedding's all-reduce only: no row-parallel sums
        assert got["cc"]["psum"] == 1
        assert res[0]["fwd"][("yi", impl)]["cc"]["psum"] == 0


def test_seq_mode_with_the_embedding_split_over_d_model(tmp_path):
    """Five ranks on (1, 5): reduced yi-6b widened to d_model 80, so
    "model" divides neither the padded vocab (512) nor the heads -- the
    embedding splits over d_model (each position on the first rank, its
    columns gathered) and the head not at all (its gradient shared out).
    The seq-mode forward within 1e-5 of max |logit| of the unsharded one,
    its gradients within 1e-4 of each leaf's max."""
    cfg = dataclasses.replace(_cfg(tbase, "yi_6b"), d_model=80)
    batch = make_batch(cfg, tbase.ShapeConfig("t", 40, 2, "train"), 0)
    res = ranks.spawn("lm_cp_odd", 5, tmp_path, dict(cfg=cfg, batch=batch))
    got = res[0]
    assert got["specs"] == {"embed": (None, "model"),
                            "lm_head": (None, None)}
    assert got["layout"] == "split" and got["cc"]["psum_scatter"] == 1
    model = TT.init_params(cfg, 0, device="cpu")
    with torch.inference_mode():
        want = TT.forward(model, cfg, batch)[0].numpy()
    assert _rel(got["logits"], want, cfg.vocab_size) <= LOGIT_REL
    grads = step_grads(model, cfg, batch, impl="flash")[0]
    for n, g in grads.items():
        g = g.numpy()
        err = float(np.abs(got["grads"][n] - g).max())
        assert err <= GRAD_REL * max(float(np.abs(g).max()), 1e-30), (n, err)


def test_grouped_moe_under_a_batch_split_matches_the_unsharded(tmp_path):
    """Six ranks on (2, 3): reduced granite-moe's 4 experts do not divide
    "model" = 3, so every MoE block takes the grouped dispatch (never the
    expert-parallel one) under the batch split, without seq mode.  Its aux
    takes the global batch's fractions: the forward's aux within 1e-5 of
    the unsharded forward's and its logits within 1e-5 of max |logit|;
    the gradients within 1e-4 of each leaf's max |g| of the unsharded
    step; a train step's loss and aux rtol 1e-5, grad norm rtol 1e-4."""
    arch, seq = "granite_moe_1b_a400m", 64
    cfg = _cfg(tbase, arch)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                   _cfg(jbase, arch)))
    batch = _batch(arch, seq)
    res = ranks.spawn("lm_moe_grouped", 6, tmp_path,
                      dict(arch=arch, tree=tree, batch=batch), timeout=360)
    got = res[0]
    assert got["taken"] == ["grouped"] and got["batch_sharded"]
    model = convert.params_from_reference(tree, cfg, device="cpu")
    with torch.inference_mode():
        logits, aux = TT.forward(model, cfg, batch, impl="xla")
    assert abs(got["aux"] - float(aux)) <= 1e-5
    assert _rel(got["logits"], logits.numpy(), cfg.vocab_size) <= LOGIT_REL
    want = step_grads(model, cfg, batch, impl="xla")[0]
    for n, g in want.items():
        g = g.numpy()
        err = float(np.abs(got["grads"][n] - g).max())
        assert err <= GRAD_REL * max(float(np.abs(g).max()), 1e-30), (n, err)
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    _, _, met = make_train_step(cfg, opt.AdamWConfig(
        lr=1e-3, warmup_steps=1), impl="xla")(
        model, opt.init_adamw(model), batch)
    m = got["metrics"]
    np.testing.assert_allclose(m["loss"], float(met["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], float(met["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(m["aux"], float(met["aux"]), rtol=1e-5,
                               atol=1e-7)
    for r in res[1:]:
        np.testing.assert_array_equal(r["logits"], got["logits"])
        assert r["metrics"] == m


@pytest.mark.parametrize("arch,seq", GRADS)
def test_seq_mode_gradients_match_the_unsharded_step(run, arch, seq):
    """``step_grads`` and ``make_train_step`` under seq mode on (2, 4)
    (flash; granite-moe's aux counted once across "model"; internvl's
    prefix) against the unsharded step: every leaf within 1e-4 of its max
    |g|, the loss (rtol 1e-5) and grad norm (rtol 1e-4)."""
    pl, res = run
    cfg = _cfg(tbase, arch)
    model = convert.params_from_reference(pl["trees"][arch], cfg,
                                          device="cpu")
    batch = pl["batches"][(arch, seq)]
    want, loss, aux = step_grads(model, cfg, batch, impl="flash")
    got = res[0]["grads"][arch]
    assert got["layout"] == "split"
    assert got["cc"]["psum_scatter"] > 0
    for n, g in want.items():
        g = g.numpy()
        err = float(np.abs(got["grads"][n] - g).max())
        assert err <= GRAD_REL * max(float(np.abs(g).max()), 1e-30), (n, err)
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    _, _, met = make_train_step(cfg, opt.AdamWConfig(
        lr=1e-3, warmup_steps=1), impl="flash")(
        model, opt.init_adamw(model), batch)
    m = got["metrics"]
    np.testing.assert_allclose(m["loss"], float(met["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], float(met["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(m["aux"], float(met["aux"]), rtol=1e-5,
                               atol=1e-7)
    for r in res:
        assert r["grads"][arch]["metrics"] == m


def test_decode_under_seq_mode_is_the_decode_without_it(run):
    """Decode steps (a 32-slot cache split by the rules, 6 tokens) inside
    ``activation_sharding(seq_mode=True)`` give bitwise the logits of the
    same steps without seq mode; the context's seq_mode is back after
    each step."""
    pl, res = run
    plain, mode_f, _ = res[0]["dec_False"]
    got, mode_t, layout = res[0]["dec_True"]
    assert not mode_f and mode_t and layout is None
    np.testing.assert_array_equal(got, plain)


# ------------------------------------------------------------ flash_at
_jxla = jax.jit(JL.xla_attention, static_argnames=("causal", "q_offset",
                                                   "kv_valid"))


@pytest.mark.parametrize("sq,skv,hq,hkv", [(9, 36, 4, 2), (37, 148, 4, 4),
                                           (64, 256, 8, 2)])
def test_flash_at_matches_the_reference_xla_attention(sq, skv, hq, hkv):
    """``flash_at`` (the plain version on CPU tensors) at offsets 0, mid
    and end (skv - sq), ragged lengths included, against the reference's
    ``xla_attention(q_offset=)``: the output and the gradients of a
    weighted sum of it with respect to q, k and v."""
    rng = np.random.default_rng(sq)
    q = rng.normal(size=(2, hq, sq, 16)).astype(np.float32)
    k = rng.normal(size=(2, hkv, skv, 16)).astype(np.float32)
    v = rng.normal(size=(2, hkv, skv, 16)).astype(np.float32)
    w = rng.normal(size=q.shape).astype(np.float32)
    for off in (0, (skv - sq) // 2, skv - sq):
        qkv = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        out = tfa.flash_at(*qkv, off)
        grads = torch.autograd.grad((out * torch.as_tensor(w)).sum(), qkv)
        want = _jxla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                     q_offset=off)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        jg = jax.grad(lambda a, b, c: jnp.sum(JL.xla_attention(
            a, b, c, True, q_offset=off) * w), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        for g, j in zip(grads, jg):
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4,
                                       atol=1e-5)


def test_flash_at_refuses_rows_outside_the_keys():
    """A shard whose rows would lie past the last key raises."""
    q = torch.zeros((1, 2, 8, 16))
    k = torch.zeros((1, 2, 32, 16))
    with pytest.raises(ValueError, match="outside"):
        tfa.flash_at(q, k, k, 25)
    with pytest.raises(ValueError, match="outside"):
        tfa.flash_at(q, k, k, -1)


def test_public_flash_keeps_its_padded_offset():
    """``flash_attention`` keeps the reference's padded-offset quirk: at
    (sq, skv) = (5, 37) its queries sit at padded skv - padded sq = 56,
    past every key, so each row attends to all 37 keys; ``flash_at`` at
    skv - sq = 32 places them at the end of the key timeline, as
    ``attention_ref`` does."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 2, s, 16)).astype(
        np.float32)) for s in (5, 37, 37))
    kp, _, kw = tfa.flash_args(q, k, v)
    assert kw["offset"] == kp.shape[2] - 8 == 56
    with pytest.raises(ValueError):
        tfa.flash_at(q, k, v, kw["offset"])
    np.testing.assert_allclose(
        tfa.flash_attention(q, k, v, True).numpy(),
        TL.xla_attention(q, k, v, causal=False).numpy(), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        tfa.flash_at(q, k, v, 32).numpy(),
        tfa.attention_ref(q, k, v, causal=True, scale=0.25)[0].numpy(),
        rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ dry run
@pytest.fixture
def fake24():
    """A fake group of 8 ranks and its (2, 4) mesh, destroyed after."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as C
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    dryrun.fake_group(8)
    yield make_debug_mesh(2, 4, device_type="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()
    C._GROUPS.clear()


def test_dryrun_traces_a_seq_mode_prefill(fake24):
    """Reduced yi-6b's prefill (4 x 256) traced as rank 0 of a fake (2, 4)
    group with and without seq mode, as the reference's
    ``test_seq_mode_lowers_and_has_collectives``: ``seq_mode`` recorded,
    the sequence split, the context-parallel collectives' bytes > 0 (the
    embedding's reduce-scatter among them), the same argument bytes; a
    train cell ignores seq mode, as the reference's ``lower_cell``."""
    from repro_torch.launch import dryrun
    cfg = tbase.get_reduced("yi_6b")
    shape = tbase.ShapeConfig("p", 256, 4, "prefill")
    tp = dryrun.trace_cell(cfg, shape, fake24)
    cp = dryrun.trace_cell(cfg, shape, fake24, seq_mode=True)
    assert not tp["seq_mode"] and tp["seq_layout"] is None
    assert cp["seq_mode"] and cp["seq_layout"] == "split"
    by = cp["collectives"]["bytes_by_kind"]
    assert cp["collectives"]["total_bytes_per_device"] > 0
    assert by["reduce-scatter"] > 0 and by["all-gather"] > 0
    assert tp["collectives"]["bytes_by_kind"]["reduce-scatter"] == 0
    assert cp["memory"]["argument_bytes"] == tp["memory"]["argument_bytes"]
    assert cp["ok"] and cp["raw_cost"]["flops"] > 0
