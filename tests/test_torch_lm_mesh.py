"""The LM's sharded programs on spawned gloo ranks against the reference's
own sharded programs.

Eight ranks (``torch_mesh_ranks.lm_mesh``, no JAX in the ranks) run the
port on "cpu" meshes: one sharded train step of reduced ``yi_6b``,
``rwkv6_3b`` and ``granite_moe_1b_a400m`` on a (2, 2, 2) ("pod", "data",
"model") mesh, the shard_map MoE and KDE decode on (2, 4), the model's
decode over a sequence-split cache (xla, and kde at batch 1), and
``compressed_psum`` over "pod".  Both packages start from the reference's
``init_params`` trees (``convert.params_from_reference``).  The
reference's sharded train step runs meanwhile in a JAX subprocess with 8
host devices on ``jax.sharding.Mesh(...)`` (Auto axes: ``jax.make_mesh``
builds Explicit ones on this tree's JAX, which the reference's step does
not take).

Tolerances: the train step's loss rtol 1e-5, grad norm rtol 1e-4, every
parameter after one step within 2 lr (AdamW moves an entry by about lr,
so a sign flip of a gradient near zero moves it 2 lr); the MoE output atol
1e-4, aux 1e-4, gradients atol 2e-3 and the KDE decode atol 1e-5 (the
reference's own, ``tests/test_perf_features.py``); the decode logits
within 1e-5 of the largest; ``compressed_psum`` codes and residuals
exactly.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro.configs import base as jbase
from repro.kernels.kde_attention.ref import kde_attention_ref
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data.pipeline import make_batch

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["yi_6b", "rwkv6_3b", "granite_moe_1b_a400m"]
SHAPE = tbase.ShapeConfig("t", 32, 8, "train")
LR = 1e-3
KDE_CFG = {"top_p": 2, "bk": 16, "stride": 4}
DEC_LEN = 256

REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import dataclasses, jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import get_reduced, ShapeConfig
from repro.data.pipeline import make_batch
from repro.distributed import sharding as shard
from repro.models import transformer as T
from repro.models.layers import activation_sharding
from repro.train import optimizer as opt
from repro.train.train_step import make_train_step
out = {}
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
for arch in sys.argv[2].split(","):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = T.init_params(jax.random.PRNGKey(0), cfg)
    ost = opt.init_adamw(params)
    batch = {k: jnp.asarray(v) for k, v in
             make_batch(cfg, ShapeConfig("t", 32, 8, "train"), 0).items()}
    p_sh = shard.param_shardings(params, mesh)
    o_sh = opt.AdamWState(step=NamedSharding(mesh, P()), m=p_sh, v=p_sh)
    b_sh = {k: NamedSharding(mesh, shard.batch_spec(mesh, v.ndim, v.shape[0]))
            for k, v in batch.items()}
    with activation_sharding(mesh, ("pod", "data")):
        step = jax.jit(make_train_step(cfg, opt.AdamWConfig(
            lr=float(sys.argv[3]), warmup_steps=1), donate=False),
            in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, None))
        new, _, met = step(params, ost, batch)
    for k, v in met.items():
        out[f"{arch}|metric|{k}"] = np.asarray(v)
    for path, leaf in jax.tree_util.tree_flatten_with_path(new)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[f"{arch}|param|{key}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
'''


def _f32(arch):
    return dataclasses.replace(jbase.get_reduced(arch), dtype="float32")


def _tree(arch, key=0):
    return jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(key),
                                                   _f32(arch)))


def _kde_inputs(hkv, s, seed=0):
    rng = np.random.default_rng(seed)
    b, hq, hd = 1, 8, 32
    return {"q": rng.normal(0, 1, (b, hq, 1, hd)).astype(np.float32),
            "k": rng.normal(0, 0.3, (b, hkv, s, hd)).astype(np.float32),
            "v": rng.normal(0, 1, (b, hkv, s, hd)).astype(np.float32)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results and the reference's sharded steps, run at
    once."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    rng = np.random.default_rng(0)
    moe = _f32("granite_moe_1b_a400m")
    pl = dict(
        lr=LR, trees={a: _tree(a) for a in ARCHS},
        batches={a: make_batch(dataclasses.replace(
            tbase.get_reduced(a), dtype="float32"), SHAPE, 0) for a in ARCHS},
        moe_tree=_tree("granite_moe_1b_a400m"),
        moe_x=rng.normal(0, 0.5, (4, 16, moe.d_model)).astype(np.float32),
        moe_x2=np.random.default_rng(1).normal(
            0, 0.5, (4, 8, moe.d_model)).astype(np.float32),
        kde2=_kde_inputs(2, 1024), kde4=_kde_inputs(4, 1024),
        kde_odd=_kde_inputs(2, 96), dec_tree=_tree("yi_6b", 3),
        dec_tok=rng.integers(0, 256, (2, 4)).astype(np.int64),
        dec_len=DEC_LEN, kde_cfg=KDE_CFG,
        cp_g={k: rng.normal(0, s, (8,) + shp).astype(np.float32)
              for k, s, shp in (("a", 1.0, (5, 7)), ("b", 1e-3, (11,)))},
        cp_r={k: rng.normal(0, s, (8,) + shp).astype(np.float32)
              for k, s, shp in (("a", 1e-2, (5, 7)), ("b", 1e-5, (11,)))})
    # the 8 ranks and the reference's subprocess share the host's cores
    # with the rest of the suite: a longer group timeout than the default
    wait = ranks.spawn_async("lm_mesh", 8, tmp, pl, timeout=360)
    out = tmp / "ref.npz"
    p = subprocess.run([sys.executable, "-c", REFERENCE, str(out),
                        ",".join(ARCHS), str(LR)], capture_output=True,
                       text=True, cwd=ROOT)
    res = wait()
    assert p.returncode == 0, p.stderr[-2000:]
    with np.load(out) as z:
        ref = {k: z[k] for k in z.files}
    return pl, res, ref


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_the_reference_sharded_step(arch, run):
    """One step of the port's sharded train step on (2, 2, 2) -- stored
    state sharded by the rules, TP attention / FFN, the MoE by expert
    parallelism, RWKV6 gathered to compute -- against the reference's
    GSPMD step: loss, grad norm, every updated parameter; the same
    metrics on every rank; each rank holds under half of the state
    (parameters and AdamW moments: the "pod" replicas hold the same shard,
    embed and lm_head are split over "model" only, norms replicated)."""
    pl, res, ref = run
    cfg = tbase.get_reduced(arch)
    got = res[0][arch]
    want = {k.split("|")[2]: float(v) for k, v in ref.items()
            if k.startswith(f"{arch}|metric|")}
    np.testing.assert_allclose(got["metrics"]["loss"], want["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["grad_norm"],
                               want["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(got["metrics"]["aux"], want["aux"],
                               rtol=1e-4, atol=1e-6)
    tree = convert.named_to_tree(got["params"], cfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        np.testing.assert_allclose(leaf, ref[f"{arch}|param|{key}"], rtol=0,
                                   atol=2 * LR, err_msg=key)
    for r in res:
        assert r[arch]["metrics"] == got["metrics"]
    whole = sum(a.size for a in got["params"].values()) * 4 * 3
    assert max(r[arch]["bytes"] for r in res) < 0.5 * whole
    assert got["cc"]["psum_scatter"] > 0 and got["cc"]["all_gather"] > 0


def test_shardmap_moe_forward_and_gradients(run):
    """The shard_map MoE on (2, 4) ("data", "model"), 4 experts over
    "model", against the reference's dense oracle (every expert on every
    token; capacity 8 drops nothing): the output (atol 1e-4), the aux loss
    (1e-4) and the gradients of sum(y^2) + 0.01 aux (atol 2e-3)."""
    pl, res, _ = run
    cfg = _f32("granite_moe_1b_a400m")
    lp = jax.tree.map(lambda a: jnp.asarray(a[0]), pl["moe_tree"]["layers"])
    y_ref, aux_ref = JL.moe_block_dense(lp["mlp"], cfg,
                                        jnp.asarray(pl["moe_x"]))
    np.testing.assert_allclose(res[0]["moe_y"], np.asarray(y_ref), atol=1e-4)
    assert abs(res[0]["moe_aux"] - float(aux_ref)) < 1e-4

    def loss(p, x):
        y, aux = JL.moe_block_dense(p, cfg, x)
        return jnp.sum(y ** 2) + 0.01 * aux
    g = jax.grad(loss)(lp["mlp"], jnp.asarray(pl["moe_x2"]))
    for k in ("w1", "w2", "w3", "router"):
        np.testing.assert_allclose(res[0]["moe_grads"][k], np.asarray(g[k]),
                                   atol=2e-3, err_msg=k)


@pytest.mark.parametrize("hkv", [2, 4])
def test_shardmap_kde_decode_matches_the_mirror(hkv, run):
    """The shard_map KDE decode on (2, 4): kv heads split over "model"
    (hkv 4) or the sequence over ("data", "model") (hkv 2), against the
    reference's jnp mirror at atol 1e-5; one lse all-gather, one max and
    three sum all-reduces."""
    pl, res, _ = run
    inp = pl[f"kde{hkv}"]
    want = kde_attention_ref(jnp.asarray(inp["q"][:, :, 0, :]),
                             jnp.asarray(inp["k"]), jnp.asarray(inp["v"]),
                             top_p=4, bk=64, stride=4, kv_valid=900)
    got, cc = res[0][f"kde{hkv}"]
    np.testing.assert_allclose(got[:, :, 0, :], np.asarray(want), atol=1e-5)
    assert (cc["all_gather"], cc["pmax"], cc["psum"]) == (1, 1, 3), cc


def test_shardmap_kde_decode_returns_none_on_indivisible(run):
    """A cache whose length does not split into whole blocks a shard (96
    keys over 8 shards at bk 64) returns None, as the reference's."""
    assert run[1][0]["kde_odd"] is None


def _ref_decode(pl, toks, impl, kw):
    cfg = _f32("yi_6b")
    params = jax.tree.map(jnp.asarray, pl["dec_tree"])
    cache = JT.init_cache(cfg, toks.shape[0], DEC_LEN, jnp.float32)
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(
        p, cfg, t, c, pos, impl=impl, kde_cfg=kw))
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        outs.append(np.asarray(logits))
    return np.stack(outs)


def test_sharded_xla_decode_over_a_sequence_split_cache(run):
    """The model's xla decode on (2, 4) at batch 2: the cache splits its
    batch over "data" and, its 2 kv heads not dividing "model", its
    sequence over "model"; each rank attends over its slice and the
    slices combine by the flash-decode logsumexp rule.  Four steps'
    logits against the reference's single-device decode."""
    pl, res, _ = run
    got, specs = res[0]["dec_xla"]
    assert specs["k"] == (None, ("data",), None, "model", None)
    want = _ref_decode(pl, pl["dec_tok"], "xla", None)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_sharded_kde_decode_through_the_model(run):
    """The model's KDE decode at batch 1 on (2, 4): the sequence over
    ("data", "model") (the long_500k layout), the shard_map program in
    every layer; four steps (the first ones over mostly empty blocks)
    against the reference's single-device decode."""
    pl, res, _ = run
    got, specs = res[0]["dec_kde"]
    assert specs["k"] == (None, None, None, ("data", "model"), None)
    want = _ref_decode(pl, pl["dec_tok"][:1], "kde", KDE_CFG)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_compressed_psum_codes_and_residuals_exact(run):
    """``compressed_psum`` over "pod" of the (2, 2, 2) mesh: each leaf's
    summed int8 codes times the larger scale (the reference's
    ``decompress(psum(q), pmax(scale))``) and each rank's error-feedback
    residual, exactly as the reference's ``compress`` gives them; one sum
    and one max all-reduce a leaf."""
    pl, res, _ = run
    for rank, r in enumerate(res):
        peer = rank ^ 4                      # the other pod, same (data, model)
        assert r["cp_cc"]["psum"] == 2 and r["cp_cc"]["pmax"] == 2
        for k, (summed, resid) in r["cp"].items():
            parts = [jopt.compress(jnp.asarray(pl["cp_g"][k][i]),
                                   jnp.asarray(pl["cp_r"][k][i]))
                     for i in (rank, peer)]
            codes = sum(np.asarray(q, np.int32) for q, _, _ in parts)
            scale = max(np.float32(s) for _, s, _ in parts)
            want = np.asarray(jopt.decompress(jnp.asarray(codes),
                                              jnp.float32(scale)))
            np.testing.assert_array_equal(summed, want)
            np.testing.assert_array_equal(resid, np.asarray(parts[0][2]))
