"""The port's sharding rules, input specs and roofline arithmetic against
the reference, with no ranks: ``distributed.sharding.param_spec`` /
``cache_spec`` / ``batch_spec`` on every leaf of all ten configs at full
size, on (2, 4), (16, 16) and (2, 16, 16) meshes (the reference's
``AbstractMesh``: no devices), ``data.pipeline.input_specs`` and
``roofline.flops.cell_cost`` / ``roofline.analysis.roofline_terms`` for
every (arch x shape) cell, and the H100 chip spec.

Specs compare after normalising entries (an axis name or a one-name tuple
alike, no trailing replicated dims); a port layer parameter's spec is the
reference's stacked leaf's minus its leading L dim.  Numbers compare
exactly (the same float formulas in the same order).
"""
from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.distributed import sharding as jshard
from repro.models import transformer as JT
from repro.roofline import analysis as janalysis
from repro.roofline import flops as jflops
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import sharding as tshard
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import flops as tflops

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _norm(spec):
    out = []
    for e in spec:
        if e is None or e == ():
            out.append(None)
        elif isinstance(e, str):
            out.append((e,))
        else:
            out.append(tuple(e))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _stacked(name, spec):
    """A port spec as the reference's of the stacked leaf: a layer
    parameter's gets its leading (never sharded) L dim back."""
    return ((None,) + tuple(spec)) if name.startswith(
        ("layers.", "encoder.layers.")) else tuple(spec)


def _abstract(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def _port_mesh(name):
    shape, axes = MESHES[name]
    return dict(zip(axes, shape))


def _ref_tree(arch):
    cfg = jbase.get_config(arch)
    return cfg, jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                      cfg))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_param_spec_equals_the_reference_on_every_leaf(arch, mesh):
    """Every parameter of the full-size config: the port's spec of the
    unstacked parameter, given its leading L dim back, is the
    reference's spec of the stacked leaf, and every dim a spec splits
    divides."""
    cfg, tree = _ref_tree(arch)
    tcfg = tbase.get_config(arch)
    am, pm = _abstract(mesh), _port_mesh(mesh)
    leaves = {tuple(getattr(k, "key", None) for k in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    by_path = {tuple(getattr(k, "key", None) for k in p): p for p, _ in paths}
    seen = 0
    for tmpl, path, count in convert._tree_paths(tcfg):
        leaf = leaves[path]
        want = _norm(jshard.param_spec(by_path[path], leaf, am))
        for i in range(count or 1):
            name = tmpl.format(i=i)
            shape = leaf.shape[1:] if count else leaf.shape
            got = tshard.param_spec(name, shape, pm)
            assert _norm(_stacked(name, got)) == want, \
                (name, got, want)
            for d, e in enumerate(got):
                assert e is None or shape[d] % pm[e] == 0
            seen += 1
    assert seen >= len(leaves)


def _cache_shapes(cfg, shape):
    split = jpipe.token_split(cfg, shape)
    enc = split["frontend"] if (cfg.is_encdec or cfg.frontend != "none") \
        else 0
    return jax.eval_shape(lambda: JT.init_cache(
        cfg, shape.global_batch, shape.seq_len, jnp.bfloat16,
        enc_len=max(enc, 1)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_cache_and_batch_specs_equal_the_reference(arch, mesh):
    """``cache_spec`` of every cache leaf of both decode shapes, and
    ``batch_spec`` of every input of every cell, as the reference's."""
    cfg = jbase.get_config(arch)
    tcfg = tbase.get_config(arch)
    am, pm = _abstract(mesh), _port_mesh(mesh)
    assert tshard.batch_axes(pm) == jshard.batch_axes(am)
    for sname, shape in jbase.SHAPES.items():
        tshape = tbase.SHAPES[sname]
        for k, v in jpipe.input_specs(cfg, shape).items():
            got = tshard.batch_spec(pm, v.ndim, v.shape[0])
            assert _norm(got) == _norm(jshard.batch_spec(am, v.ndim,
                                                         v.shape[0])), k
            assert _norm(tshard.batch_spec(pm, v.ndim)) == _norm(
                jshard.batch_spec(am, v.ndim))
        if shape.kind != "decode":
            continue
        for leaf_name, leaf in _cache_shapes(cfg, shape).items():
            want = jshard.cache_spec(cfg, shape, am, leaf_name, leaf)
            got = tshard.cache_spec(tcfg, tshape, pm, leaf_name, leaf)
            assert _norm(got) == _norm(want), (sname, leaf_name, got, want)


@pytest.mark.parametrize("sname", list(jbase.SHAPES))
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_input_specs_cell_cost_and_roofline_equal_the_reference(arch, sname):
    """``input_specs`` (shape and dtype of every input), ``cell_cost`` (each
    field, for exact and KDE decode) and ``roofline_terms`` at the
    reference's spec: equal to the reference's."""
    cfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    shape, tshape = jbase.SHAPES[sname], tbase.SHAPES[sname]
    want = jpipe.input_specs(cfg, shape)
    got = tpipe.input_specs(tcfg, tshape)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert str(got[k].dtype).removeprefix("torch.") \
            == np.dtype(want[k].dtype).name
        assert got[k].device.type == "meta"
    f32 = tpipe.input_specs(tcfg, tshape, torch.float32)
    assert all(v.dtype in (torch.int32, torch.float32) for v in f32.values())
    spec = tanalysis.ChipSpec(**dataclasses.asdict(janalysis.TPU_V5E))
    for kde in (False, True):
        jc = jflops.cell_cost(cfg, shape, kde_decode=kde)
        tc = tflops.cell_cost(tcfg, tshape, kde_decode=kde)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        for coll in (0.0, 3.5e9):
            want_rl = janalysis.roofline_terms(
                jc.flops, jc.model_flops, jc.hbm_bytes, coll, 256,
                {"flops": 1.0, "bytes accessed": 2.0})
            got_rl = tanalysis.roofline_terms(
                tc.flops, tc.model_flops, tc.hbm_bytes, coll, 256,
                {"flops": 1.0, "bytes accessed": 2.0}, spec=spec)
            assert got_rl.as_dict() == want_rl.as_dict()


def test_chip_spec_is_the_h100_data_sheet():
    """The port's device spec: the H100's data sheet (bf16 dense 989
    TFLOP/s, HBM 3.35 TB/s, NVLink 450 GB/s a direction) under the card's
    nvidia-smi name and power limit; "cpu" the reference's host spec; no
    TPU spec in the port."""
    h = tanalysis.chip_spec_for_backend("cuda")
    assert h is tanalysis.H100
    assert (h.peak_flops, h.hbm_bw, h.link_bw) == (989e12, 3.35e12, 450e9)
    assert h.name == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert tanalysis.chip_spec_for_backend("cpu").as_dict() == \
        janalysis.HOST_CPU.as_dict()
    assert not hasattr(tanalysis, "TPU_V5E")
    rl = tanalysis.roofline_terms(989e12, 1.0, 3.35e12, 450e9, 1)
    assert (rl.compute_s, rl.memory_s, rl.collective_s) == (1.0, 1.0, 1.0)
    m = tanalysis.measured_roofline(2.0, 989e12, 0.0, spec=h)
    assert m.achieved_fraction == 0.5 and m.dominant == "compute"
    for name in ("f32", "bf16", "bfloat16", "int8", "float32"):
        assert tanalysis.dtype_bytes(name) == janalysis.dtype_bytes(name)
    assert tanalysis.dtype_bytes(torch.bfloat16) == 2
    for ts in ("f32[8,16]", "(bf16[4], s32[2,2])", "pred[]"):
        assert tanalysis.shape_bytes(ts) == janalysis.shape_bytes(ts)


def test_collective_bytes_reads_the_wrapper_by_kind():
    """The wrapper's kinds map onto the reference's HLO kinds; every call
    is realized, so no trip count is left unresolved."""
    counts = {"psum": 3, "pmax": 1, "all_gather": 2, "psum_scatter": 4,
              "ppermute": 5}
    nbytes = {"psum": 30, "pmax": 4, "all_gather": 200, "psum_scatter": 64,
              "ppermute": 10}
    cs = tanalysis.collective_bytes(counts, nbytes)
    assert cs.count_by_kind == {"all-gather": 2, "all-reduce": 4,
                                "reduce-scatter": 4, "all-to-all": 0,
                                "collective-permute": 5}
    assert cs.bytes_by_kind["all-reduce"] == 34.0
    assert cs.total_bytes == 308.0 and cs.unresolved_trips == 0


def test_spec_helpers():
    """``local_shape``, ``replication`` and ``placements`` of a spec."""
    pm = {"pod": 2, "data": 4, "model": 8}
    spec = tshard.param_spec("layers.0.attn.wq", (64, 128), pm)
    assert spec == ("data", "model")
    assert tshard.local_shape((64, 128), spec, pm) == (16, 16)
    assert tshard.replication(spec, pm) == 2
    assert tshard.replication((None, None), pm) == 64
    assert tshard.param_spec("final_norm", (64,), pm) == (None,)
    assert tshard.param_spec("layers.0.mlp.w1", (8, 64, 32), pm) == \
        ("model", "data", None)
    # the embed's fallback: a vocab "model" does not divide shards d_model
    assert tshard.param_spec("embed", (49155, 64), pm) == (None, "model")
    names = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert [str(p) for p in tshard.placements(spec, names)] == \
        ["R", "S(0)", "S(1)"]
    assert tshard.data_shardings(None, None, pm, {
        "tokens": torch.empty((8, 4))})["tokens"].spec == \
        (("pod", "data"), None)
    cache = {"k": torch.empty((2, 8, 8, 16, 4), device="meta")}
    assert tshard.cache_shardings(None, None, pm, cache)["k"].spec == \
        (None, ("pod", "data"), "model", None, None)
