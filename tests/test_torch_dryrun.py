"""The port's dry run (``launch.dryrun``): a cell's step traced as rank 0
of a ``"fake"`` process group under ``FakeTensorMode`` -- nothing spawned,
nothing moved, nothing compiled -- the counterpart of the reference's
``test_small_mesh_dryrun_train_and_decode`` (a reduced config on a (2, 2,
2) ("pod", "data", "model") mesh) and of its production cells.

The record's argument bytes must equal the rules' arithmetic, computed
here from the reference's own cast parameter tree (``cast_params``:
bf16 leaves of two or more dims) and ``param_spec``: each parameter's
slice, AdamW's two f32 moments of it for a train cell, the rank's batch
rows, or the rank's cache slice for a decode cell.  The fake group is made
for this module and destroyed after it.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun
from repro_torch.roofline import report

jax.config.update("jax_platforms", "cpu")

SMALL = tbase.ShapeConfig("t", 64, 8, "train")
KEYS = {"arch", "shape", "mesh", "chips", "kde_decode", "memory", "raw_cost",
        "collectives", "roofline", "ok"}


@pytest.fixture(scope="module")
def fake8():
    """A fake group of 8 ranks and its (2, 2, 2) mesh; destroyed after the
    module (the production cells remake it at 256)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    dryrun.fake_group(8)
    yield make_debug_mesh(2, 2, 2, device_type="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()
    C._GROUPS.clear()


def _param_bytes(cfg, mesh, adamw: bool) -> int:
    """The rank's parameter (+ AdamW moment) bytes by the rules."""
    tree = jax.eval_shape(lambda: JT.cast_params(
        JT.init_params(jax.random.PRNGKey(0), cfg), jnp.bfloat16))
    leaves = {tuple(getattr(k, "key", None) for k in p): leaf
              for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    total = 0
    for tmpl, path, count in convert._tree_paths(_port_cfg(cfg)):
        leaf = leaves[path]
        shape = leaf.shape[1:] if count else leaf.shape
        for i in range(count or 1):
            spec = SH.param_spec(tmpl.format(i=i), shape, mesh)
            n = int(np.prod(SH.local_shape(shape, spec, mesh)))
            total += n * np.dtype(leaf.dtype).itemsize
            if adamw:
                total += 2 * n * 4
    return total


def _port_cfg(cfg):
    """The port's ``ArchConfig`` of the reference's ``cfg``."""
    return tbase.ArchConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(tbase.ArchConfig)})


def _batch_bytes(cfg, shape, mesh) -> int:
    total = 0
    for v in jpipe.input_specs(cfg, shape).values():
        spec = SH.batch_spec(SH.mesh_shape(mesh), v.ndim, v.shape[0])
        total += int(np.prod(SH.local_shape(v.shape, spec, mesh))) \
            * np.dtype(v.dtype).itemsize
    return total


def _cache_bytes(cfg, shape, mesh) -> int:
    split = jpipe.token_split(cfg, shape)
    enc = split["frontend"] if (cfg.is_encdec or cfg.frontend != "none") \
        else 0
    cache = jax.eval_shape(lambda: JT.init_cache(
        cfg, shape.global_batch, shape.seq_len, jnp.bfloat16,
        enc_len=max(enc, 1)))
    total = 0
    for k, leaf in cache.items():
        spec = SH.cache_spec(cfg, shape, SH.mesh_shape(mesh), k, leaf)
        total += int(np.prod(SH.local_shape(leaf.shape, spec, mesh))) \
            * np.dtype(leaf.dtype).itemsize
    tokens = SH.batch_spec(SH.mesh_shape(mesh), 2, shape.global_batch)
    b = SH.local_shape((shape.global_batch, 1), tokens, mesh)
    lead = SH.cache_spec(cfg, shape, SH.mesh_shape(mesh),
                         "k" if "k" in cache else "ssm",
                         cache["k" if "k" in cache else "ssm"])
    rows = b[0] if lead[1] else shape.global_batch
    return total + rows * 4


@pytest.mark.parametrize("arch", ["yi_6b", "rwkv6_3b",
                                  "granite_moe_1b_a400m"])
def test_small_mesh_dryrun_train_and_decode(arch, fake8):
    """A reduced config's train step (remat, 4 microbatches), prefill and
    decode step traced on the fake (2, 2, 2) group: the reference's record
    keys, argument bytes equal to the rules' arithmetic, a nonzero FLOP
    count and collective schedule (the train step's gathers and
    reduce-scatters, counted by the wrapper)."""
    cfg = jbase.get_reduced(arch)
    tcfg = tbase.get_reduced(arch)
    rec = dryrun.trace_cell(tcfg, SMALL, fake8)
    assert KEYS <= set(rec) and rec["ok"] and rec["chips"] == 8
    assert rec["mesh"] == "2x2x2" and rec["arch"] == arch
    want = _param_bytes(cfg, fake8, True) + _batch_bytes(cfg, SMALL, fake8)
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["temp_bytes"] is None
    assert rec["raw_cost"]["flops"] > 0
    cc = rec["collectives"]["count_by_kind"]
    assert cc["all-gather"] > 0 and cc["reduce-scatter"] > 0 \
        and cc["all-reduce"] > 0
    assert rec["collectives"]["total_bytes_per_device"] > 0
    assert rec["collectives"]["unresolved_trips"] == 0
    dec = jbase.ShapeConfig("d", 64, 8, "decode")
    rec = dryrun.trace_cell(tcfg, tbase.ShapeConfig("d", 64, 8, "decode"),
                            fake8)
    assert rec["memory"]["argument_bytes"] == \
        _param_bytes(cfg, fake8, False) + _cache_bytes(cfg, dec, fake8)
    rec = dryrun.trace_cell(tcfg, tbase.ShapeConfig("p", 64, 8, "prefill"),
                            fake8)
    assert rec["memory"]["argument_bytes"] == \
        _param_bytes(cfg, fake8, False) + _batch_bytes(
            cfg, jbase.ShapeConfig("p", 64, 8, "prefill"), fake8)


def test_dryrun_refuses_context_parallel_prefill(fake8, tmp_path, capsys,
                                                monkeypatch):
    """``--seq-mode-prefill`` (context-parallel prefill, queue 1 item 14)
    is ported and no longer refuses: through ``main`` a prefill cell of
    granite-moe-1b-a400m (256 tokens, batch 32, on the 16 x 16 fake group)
    runs with the sequence split over "model" and records ``seq_mode``;
    ``lower_cell`` applies seq mode to prefill shapes only, as the
    reference's does (a decode cell records False)."""
    monkeypatch.setitem(dryrun.SHAPES, "p256",
                        tbase.ShapeConfig("p256", 256, 32, "prefill"))
    out = tmp_path / "dryrun.json"
    dryrun.main(["--arch", "granite_moe_1b_a400m", "--shape", "p256",
                 "--seq-mode-prefill", "--out", str(out)])
    assert "1/1 cells ok" in capsys.readouterr().out
    rec = json.loads(out.read_text())[0]
    assert rec["ok"] and rec["seq_mode"] and rec["seq_layout"] == "split"
    by = rec["collectives"]["bytes_by_kind"]
    assert by["reduce-scatter"] > 0 and by["all-gather"] > 0
    rec = dryrun.lower_cell("granite_moe_1b_a400m", "decode_32k", False,
                            seq_mode_prefill=True)
    assert rec["ok"] and not rec["seq_mode"] and rec["seq_layout"] is None


def test_production_decode_cell_and_report(fake8, tmp_path, capsys):
    """A production cell (granite-moe-1b-a400m decode_32k on the 16 x 16
    fake group of 256 ranks) through the CLI: the rank's argument bytes by
    the rules, the KDE flag off, the roofline against the H100; then
    ``roofline.report`` refreshes the JSON and renders its row."""
    out = tmp_path / "dryrun.json"
    dryrun.main(["--arch", "granite_moe_1b_a400m", "--shape", "decode_32k",
                 "--out", str(out)])
    assert "1/1 cells ok" in capsys.readouterr().out
    rec = json.loads(out.read_text())[0]
    cfg = jbase.get_config("granite_moe_1b_a400m")
    shape = jbase.SHAPES["decode_32k"]
    mesh = {"data": 16, "model": 16}
    assert rec["ok"] and rec["chips"] == 256 and not rec["kde_decode"]
    assert rec["memory"]["argument_bytes"] == \
        _param_bytes(cfg, mesh, False) + _cache_bytes(cfg, shape, mesh)
    assert rec["roofline"]["chips"] == 256
    recs = report.refresh(str(out))
    assert recs[0]["roofline"] == rec["roofline"]
    table = report.render_markdown(recs)
    assert "| granite_moe_1b_a400m | decode_32k |" in table
