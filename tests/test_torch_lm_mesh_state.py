"""The LM's sharded state across meshes, on four spawned gloo ranks
(``torch_mesh_ranks.lm_state``, no JAX in the ranks): a checkpoint of a
sharded (model, AdamW) state written on a (2, 2) ("data", "model") mesh
and restored onto (4, 1) (the reference's elastic restore: the npz holds
whole arrays, each rank keeps its slice), and ``launch.train --data 2
--model 2`` resumed by ``--data 4 --model 1`` against the single-process
run.

Tolerances: the restored state bitwise the saved one; the mesh run's
logged losses and grad norms (4 decimals) within 2e-4 of the
single-process run's (one f32 step of the same batches, summed in other
orders).
"""
from __future__ import annotations

import dataclasses
import re

import jax
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro.configs import base as jbase
from repro.models import transformer as JT
from repro_torch.configs import base as tbase
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import train as ttrain

jax.config.update("jax_platforms", "cpu")

LOG = re.compile(r"\[train\] step=(\d+) loss=([\d.]+) gnorm=([\d.]+)")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_state")
    cfg = dataclasses.replace(jbase.get_reduced("yi_6b"), dtype="float32")
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    tc = dataclasses.replace(tbase.get_reduced("yi_6b"), dtype="float32")
    pl = dict(tree=tree, batch=make_batch(tc, tbase.ShapeConfig(
        "t", 16, 4, "train"), 0), dir=str(tmp / "elastic"),
        train_dir=str(tmp / "train"))
    return ranks.spawn("lm_state", 4, tmp, pl, timeout=300)


def test_elastic_restore_onto_another_mesh(run):
    """A state saved from a (2, 2) mesh restores onto (4, 1): every
    parameter and AdamW moment, gathered whole, bitwise the saved one; the
    optimizer's step count kept; each rank holds the (4, 1) slice (wq's
    rows over four "data" ranks, no "model" split)."""
    r = run[0]["restore"]
    assert r["same"] and r["step"] == 1 and r["opt_step"] == 1
    assert r["local"] == (16, 64)
    assert all(x["restore"]["same"] for x in run)


def test_launch_train_mesh_run_resumes_on_another_mesh(run, capsys):
    """``launch.train --data 2 --model 2`` (2 steps, a checkpoint a step)
    then ``--data 4 --model 1`` (resumed from step 2 on the other mesh, to
    step 4): rank 0 alone logs, and every step's loss and grad norm is the
    single-process run's."""
    log = run[0]["log"]
    assert "[train] resumed from step 2" in log
    assert all(x["log"] == "" for x in run[1:])
    got = {int(s): (float(l), float(g)) for s, l, g in LOG.findall(log)}
    assert ttrain.main(["--device", "cpu", "--arch", "yi_6b", "--reduced",
                        "--batch", "4", "--seq", "16", "--log-every", "1",
                        "--steps", "4"]) == 0
    want = {int(s): (float(l), float(g))
            for s, l, g in LOG.findall(capsys.readouterr().out)}
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for s in want:
        np.testing.assert_allclose(got[s], want[s], rtol=0, atol=2e-4)
