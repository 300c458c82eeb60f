"""The comparison that decides ``correct``, shown to fail: a whole small
run on the CPU (the card's look skipped) with each fault planted under the
timed path comes out not correct, the unbroken run correct, and the
control (the reference with TF32 products in the program's place) fails
the committed limits at a size a test run holds."""
from __future__ import annotations

import json

import pytest

from kdebench_testing import BENCH, LRA, PEAKED, SMALL, SPARSIFY, run_calls

PIPE = {SPARSIFY: "sparsify", LRA: "lra"}
# the law faults move a law only where blocks differ: the peaked cloud
LAW = {"uniform_block", "uniform_neighbor"}
CASES = [(cell, fault) for cell in (SPARSIFY, LRA)
         for fault in ("state_unchanged", "half_batch", "answer_altered",
                       "uniform_block", "uniform_neighbor")
         if PIPE[cell] == "sparsify" or fault not in LAW]


@pytest.mark.parametrize("cell,over", [(SPARSIFY, None), (LRA, None),
                                       (SPARSIFY, PEAKED)],
                         ids=["sparsify", "lra", "sparsify-peaked"])
def test_the_unbroken_run_is_correct(cell, over):
    res = run_calls(cell, seed=2 ** 31 + 99, overrides=over)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", CASES)
def test_each_fault_makes_the_run_not_correct(cell, fault):
    from kdebench import faults
    with faults.planted(PIPE[cell], fault):
        res = run_calls(cell, seed=21,
                        overrides=PEAKED if fault in LAW else None)
    assert not res["correct"], res["checks"]
    assert res["failed"] == 0      # the comparison saw it, not a crash


def test_the_law_faults_leave_every_weight_exact():
    """``uniform_neighbor`` keeps each weight k / (t q_e) and moves only
    the neighbor law: ``wgt_rel`` holds, ``nbr_z`` fails."""
    from kdebench import faults
    with faults.planted("sparsify", "uniform_neighbor"):
        res = run_calls(SPARSIFY, seed=23, overrides=PEAKED)
    c = res["checks"]
    assert c["wgt_rel"]["value"] <= c["wgt_rel"]["limit"]
    assert c["nbr_z"]["value"] > c["nbr_z"]["limit"]


@pytest.mark.parametrize("cell", [SPARSIFY, LRA])
def test_the_control_fails_the_limits(cell):
    from kdebench import data, harness
    spec = harness.benchmark_spec()
    _, body, config, traffic = harness.load_cell(spec, cell, SMALL[cell])
    pipe = harness.pipeline(traffic["pipeline"])
    limits = json.loads((BENCH / "cells" / f"{cell}.json").read_text())[
        "limits"]
    for seed in (1, 2, 3):
        x = data.make_points(config, seed, "cpu")
        bw = data.bandwidth(config, x, seed)
        inputs = pipe.release(pipe.setup(config, traffic, x, bw, "cpu"))
        got = pipe.control(inputs, seed, body["check"])
        assert not all(harness.within(got[k], lim)
                       for k, lim in limits.items()), got
