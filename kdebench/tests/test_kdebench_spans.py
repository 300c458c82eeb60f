"""The program's spans and sync counter as the benchmark reads them: a
traced small run of each cell on the CPU reports the cell's stage seconds
and host syncs, each stage inside the traced window, and a run reads only
its own calls where one process makes several."""
from __future__ import annotations

import pytest

from kdebench_testing import LRA, SMALL, SPARSIFY, run_small

STAGES = {SPARSIFY: ["degrees_s.sparsify", "edge_scan_s.sparsify",
                     "edge_copy_s.sparsify"],
          LRA: ["row_norms_s.lra", "sketch_rows_s.lra"]}
SYNCS = {SPARSIFY: "host_syncs_per_call.sparsify",
         LRA: "host_syncs_per_call.lra"}


def _syncs(cell: str, n: int) -> int:
    """The host syncs of one call: a read of each 1024-row batch of the
    degree or row-norm sweep (the sparsifier's with its counter word's
    copy and read), then the sparsifier's two degree exports, its edge
    word's copy and read and five edge arrays, or the sketch's index,
    scale and word copies, the word's read, ``eigh`` and the factor's
    read."""
    batches = -(-n // 1024)
    return 3 * batches + 9 if cell == SPARSIFY else batches + 6


def _sized(cell: str, n: int, entry=None, **data) -> dict:
    """The cell's small overrides at ``n`` points (and any other ``data``
    sizes or ``entry`` keywords), one call compared."""
    over = {k: dict(v) for k, v in SMALL[cell].items()}
    over["config"] = {"data": dict(over["config"]["data"], n=n, **data)}
    over["traffic"] = {"entry": dict(over["traffic"]["entry"],
                                     **(entry or {}))}
    over["cell"] = dict(over["cell"], check={"calls": 1})
    return over


# a sparsifier of 4 batches a call; the LRA on 32-wide points
SIZES = {SPARSIFY: dict(n=1024, entry={"edges_per_point": 4}),
         LRA: dict(n=600, d=32)}
N = {cell: sizes["n"] for cell, sizes in SIZES.items()}


@pytest.fixture(scope="module")
def traced():
    """One traced small run of each cell, made once for the module."""
    return {cell: run_small(cell, seed=11, trace=True,
                            overrides=_sized(cell, **SIZES[cell]))
            for cell in (SPARSIFY, LRA)}


@pytest.mark.parametrize("cell", [SPARSIFY, LRA])
def test_a_traced_run_reports_its_stages_inside_the_window(traced, cell):
    res = traced[cell]
    assert res["failed"] == 0
    got = {k: v["value"] for k, v in res["metrics"].items()}
    per_call = res["device"]["window_s"] / res["attempted"]
    for name in STAGES[cell]:
        assert 0.0 <= got[name] <= per_call, name
    assert sum(got[name] for name in STAGES[cell]) <= per_call
    assert got[SYNCS[cell]] == _syncs(cell, N[cell])


def test_the_sync_count_is_the_same_for_two_seeds(traced):
    res = run_small(LRA, seed=12, trace=True,
                    overrides=_sized(LRA, **SIZES[LRA]))
    assert res["metrics"][SYNCS[LRA]]["value"] == \
        traced[LRA]["metrics"][SYNCS[LRA]]["value"]


def test_two_traced_runs_in_one_process_read_their_own_calls(traced):
    """A second traced run at another size reads its own sync count,
    while the first run's spans are still in the ring."""
    from kdebench import spans
    res = run_small(LRA, seed=13, trace=True,
                    overrides=_sized(LRA, 1100, d=32))
    assert res["metrics"][SYNCS[LRA]]["value"] == _syncs(LRA, 1100)
    assert _syncs(LRA, 1100) != _syncs(LRA, N[LRA])
    calls = res["attempted"]
    both = spans.calls({"trace": {"calls": calls + 1}}, "lowrank")
    assert len(both) == calls + 1        # a root of an earlier run too
    for tree in spans.calls({"trace": {"calls": calls}}, "lowrank"):
        assert sorted(r["name"] for r in tree) == [
            "lowrank", "lowrank.eigh", "row_draws", "row_norms",
            "sketch_rows"]


@pytest.mark.parametrize("cell", [SPARSIFY, LRA])
def test_readers_return_none_without_spans(cell, monkeypatch):
    """Untraced, or on a port that records no spans (an older one),
    every reader gives None and raises nothing."""
    from kdebench import harness
    from repro_torch.obs import metrics
    names = STAGES[cell] + [SYNCS[cell]]
    for name in names:
        assert harness.reader(name).read({"trace": None}) is None
    monkeypatch.delattr(metrics, "span_records")
    for name in names:
        assert harness.reader(name).read({"trace": {"calls": 2}}) is None
