"""BENCHMARK.json and the files it names: the contract's shapes, names and
units, and every metric, cell and configuration tied to the others."""
from __future__ import annotations

import json
import re

import pytest

from kdebench_testing import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["kdebench"]
    assert SPEC["command"] == ["python3", "kdebench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(SPEC["workloads"])
    check_s = (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200
    assert check_s <= 43200 and cells <= 24


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key]), key
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")


def test_names_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_end_to_end_bounds_and_setup():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda e: e["name"])
def test_each_cell_reports_what_it_must(cell):
    from kdebench import harness
    e2e = harness.metrics_of(SPEC, cell["name"], False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per = harness.metrics_of(SPEC, cell["name"], True)
    assert per
    for m in per:
        assert m["moves"] in names       # each moves a metric it reports
    assert cell["chips"] in (1, 4)
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}


def test_per_layer_metrics_move_a_reported_metric_in_each_of_their_cells():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in moved or cell in moved["workloads"]
        layers.setdefault(m["layer"], []).append(m["name"])
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"
    assert set(layers) == {"samplers and estimators", "programs", "kernels",
                           "device"}


def test_every_configuration_has_a_cell_and_its_file():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("kdebench/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]
        assert (BENCH / "recipes" / f"{body['data']['recipe']}.py").exists()
        bw = body["kernel"]["bandwidth"]
        assert isinstance(bw, (int, float)) or (
            BENCH / "bandwidths" / f"{bw}.py").exists()
        assert body["kernel"]["ops_per_eval"] > 0
        assert c["file"] not in files
        files.add(c["file"])
    assert used <= {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda e: e["name"])
def test_cell_files_agree_with_the_spec(cell):
    body = json.loads((BENCH / "cells" / f"{cell['name']}.json").read_text())
    for key in ("config", "traffic", "chips", "why"):
        assert body[key] == cell[key]
    traffic = json.loads((BENCH / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    assert (BENCH / "pipelines" / f"{traffic['pipeline']}.py").exists()
    assert body["limits"] and body["trace_calls"] >= 1
    for lim in body["limits"].values():     # at most, or [lower, upper]
        assert isinstance(lim, (int, float)) or (
            len(lim) == 2 and lim[0] < lim[1])
    assert body["check"]["calls"] >= 1


@pytest.mark.parametrize("metric", METRICS, ids=lambda e: e["name"])
def test_every_metric_has_a_reader(metric):
    from kdebench import harness
    assert callable(harness.reader(metric["name"]).read)


def test_result_reader_values_never_zero_shares():
    """A share of a roofline reads None, not 0, where nothing was traced."""
    from kdebench import readers
    ctx = dict(trace=None, work={}, config={}, finished=0)
    assert readers.kde_roofline(ctx) is None
    assert readers.device_idle_pct(ctx) is None
    assert readers.launches_per_call(ctx) is None
