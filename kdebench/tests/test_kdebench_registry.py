"""A cell, a configuration, a point recipe and a metric are found by name:
adding one is adding files and BENCHMARK.json entries, with no file
edited."""
from __future__ import annotations

import json
import shutil

from kdebench_testing import BENCH, ROOT, SMALL, SPARSIFY, run_small

EXTRA_CELL = "sparsify.tiny.exact_b512"
EXTRA_METRIC = "edges_per_call"
EXTRA_RECIPE = "cube"


def _copy(tmp_path):
    """The benchmark's data files and modules found by name in a scratch
    folder, plus a new recipe, configuration, cell and per-layer metric as
    new files."""
    bench = tmp_path / "kdebench"
    for sub in ("configs", "cells", "traffic", "metrics", "pipelines",
                "recipes", "bandwidths"):
        shutil.copytree(BENCH / sub, bench / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "recipes" / f"{EXTRA_RECIPE}.py").write_text(
        "import torch\n\n\n"
        "def make(g, device, *, n, d, side):\n"
        "    return (torch.rand((n, d), generator=g, device=device)\n"
        "            - 0.5) * side\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((bench / "configs"
                       / "gauss262k_gaussian.json").read_text())
    conf.update(name="tiny_gaussian", reduced=["n"])
    conf["data"] = {"recipe": EXTRA_RECIPE, "n": 1024, "d": 8, "side": 1.2}
    (bench / "configs" / "tiny_gaussian.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic"
                          / "sparsify_exact.json").read_text())
    traffic["entry"]["batch"] = 512
    (bench / "traffic" / "sparsify_exact_b512.json").write_text(
        json.dumps(traffic))
    cell = json.loads((bench / "cells" / f"{SPARSIFY}.json").read_text())
    cell.update(config="tiny_gaussian", traffic="sparsify_exact_b512",
                why="a test cell")
    (bench / "cells" / f"{EXTRA_CELL}.json").write_text(json.dumps(cell))
    (bench / "metrics" / f"{EXTRA_METRIC}.py").write_text(
        "def read(ctx):\n"
        "    return ctx['work']['edges'] / ctx['finished']\n")
    spec["configs"].append(dict(name="tiny_gaussian", source="a test",
                                file="kdebench/configs/tiny_gaussian.json",
                                reduced=["n"], why="a test"))
    spec["workloads"].append(dict(name=EXTRA_CELL, config="tiny_gaussian",
                                  traffic="sparsify_exact_b512", chips=1,
                                  why="a test cell"))
    spec["per_layer"].append(dict(
        name=EXTRA_METRIC, unit="edges", better="higher",
        source="program_counter", layer="samplers and estimators",
        moves="edges_per_s", workloads=[EXTRA_CELL]))
    return bench, spec


def test_a_new_cell_and_metric_run_from_new_files_only(tmp_path):
    bench, spec = _copy(tmp_path)
    before = {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    res = run_small(EXTRA_CELL, seed=5, trace=True, seconds=0.5,
                    overrides={}, spec=spec, bench=bench)
    assert res["correct"], res["checks"]
    assert res["metrics"][EXTRA_METRIC]["value"] == 16 * 1024
    assert "kernel_evals_per_edge" not in res["metrics"]  # not its cell
    after = {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert before == after


def test_cells_of_the_spec_load_by_name():
    from kdebench import harness
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        entry, cell, config, traffic = harness.load_cell(spec, w["name"])
        assert entry is not None and config["name"] == cell["config"]
        assert harness.pipeline(traffic["pipeline"]).call
    assert SMALL.keys() == {w["name"] for w in spec["workloads"]}
