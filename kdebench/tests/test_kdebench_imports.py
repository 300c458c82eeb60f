"""Nothing the benchmark runs loads JAX or its package, the reference
loads nothing of the port, and nothing reads the JAX package's
benchmarks."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from kdebench_testing import BENCH, LRA, ROOT, SMALL, SPARSIFY

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
JAX_BENCH, JAX_RESULTS = "bench" + "marks/", "BENCH" + "_"  # the JAX
# package's benchmark folder and result files
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                 p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN
    text = path.read_text().replace("upstream " + JAX_BENCH, "")
    assert JAX_BENCH not in text and JAX_RESULTS not in text


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(_imports(path))
    assert not names & {"repro_torch", "kdebench", "chip_smoke", "tools"}


def test_a_run_loads_no_jax(tmp_path):
    """A whole small run in a fresh interpreter (with JAX installed, as
    here), the harness's own check included."""
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from kdebench import harness\n"
        f"small = json.loads({json.dumps(json.dumps(SMALL))})\n"
        f"for cell in ({SPARSIFY!r}, {LRA!r}):\n"
        "    r = harness.run_cell(cell, 3, 0.2, True, device='cpu',\n"
        "                         overrides=small[cell])\n"
        "    assert r['correct'], r\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_harness_refuses_a_run_that_loaded_jax(monkeypatch):
    from kdebench import harness
    monkeypatch.setitem(sys.modules, "repro", type(sys)("repro"))
    with pytest.raises(harness.BenchError, match="repro"):
        harness.run_cell(SPARSIFY, 3, 0.1, False, device="cpu",
                         overrides=SMALL[SPARSIFY])


def _run_py(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "kdebench/run.py", "--workload",
                           SPARSIFY, "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True,
                          timeout=300, cwd=cwd, env=env)


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this run would measure the cell")
    out = _run_py(ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_run_from_the_benchmark_files_alone_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "kdebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
