"""Each ``examples/torch_*.py`` runs as a script to exit 0 on the CPU
(``--device cpu``; the training example with small arguments) and prints
its result lines.  The scripts run in this process (``runpy`` as
``__main__``, their exit status caught), so they share its imports."""
from __future__ import annotations

import runpy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

EXAMPLES = {
    "torch_quickstart": ([], ["clustering accuracy", "top eigenvalue"]),
    "torch_serve_decode": ([], ["first-step logits correlation"]),
    "torch_kernel_graph_analytics": (
        [], ["final loss", "total triangle weight"]),
    "torch_train_lm": (["--steps", "3", "--batch", "2", "--seq", "32"],
                       ["done in"]),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs(name, tmp_path, monkeypatch, capsys):
    args, lines = EXAMPLES[name]
    if name == "torch_train_lm":
        args = args + ["--ckpt-dir", str(tmp_path / "ck")]
    path = ROOT / "examples" / f"{name}.py"
    monkeypatch.setattr(sys, "argv", [str(path), "--device", "cpu", *args])
    try:
        runpy.run_path(str(path), run_name="__main__")
        code = 0
    except SystemExit as exit_:
        code = exit_.code or 0
    out = capsys.readouterr().out
    assert code == 0, out
    for ln in lines:
        assert ln in out, out
