"""Everything of a cell is found by name: ``<folder>/<name>.py`` under the
benchmark's folder (``pipelines``, ``recipes``, ``bandwidths``,
``metrics``), loaded from its file, so that a later PR adds one by adding
a file and edits none."""
from __future__ import annotations

import importlib.util
from pathlib import Path

BENCH = Path(__file__).resolve().parent
_LOADED: dict = {}


def load(folder: str, name: str, bench: Path = BENCH):
    """The module ``<bench>/<folder>/<name>.py``, loaded once a path."""
    path = Path(bench) / folder / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            raise KeyError(f"no {folder[:-1]} {name!r} ({path})")
        tag = "".join(c if c.isalnum() else "_" for c in name)
        spec = importlib.util.spec_from_file_location(
            f"kdebench.{folder}._{tag}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
