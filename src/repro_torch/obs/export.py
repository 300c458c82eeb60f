"""Versioned metric exporters (DESIGN.md §15.3).

Three consumers, one schema version (the reference's, so its
``tools/check_metrics_schema.py`` reads the port's lines):

* ``emit_jsonl`` -- the ``launch/serve.py`` metrics stream: one JSON
  object per line behind the stable ``[serve] metrics `` grep prefix,
  stamped with ``schema_version``.
* ``prometheus_text`` -- a Prometheus text-format dump of the live
  registry (``--metrics-format prometheus``).
* ``telemetry_block`` -- the shared schema block a benchmark artifact
  embeds under ``"telemetry"``: fenced wall time, realized device evals
  (from counter words), roofline fraction, backend (the torch device
  type, ``"cuda"`` or ``"cpu"``).

Bump ``SCHEMA_VERSION`` whenever a required key changes meaning; the
validator pins the current version exactly.
"""
from __future__ import annotations

import json
import sys
from typing import Optional

import torch

from repro_torch.obs import metrics as _m

SCHEMA_VERSION = 1
METRICS_PREFIX = "[serve] metrics "

# Every serve.py JSON-lines payload must carry these keys.
METRICS_REQUIRED = ("schema_version", "mode")
# Per-mode required keys (subset check; payloads may carry more).
METRICS_MODE_REQUIRED = {
    "multi-tenant": ("tenants", "ticks", "served", "failed", "p50_ms",
                     "p99_ms", "throughput_rps", "evictions", "stale",
                     "realized_evals", "per_tenant"),
    "graph-stream": ("n", "ticks", "epoch", "live", "flags"),
}
# Every benchmark telemetry block must carry these keys.
TELEMETRY_REQUIRED = ("schema_version", "backend", "fenced", "wall_us")


def emit_jsonl(payload: dict, stream=None, prefix: str = METRICS_PREFIX
               ) -> str:
    """Print one schema-stamped JSON-lines metrics record; returns the
    emitted line (minus prefix) for tests."""
    rec = dict(payload)
    rec.setdefault("schema_version", SCHEMA_VERSION)
    line = json.dumps(rec, sort_keys=True, default=float)
    print(prefix + line, file=stream or sys.stdout, flush=True)
    return line


def telemetry_block(wall_us: Optional[float] = None,
                    dispatch_us: Optional[float] = None,
                    realized_evals: Optional[int] = None,
                    roofline_fraction: Optional[float] = None,
                    device=None, **extra) -> dict:
    """The shared benchmark schema block (``"telemetry"`` key): timing is
    declared fenced because ``metrics.Timer`` fences by construction --
    hand-rolled timers must not use this constructor.  ``backend`` is the
    type of ``device`` (default: ``"cuda"`` when a card is present, else
    ``"cpu"``)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    blk = dict(schema_version=SCHEMA_VERSION,
               backend=torch.device(device).type, fenced=True)
    blk["wall_us"] = float(wall_us) if wall_us is not None else None
    if dispatch_us is not None:
        blk["dispatch_us"] = float(dispatch_us)
    if realized_evals is not None:
        blk["realized_evals"] = int(realized_evals)
    if roofline_fraction is not None:
        blk["roofline_fraction"] = float(roofline_fraction)
    blk.update(extra)
    return blk


def validate_metrics_line(obj: dict) -> None:
    """Raise ``ValueError`` when a serve.py JSON-lines record does not
    match the pinned schema version / required keys."""
    for k in METRICS_REQUIRED:
        if k not in obj:
            raise ValueError(f"metrics line missing required key {k!r}")
    if obj["schema_version"] != SCHEMA_VERSION:
        raise ValueError(
            f"metrics schema_version {obj['schema_version']!r} != pinned "
            f"{SCHEMA_VERSION}")
    need = METRICS_MODE_REQUIRED.get(obj["mode"], ())
    missing = [k for k in need if k not in obj]
    if missing:
        raise ValueError(
            f"metrics line (mode={obj['mode']!r}) missing keys {missing}")


def validate_telemetry_block(blk: dict, path: str = "?") -> None:
    """Raise ``ValueError`` when a telemetry block is malformed."""
    missing = [k for k in TELEMETRY_REQUIRED if k not in blk]
    if missing:
        raise ValueError(f"{path}: telemetry block missing keys {missing}")
    if blk["schema_version"] != SCHEMA_VERSION:
        raise ValueError(
            f"{path}: telemetry schema_version {blk['schema_version']!r} "
            f"!= pinned {SCHEMA_VERSION}")
    if blk["fenced"] is not True:
        raise ValueError(f"{path}: telemetry block not fenced")


def prometheus_text(registry: Optional[dict] = None) -> str:
    """Prometheus text-format dump of the live registry: counters as
    ``counter``, gauges as ``gauge``, histograms as ``summary``
    (count / sum / p50 / p99 quantiles)."""
    reg = registry if registry is not None else _m.get_registry()
    out = []

    def _name(n: str) -> str:
        return "repro_" + "".join(
            c if c.isalnum() or c == "_" else "_" for c in n)

    for k in sorted(reg["counters"]):
        nm = _name(k)
        out.append(f"# TYPE {nm} counter")
        out.append(f"{nm} {reg['counters'][k]}")
    for k in sorted(reg["gauges"]):
        nm = _name(k)
        out.append(f"# TYPE {nm} gauge")
        out.append(f"{nm} {reg['gauges'][k]:.6g}")
    for k in sorted(reg["histograms"]):
        h = reg["histograms"][k]
        nm = _name(k)
        out.append(f"# TYPE {nm} summary")
        out.append(f'{nm}{{quantile="0.5"}} {h["p50"]:.6g}')
        out.append(f'{nm}{{quantile="0.99"}} {h["p99"]:.6g}')
        out.append(f"{nm}_sum {h['sum']:.6g}")
        out.append(f"{nm}_count {h['count']}")
    return "\n".join(out) + "\n"
