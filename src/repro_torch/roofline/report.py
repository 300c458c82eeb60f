"""Refresh the analytic roofline fields of the port's dry-run JSON
(``launch/dryrun.py --out``) and render its table: the port of
``repro.roofline.report``.

  PYTHONPATH=src python -m repro_torch.roofline.report build/dryrun.json
"""
from __future__ import annotations

import json
import sys

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.roofline.analysis import roofline_terms
from repro_torch.roofline.flops import cell_cost


def refresh(path: str) -> list:
    with open(path) as f:
        records = json.load(f)
    for r in records:
        if not r.get("ok"):
            continue
        cfg = get_config(r["arch"])
        shape = SHAPES[r["shape"]]
        cost = cell_cost(cfg, shape, kde_decode=r.get("kde_decode", False))
        rl = roofline_terms(cost.flops, cost.model_flops, cost.hbm_bytes,
                            r["collectives"]["total_bytes_per_device"],
                            r["chips"], r.get("raw_cost"))
        r["roofline"] = rl.as_dict()
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
    return records


def _fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def render_markdown(records: list, mesh: str = "16x16") -> str:
    """One row a cell of ``mesh``: the rank's state bytes (the peak when
    it was measured), the three roofline terms against the H100 spec, the
    dominant one and the useful-FLOP ratio; "exceeds 80G HBM" marks a
    cell whose rank would not fit the card."""
    rows = [r for r in records if r.get("ok") and r["mesh"] == mesh]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = ["| arch | shape | mem/dev GiB | compute ms | memory ms | "
           "collective ms | dominant | useful ratio | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        rl = r["roofline"]
        mem = r["memory"]
        dev_bytes = mem["peak_estimate_bytes"] \
            if mem.get("peak_estimate_bytes") is not None \
            else mem["argument_bytes"]
        note = "kde-attn" if r.get("kde_decode") else ""
        if dev_bytes > 80 * 2**30:
            note += (";" if note else "") + "exceeds 80G HBM"
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_bytes(dev_bytes)} | "
            f"{rl['compute_s'] * 1e3:.2f} | {rl['memory_s'] * 1e3:.2f} | "
            f"{rl['collective_s'] * 1e3:.2f} | {rl['dominant']} | "
            f"{min(rl['useful_ratio'], 1.0):.2f} | {note} |")
    return "\n".join(out)


if __name__ == "__main__":
    path = sys.argv[1] if len(sys.argv) > 1 else "build/dryrun.json"
    recs = refresh(path)
    print(render_markdown(recs))
