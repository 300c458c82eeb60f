"""The program's own spans in a traced run: what the ``program_span`` and
``program_counter`` metrics of a pipeline's stages read.

While a ``torch.profiler`` session is open the port records its spans
(``repro_torch.obs.metrics.span_records``): each with its parent, its
device seconds (between two CUDA events; host seconds on the CPU) and the
host syncs counted while it was the innermost open span.  A run reads the
last ``trace["calls"]`` records of the pipeline's root span, one a traced
call, with their descendants, so that it reads only its own window where
a process runs several.  A program without span records (an older port)
reads None.
"""
from __future__ import annotations


def calls(ctx, root: str):
    """The traced calls' span trees: a list, one a call, of the root
    record and its descendants; None where the run was not traced or the
    program recorded no ``root`` span."""
    tr = ctx.get("trace")
    if not tr or not tr["calls"]:
        return None
    try:
        from repro_torch.obs.metrics import span_records
    except ImportError:
        return None
    recs = span_records()
    roots = [r for r in recs if r["name"] == root and r["parent"] is None]
    roots = roots[-tr["calls"]:]
    if not roots:
        return None
    children = {}
    for r in recs:
        children.setdefault(r["parent"], []).append(r)
    trees = []
    for r in roots:
        tree, todo = [], [r]
        while todo:
            rec = todo.pop()
            tree.append(rec)
            todo.extend(children.get(rec["id"], []))
        trees.append(tree)
    return trees


def stage_seconds(ctx, root: str, stage: str):
    """Device seconds a traced call of the spans named ``stage`` under
    ``root``; None where there is nothing to read."""
    trees = calls(ctx, root)
    if trees is None:
        return None
    return sum(r["device_s"] for t in trees for r in t
               if r["name"] == stage) / len(trees)


def syncs_per_call(ctx, root: str):
    """Host syncs a traced call, counted under ``root`` and its
    descendants; None where there is nothing to read."""
    trees = calls(ctx, root)
    if trees is None:
        return None
    return sum(r["syncs"] for t in trees for r in t) / len(trees)
