"""Checkpointing with atomic commit: the port of ``repro.ckpt.checkpoint``.

Layout (the reference's):
  <dir>/step_000123.tmp/   -> written, fsync'd, then renamed to
  <dir>/step_000123/       (rename is the atomic commit point)
      meta.json            (step, the array keys)
      arrays.npz           (flat param/opt leaves on the host)
  <dir>/LATEST             (text file with the last committed step)

The npz keys are the reference's: a state ``(model, opt_state)`` flattens
to ``0/embed``, ``0/layers/attn/wq`` (layer parameters stacked on a
leading L axis), ``1/.step``, ``1/.m/...``, ``1/.v/...``, so each package
restores a checkpoint the other wrote.  bf16 parameters are stored as
float32 arrays of the same values (a restore casts each array to its
template's dtype).  ``restore(shardings=)`` needs the sharded LM state (ROADMAP.md
queue 1 item 12).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.device import not_in_slice
from repro_torch.models.transformer import Transformer
from repro_torch.train.optimizer import AdamWState


def _flat(prefix: str, tree, out: Dict[str, np.ndarray]) -> None:
    """The reference's ``_flatten`` of a (numpy) tree: dict keys and
    sequence indices joined by "/"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(f"{prefix}{k}/", tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            _flat(f"{prefix}{i}/", t, out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def _as_tree(obj):
    """A state node as the reference's tree: a model as its parameter
    tree, tensors as numpy arrays."""
    if isinstance(obj, AdamWState):
        raise TypeError("an AdamWState is saved beside its model: pass "
                        "(model, opt_state)")
    if isinstance(obj, Transformer):
        return convert.params_to_reference(obj)
    if isinstance(obj, torch.Tensor):
        return convert._numpy(obj)
    if isinstance(obj, (list, tuple)):
        return [_as_tree(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _as_tree(v) for k, v in obj.items()}
    return obj


def _flatten(state) -> Dict[str, np.ndarray]:
    """Every leaf of ``state`` under the reference's key.  An
    ``AdamWState`` takes its layout from the model found beside it (the
    (model, opt_state) pair every caller saves)."""
    out: Dict[str, np.ndarray] = {}
    items = list(state) if isinstance(state, (list, tuple)) else [state]
    cfg = next((o.cfg for o in items if isinstance(o, Transformer)), None)
    for i, obj in enumerate(items):
        key = f"{i}/" if isinstance(state, (list, tuple)) else ""
        if isinstance(obj, AdamWState):
            if cfg is None:
                raise TypeError("an AdamWState is saved beside its model: "
                                "pass (model, opt_state)")
            ref = convert.adamw_state_to_reference(obj, cfg)
            for f in ("step", "m", "v"):
                _flat(f"{key}.{f}/", ref[f], out)
        else:
            _flat(key, _as_tree(obj), out)
    return out


def save(directory: str, step: int, state: Any,
         extra_meta: Optional[Dict] = None) -> str:
    """Write ``state`` (the (model, opt_state) pair, or any tree of
    tensors) as step ``step`` of ``directory``: a ``.tmp`` directory
    written and fsync'd, renamed into place (the commit), ``LATEST``
    replaced atomically, all but the last 3 steps pruned.  Returns the
    step's directory."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(state)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = {"step": step, "keys": sorted(flat.keys())}
    meta.update(extra_meta or {})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic commit
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    # prune older checkpoints (keep last 3)
    kept = sorted(d for d in os.listdir(directory) if d.startswith("step_")
                  and not d.endswith(".tmp"))
    for old in kept[:-3]:
        shutil.rmtree(os.path.join(directory, old), ignore_errors=True)
    return final


def latest_step(directory: str) -> Optional[int]:
    """The step ``LATEST`` names, or None when there is none committed."""
    path = os.path.join(directory, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        name = f.read().strip()
    full = os.path.join(directory, name)
    if not os.path.isdir(full):
        return None
    return int(name.split("_")[1])


def _tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``a`` as a tensor of ``like``'s dtype, shape and device."""
    t = torch.as_tensor(np.asarray(a).reshape(tuple(like.shape)))
    return t.to(device=like.device, dtype=like.dtype)


def _subtree(flat: Dict[str, np.ndarray], prefix: str) -> dict:
    """The arrays of ``flat`` under ``prefix`` as a nested dict."""
    tree: dict = {}
    for k, a in flat.items():
        if k.startswith(prefix):
            node = tree
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = a
    return tree


def _fill(key: str, template, flat: Dict[str, np.ndarray], cfg):
    """``template`` with every leaf read from ``flat`` under ``key``: a
    model's parameters are copied into it in place, an ``AdamWState`` is
    rebuilt on the template's device, tensors come back as new tensors."""
    if isinstance(template, Transformer):
        named = convert.tree_to_named(_subtree(flat, key), template.cfg)
        with torch.no_grad():
            for name, p in template.named_parameters():
                p.copy_(_tensor(named[name], p))
        return template
    if isinstance(template, AdamWState):
        m, v = (convert.tree_to_named(_subtree(flat, f"{key}.{f}/"), cfg)
                for f in ("m", "v"))
        return AdamWState(
            step=torch.tensor(int(flat[f"{key}.step"]), dtype=torch.int32,
                              device=template.step.device),
            m={k: _tensor(m[k], t) for k, t in template.m.items()},
            v={k: _tensor(v[k], t) for k, t in template.v.items()})
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(f"{key}{i}/", t, flat, cfg)
                              for i, t in enumerate(template))
    if isinstance(template, dict):
        return {k: _fill(f"{key}{k}/", t, flat, cfg)
                for k, t in template.items()}
    return _tensor(flat[key[:-1]], template)


def restore(directory: str, template: Any, step: Optional[int] = None,
            shardings: Any = None) -> Tuple[Any, int]:
    """Load the latest (or given) step into ``template``'s structure,
    dtypes and devices: the (model, opt_state) pair (the model's
    parameters are overwritten in place), or a tree of tensors.
    ``shardings`` (the reference's re-shard onto a mesh) must be None."""
    if shardings is not None:
        raise not_in_slice("restore(shardings=...)", 12)
    if step is None:
        step = latest_step(directory)
        assert step is not None, f"no checkpoint in {directory}"
    name = f"step_{step:08d}"
    with np.load(os.path.join(directory, name, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    items = list(template) if isinstance(template, (list, tuple)) \
        else [template]
    cfg = next((o.cfg for o in items if isinstance(o, Transformer)), None)
    if isinstance(template, (list, tuple)):
        state = type(template)(_fill(f"{i}/", t, flat, cfg)
                               for i, t in enumerate(template))
    else:
        state = _fill("", template, flat, cfg)
    return state, step
