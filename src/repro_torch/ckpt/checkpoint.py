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
template's dtype).

A sharded state (``distributed.state.shard_model``: each rank holds its
slices) is gathered to the host on save, so the npz is independent of the
mesh: every rank calls ``save`` (the gathers are collectives), rank 0
writes, and the call returns on every rank once the step is committed.
``restore(shardings=)`` re-shards onto any mesh (the reference's elastic
restore): each rank takes its slice of every array as it reads it, one
array at a time, and keeps only that.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import state as D
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


def _mesh_of(model: Transformer):
    """The mesh a sharded model's slices live on (None if not sharded)."""
    return getattr(model, "_mesh", None)


def _named(model: Transformer, named):
    """``named`` (parameter name -> tensor, the model's parameters or an
    AdamW moment dict) whole: gathered from the ranks' slices when the
    model is sharded."""
    mesh = _mesh_of(model)
    if mesh is None:
        return named
    specs = {n: D.spec_of(p) for n, p in model.named_parameters()}
    return D.full_named(named, specs, mesh)


def _as_tree(obj):
    """A state node as the reference's tree: a model as its parameter
    tree, tensors as numpy arrays."""
    if isinstance(obj, AdamWState):
        raise TypeError("an AdamWState is saved beside its model: pass "
                        "(model, opt_state)")
    if isinstance(obj, Transformer):
        return convert.named_to_tree(
            _named(obj, dict(obj.named_parameters())), obj.cfg)
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
    model = next((o for o in items if isinstance(o, Transformer)), None)
    for i, obj in enumerate(items):
        key = f"{i}/" if isinstance(state, (list, tuple)) else ""
        if isinstance(obj, AdamWState):
            if model is None:
                raise TypeError("an AdamWState is saved beside its model: "
                                "pass (model, opt_state)")
            whole = AdamWState(step=obj.step, m=_named(model, obj.m),
                               v=_named(model, obj.v))
            ref = convert.adamw_state_to_reference(whole, model.cfg)
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
    flat = _flatten(state)
    items = list(state) if isinstance(state, (list, tuple)) else [state]
    mesh = next((_mesh_of(o) for o in items if isinstance(o, Transformer)
                 and _mesh_of(o) is not None), None)
    name = f"step_{step:08d}"
    final = os.path.join(directory, name)
    if mesh is not None:
        import torch.distributed as dist
        if dist.get_rank() == 0:
            _write(directory, name, flat, step, extra_meta)
        # every rank returns once rank 0 has committed the step
        world = C.mesh_group(mesh, tuple(mesh.mesh_dim_names))
        C.all_reduce(torch.zeros(1, device=world.device), world)
        return final
    return _write(directory, name, flat, step, extra_meta)


def _write(directory: str, name: str, flat, step: int, extra_meta):
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
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


def _named_arrays(flat, prefix: str, cfg):
    """(parameter name, whole array) of every parameter stored under
    ``prefix``, reading one stored array at a time (a stacked one yields
    its layers)."""
    for tmpl, path, count in convert._tree_paths(cfg):
        arr = flat[prefix + "/".join(path)]
        if count is None:
            yield tmpl, arr
        else:
            for i in range(count):
                yield tmpl.format(i=i), arr[i]


def _slice(a: np.ndarray, sharding) -> np.ndarray:
    """The rank's slice of the whole array ``a`` under ``sharding`` (a
    ``distributed.sharding.Sharding``; None: all of it)."""
    if sharding is None:
        return a
    return SH.shard(torch.as_tensor(a), sharding.spec, sharding.mesh).numpy()


def _fill(key: str, template, flat, cfg, shardings=None):
    """``template`` with every leaf read from ``flat`` under ``key``: a
    model's parameters are copied into it in place, an ``AdamWState`` is
    rebuilt on the template's device, tensors come back as new tensors.
    With ``shardings`` (the template's structure, ``Sharding`` leaves)
    each leaf is the rank's slice; a model parameter whose shape is not
    its slice's is replaced by the slice (``distributed.state.set_param``),
    so a whole model restores onto a mesh too."""
    if isinstance(template, Transformer):
        params = dict(template.named_parameters())
        with torch.no_grad():
            for name, whole in _named_arrays(flat, key, template.cfg):
                p = params[name]
                shd = None if shardings is None else shardings[name]
                a = _slice(whole, shd)
                if tuple(a.shape) == tuple(p.shape):
                    p.copy_(_tensor(a, p))
                else:
                    D.set_param(template, name, torch.as_tensor(a).to(
                        device=p.device, dtype=p.dtype).contiguous(),
                        shd.spec, D.full_shape(p))
        if shardings is not None:
            template._mesh = next(iter(shardings.values())).mesh
        return template
    if isinstance(template, AdamWState):
        out = {}
        for f in ("m", "v"):
            shd = None if shardings is None else getattr(shardings, f)
            like = getattr(template, f)
            out[f] = {}
            for k, whole in _named_arrays(flat, f"{key}.{f}/", cfg):
                a = _slice(whole, None if shd is None else shd[k])
                out[f][k] = torch.as_tensor(np.array(a)).to(
                    device=like[k].device, dtype=like[k].dtype)
        return AdamWState(
            step=torch.tensor(int(flat[f"{key}.step"]), dtype=torch.int32,
                              device=template.step.device),
            m=out["m"], v=out["v"])
    if isinstance(template, (list, tuple)):
        return type(template)(
            _fill(f"{key}{i}/", t, flat, cfg,
                  None if shardings is None else shardings[i])
            for i, t in enumerate(template))
    if isinstance(template, dict):
        return {k: _fill(f"{key}{k}/", t, flat, cfg,
                         None if shardings is None else shardings[k])
                for k, t in template.items()}
    a = _slice(flat[key[:-1]], shardings)
    return _tensor(a, template) if tuple(np.shape(a)) == tuple(
        template.shape) else torch.as_tensor(np.asarray(a)).to(
        device=template.device, dtype=template.dtype)


def _matches(template, shardings) -> bool:
    """Whether ``shardings`` has ``template``'s structure."""
    if isinstance(template, Transformer):
        return isinstance(shardings, dict) and set(shardings) == {
            n for n, _ in template.named_parameters()}
    if isinstance(template, AdamWState):
        return isinstance(shardings, AdamWState) and all(
            isinstance(getattr(shardings, f), dict) for f in ("m", "v"))
    if isinstance(template, (list, tuple)):
        return isinstance(shardings, (list, tuple)) \
            and len(shardings) == len(template) \
            and all(_matches(t, s) for t, s in zip(template, shardings))
    if isinstance(template, dict):
        return isinstance(shardings, dict) and set(shardings) == set(
            template) and all(_matches(template[k], shardings[k])
                              for k in template)
    if isinstance(template, torch.Tensor):
        return shardings is None or isinstance(shardings, SH.Sharding)
    return False


def restore(directory: str, template: Any, step: Optional[int] = None,
            shardings: Any = None) -> Tuple[Any, int]:
    """Load the latest (or given) step into ``template``'s structure,
    dtypes and devices: the (model, opt_state) pair (the model's
    parameters are overwritten in place), or a tree of tensors.
    ``shardings`` re-shards onto any mesh (the reference's elastic
    restore): the template's structure with ``distributed.sharding.
    Sharding`` leaves, e.g. ``(param_shardings(model, mesh),
    AdamWState(step=None, m=p_shard, v=p_shard))``; each rank keeps its
    slice of every array."""
    if shardings is not None and not _matches(template, shardings):
        raise TypeError(
            f"restore(shardings=...) must have the template's structure "
            f"(a Sharding a tensor, a dict of them a model, an AdamWState "
            f"of them an AdamWState); got {type(shardings).__name__} for "
            f"{type(template).__name__}")
    if step is None:
        step = latest_step(directory)
        assert step is not None, f"no checkpoint in {directory}"
    name = f"step_{step:08d}"
    items = list(template) if isinstance(template, (list, tuple)) \
        else [template]
    cfg = next((o.cfg for o in items if isinstance(o, Transformer)), None)
    with np.load(os.path.join(directory, name, "arrays.npz")) as flat:
        if isinstance(template, (list, tuple)):
            state = type(template)(
                _fill(f"{i}/", t, flat, cfg,
                      None if shardings is None else shardings[i])
                for i, t in enumerate(template))
        else:
            state = _fill("", template, flat, cfg, shardings)
    return state, step
