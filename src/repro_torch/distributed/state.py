"""The LM's sharded state: each rank keeps only its shard of every
parameter (and of AdamW's ``m`` / ``v``, made from the sharded model by
``optimizer.init_adamw``) under ``sharding.param_spec``, the memory
layout of the reference's FSDP ("data") x TP / EP ("model") x DP ("pod")
rules.  A sharded parameter carries its spec (``sharding.SPEC_ATTR``) and
its global shape (``sharding.FULL_SHAPE_ATTR``); ``models/layers.py``
reads the spec to gather what a block's compute needs.

The train step's gradient bookkeeping lives here too: after the backward
a parameter split over "data" already holds its summed shard (the
gathers' reduce-scatter); ``reduce_grads`` sums the ones replicated over
"data" with one all-reduce of their concatenation (and over "model" after
a context-parallel step), then every gradient
over "pod" (the replicas' mean: each rank's objective is its share of the
global batch), and ``global_grad_norm`` takes the global norm with one
all-reduce of the ranks' squared shard norms (each divided by the number
of ranks holding that slice).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import FULL_SHAPE_ATTR, SPEC_ATTR


def spec_of(p) -> Tuple:
    """A parameter's spec (replicated when it carries none)."""
    return getattr(p, SPEC_ATTR, None) or (None,) * p.dim()


def full_shape(p) -> Tuple[int, ...]:
    return tuple(getattr(p, FULL_SHAPE_ATTR, p.shape))


def _owner(model: nn.Module, name: str):
    *path, attr = name.split(".")
    mod = model
    for a in path:
        mod = getattr(mod, a)
    return mod, attr


def set_param(model: nn.Module, name: str, t: torch.Tensor, spec,
              shape) -> nn.Parameter:
    """Replace parameter ``name`` of ``model`` by ``t``, tagged with its
    spec and global shape."""
    mod, attr = _owner(model, name)
    p = nn.Parameter(t)
    setattr(p, SPEC_ATTR, tuple(spec))
    setattr(p, FULL_SHAPE_ATTR, tuple(shape))
    setattr(mod, attr, p)
    return p


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """``model`` in place with each parameter replaced by the rank's slice
    of it (a copy: the whole tensor is freed) under ``param_spec``."""
    for name, p in list(model.named_parameters()):
        spec = SH.param_spec(name, p.shape, mesh)
        t = SH.shard(p.detach(), spec, mesh).contiguous().clone()
        set_param(model, name, t, spec, p.shape)
    model._mesh = mesh
    return model


def unshard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's slice ``t`` (counted
    all-gathers, one a split dim; every rank gets it)."""
    for d, e in enumerate(spec):
        axes = SH.entry_axes(e)
        if axes:
            t = C.all_gather(t.contiguous(), C.mesh_group(mesh, axes), d)
    return t


def full_named(named: Dict[str, torch.Tensor], specs: Dict[str, Tuple],
               mesh) -> Dict[str, torch.Tensor]:
    """Name -> whole tensor of a sharded dict (parameters or AdamW
    moments) whose slices follow ``specs``."""
    with torch.no_grad():
        return {k: unshard(t.detach(), specs[k], mesh)
                for k, t in named.items()}


def state_bytes(model: nn.Module, opt_state=None) -> int:
    """Bytes the rank holds of the parameters (and AdamW's moments)."""
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    if opt_state is not None:
        n += sum(t.numel() * t.element_size()
                 for d in (opt_state.m, opt_state.v) for t in d.values())
    return n


# --------------------------------------------------------------------- #
# gradients
# --------------------------------------------------------------------- #
def _bucket_reduce(grads: Dict[str, torch.Tensor], names: Sequence[str],
                   grp) -> None:
    """Sum ``grads[names]`` over ``grp``: one all-reduce of their
    concatenation a dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for n in names:
        by_dtype.setdefault(grads[n].dtype, []).append(n)
    for ns in by_dtype.values():
        flat = torch.cat([grads[n].reshape(-1) for n in ns])
        flat = C.all_reduce(flat, grp)
        at = 0
        for n in ns:
            k = grads[n].numel()
            grads[n] = flat[at:at + k].view_as(grads[n])
            at += k


def reduce_grads(model: nn.Module, grads: Dict[str, torch.Tensor],
                 mesh, model_partial: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """Bring the rank's gradients to their shards' global values, in
    place: those of parameters replicated over "data" are summed over it
    (and, with ``model_partial`` -- a step whose sequence was split over
    "model", each rank's backward its chunk's share -- those replicated
    over "model" over it too, one all-reduce a set of axes), then every
    one over "pod"."""
    shape = SH.mesh_shape(mesh)
    sums = [a for a in ("data", "model") if a in shape
            and (a == "data" or model_partial)]
    by_axes: Dict[Tuple[str, ...], list] = {}
    for n, p in model.named_parameters():
        used = {a for e in spec_of(p) for a in SH.entry_axes(e)}
        axes = tuple(a for a in sums if a not in used)
        if axes:
            by_axes.setdefault(axes, []).append(n)
    for axes, names in by_axes.items():
        _bucket_reduce(grads, names, C.mesh_group(mesh, axes))
    if "pod" in shape:
        _bucket_reduce(grads, [n for n, _ in model.named_parameters()],
                       C.mesh_group(mesh, ("pod",)))
    return grads


def global_grad_norm(model: nn.Module, grads: Dict[str, torch.Tensor],
                     mesh, extra: Sequence[torch.Tensor] = ()):
    """(the global gradient norm, the world sums of ``extra``): one
    all-reduce over every rank of the squared shard norms (a slice held
    by r ranks counts 1 / r on each) stacked with ``extra``."""
    ssq = sum(torch.sum(torch.square(grads[n].float()))
              / SH.replication(spec_of(p), mesh)
              for n, p in model.named_parameters())
    vec = torch.stack([ssq.reshape(()), *[e.reshape(()).float()
                                          for e in extra]])
    world = C.mesh_group(mesh, tuple(mesh.mesh_dim_names))
    red = C.all_reduce(vec, world)
    return torch.sqrt(red[0]), red[1:]
