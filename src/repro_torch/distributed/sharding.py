"""Sharding rules: FSDP('data') x TP/EP('model') x DP('pod') -- the port of
``repro.distributed.sharding``.

Every parameter gets a (tp_dim, fsdp_dim) preference by name; dimensions are
sharded only when divisible by the mesh axis (fallback: replicate that dim --
e.g. granite's vocab 49155 is not divisible by 16, so the embed falls back to
sharding d_model).

A spec is a tuple with one entry a tensor dim: ``None`` (replicated), an
axis name, or a tuple of axis names (the reference's ``PartitionSpec``).
The port's layers are unstacked (an ``nn.ModuleList``), so a layer
parameter's spec is the reference's spec of its stacked leaf minus the
leading L dim, which the reference never shards.  The decode caches keep
the reference's stacked layout, so ``cache_spec`` is the reference's one
to one.  ``placements`` turns a spec into ``Shard(d)`` / ``Replicate()``
per mesh dim; ``shard`` takes a rank's slice of a full tensor.

A mesh is a ``DeviceMesh`` or, for the rules alone, a mapping of axis
name to size (the reference's ``AbstractMesh``: no devices, no ranks).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig

# name -> (tp_dim, fsdp_dim) in the *unstacked* parameter's dims;
# None entries mean "replicate".
_RULES: Dict[str, Tuple[Optional[int], Optional[int]]] = {
    "wq": (1, 0), "wk": (1, 0), "wv": (1, 0), "wo": (0, 1),
    "bq": (0, None), "bk": (0, None), "bv": (0, None),
    "w1": (None, None),  # resolved per-arity below (dense vs moe)
    "w2": (None, None),
    "w3": (None, None),
    "router": (1, 0),
    "wr": (1, 0), "wg": (1, 0), "ww": (1, 0),
    "w0": (0, None), "u": (0, None),
    "in_proj": (1, 0), "bc_proj": (1, 0), "dt_proj": (1, 0),
    "out_proj": (0, 1),
    # embed/head: TP only (no FSDP) -- keeps the logits matmul collective-free
    # (x(b['data'],s,D) @ head(D, V['model']) is fully local) and the embed
    # lookup a cheap local gather + 'model' psum.
    "embed": (0, None), "lm_head": (1, None),
    "mu": (None, 1),
}

Spec = Tuple


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names or ()
    return {n: int(mesh.size(i)) for i, n in enumerate(names)}


def _axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _maybe(dim_size: int, size: int) -> bool:
    return size > 1 and dim_size % size == 0 and dim_size >= size


def param_spec(path: str, leaf, mesh) -> Spec:
    """The spec of the parameter named ``path`` (``model.
    named_parameters()``) whose shape is ``leaf``'s (a tensor or a shape)
    on ``mesh``: the reference's ``param_spec`` of the same leaf, less a
    stacked leaf's leading L dim."""
    shape = tuple(getattr(leaf, "shape", leaf))
    leaf = path.split(".")[-1]
    nd = len(shape)
    dsize = _axis_size(mesh, "data")
    msize = _axis_size(mesh, "model")
    if nd <= 0:
        return ()
    if leaf in ("w1", "w2", "w3"):
        if nd == 3:        # MoE (E, D, F)/(E, F, D): EP on experts
            tp, fsdp = 0, 1
        elif leaf == "w2":  # dense (F, D)
            tp, fsdp = 0, 1
        else:               # dense (D, F)
            tp, fsdp = 1, 0
    elif leaf in _RULES:
        tp, fsdp = _RULES[leaf]
    else:
        return (None,) * nd  # norms, scalars, biases -> replicated
    spec = [None] * nd
    if tp is not None and tp < nd and _maybe(shape[tp], msize):
        spec[tp] = "model"
    else:
        tp = None
    if fsdp is not None and fsdp < nd and fsdp != tp \
            and _maybe(shape[fsdp], dsize):
        spec[fsdp] = "data"
    # embed fallback: vocab not divisible -> TP the d_model dim instead
    if leaf == "embed" and spec[0] is None and _maybe(shape[1], msize) \
            and spec[1] != "data":
        spec[1] = "model"
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The port's ``NamedSharding``: a mesh and a spec."""
    mesh: object
    spec: Spec


#: the attributes under which a sharded parameter carries its spec and its
#: global shape (``distributed.state.shard_model``)
SPEC_ATTR = "_repro_spec"
FULL_SHAPE_ATTR = "_repro_full_shape"


def param_specs_tree(model, mesh) -> Dict[str, Spec]:
    """Parameter name -> spec for every parameter of ``model`` (of its
    global shape when it is already sharded)."""
    return {n: param_spec(n, getattr(p, FULL_SHAPE_ATTR, p.shape), mesh)
            for n, p in model.named_parameters()}


def param_shardings(model, mesh) -> Dict[str, Sharding]:
    """Parameter name -> ``Sharding`` for every parameter of ``model``."""
    return {n: Sharding(mesh, s)
            for n, s in param_specs_tree(model, mesh).items()}


# ------------------------------------------------------------------ data
def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def batch_spec(mesh, ndim: int, batch_size: Optional[int] = None) -> Spec:
    axes = batch_axes(mesh)
    if batch_size is not None:
        shape = mesh_shape(mesh)
        nshards = int(np.prod([shape[a] for a in axes])) if axes else 1
        if batch_size % max(nshards, 1) != 0:
            return (None,) * ndim
    return (axes,) + (None,) * (ndim - 1)


def data_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh, specs):
    return {k: Sharding(mesh, batch_spec(mesh, len(v.shape)))
            for k, v in specs.items()}


def cache_spec(cfg: ArchConfig, shape: ShapeConfig, mesh, leaf_name: str,
               leaf) -> Spec:
    """Decode-cache sharding.

    batch >= data shards -> shard batch (and kv-heads over 'model' when
    divisible); batch == 1 (long-context) -> shard the *sequence* dim over
    every available axis (the flash-decode logsumexp combine is sound under
    the softmax decomposition).  ``leaf`` is anything with a ``shape``."""
    ms = mesh_shape(mesh)
    baxes = batch_axes(mesh)
    nshards = int(np.prod([ms[a] for a in baxes]))
    msize = _axis_size(mesh, "model")
    shp = tuple(leaf.shape)
    spec = [None] * len(shp)
    if leaf_name in ("k", "v"):
        # (L, B, Hkv, S, hd)
        if shp[1] % nshards == 0 and shp[1] >= nshards:
            spec[1] = baxes
            if _maybe(shp[2], msize):
                spec[2] = "model"
            else:
                spec[3] = "model" if _maybe(shp[3], msize) else None
        else:
            axes = baxes if _maybe(shp[2], msize) else baxes + ("model",)
            if _maybe(shp[2], msize):
                spec[2] = "model"
            spec[3] = axes
    elif leaf_name == "ssm":
        # (L, B, H, ., .) -- state is small; shard batch if possible
        if shp[1] % nshards == 0 and shp[1] >= nshards:
            spec[1] = baxes
        if _maybe(shp[2], msize):
            spec[2] = "model"
    elif leaf_name in ("shift", "memory"):
        if shp[-3 if leaf_name == "memory" else 1] % nshards == 0:
            spec[0 if leaf_name == "memory" else 1] = baxes
        if leaf_name == "memory":
            spec = [baxes if shp[0] % nshards == 0 else None, None, None]
    return tuple(spec)


def cache_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh, cache):
    return {k: Sharding(mesh, cache_spec(cfg, shape, mesh, k, v))
            for k, v in cache.items()}


# ------------------------------------------------------------------ slices
def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh):
    """``spec`` as DTensor placements: ``Shard(d)`` on each mesh dim that
    shards tensor dim d, ``Replicate()`` on the others (a mesh dim shards
    one tensor dim at most)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec) if name in entry_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_index(entry, mesh) -> Tuple[int, int]:
    """(this rank's index, number of shards) along a tensor dim whose spec
    entry is ``entry``: the row-major index of the rank's coordinates over
    the entry's axes."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for a in entry_axes(entry):
        size = int(mesh.size(names.index(a)))
        idx = idx * size + int(coord[names.index(a)])
        n *= size
    return idx, n


def shard(t, spec: Spec, mesh):
    """This rank's slice of the full tensor ``t`` under ``spec``."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        i, n = shard_index(entry, mesh)
        size = t.shape[d] // n
        t = t.narrow(d, i * size, size)
    return t


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's slice of a ``shape`` tensor under ``spec``."""
    ms = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            out[d] //= ms[a]
    return tuple(out)


def replication(spec: Spec, mesh) -> int:
    """How many ranks hold the same slice under ``spec``: the product of
    the mesh axes the spec does not use."""
    ms = mesh_shape(mesh)
    used = {a for e in spec for a in entry_axes(e)}
    return int(np.prod([s for a, s in ms.items() if a not in used]))
