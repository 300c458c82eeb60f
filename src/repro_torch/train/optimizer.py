"""AdamW with optional int8 gradient compression: the port of
``repro.train.optimizer``.

The optimizer state holds ``m`` and ``v`` in float32, one tensor a
parameter, keyed by the model's parameter names
(``model.named_parameters()``); ``convert.adamw_state_to_reference`` lays
them out as the reference's stacked tree.  ``adamw_update`` runs the
update in f32 and writes each parameter back in its own dtype, IN PLACE
under ``torch.no_grad`` -- the reference donates its parameter buffers to
the jitted step, and the port keeps that one copy of the weights
(ROADMAP.md section 3).  On a sharded model (``distributed.state``) the
moments are the rank's shards too and the update is elementwise on them;
the train step passes the global gradient norm (``grad_norm=``).
``compress`` / ``decompress`` give the int8 quantization with an
error-feedback residual; ``compressed_psum`` all-reduces it over one axis
of the active mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L
from repro_torch.models.transformer import stacked_ndim


class AdamWState(NamedTuple):
    step: torch.Tensor             # () int32
    m: Dict[str, torch.Tensor]     # parameter name -> f32 first moment
    v: Dict[str, torch.Tensor]     # parameter name -> f32 second moment


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_adamw(params) -> AdamWState:
    """Zero f32 moments for every parameter of ``params`` (the model), on
    its device, and step 0."""
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
             for k, p in named.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v={k: z.clone() for k, z in zeros.items()})


def _schedule(cfg: AdamWConfig, step):
    """Linear warmup of the learning rate over ``warmup_steps``."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor of ``tree`` (a dict or a
    sequence of tensors), each squared in f32."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def adamw_update(cfg: AdamWConfig, params, grads: Dict[str, torch.Tensor],
                 state: AdamWState, grad_norm=None
                 ) -> Tuple[object, AdamWState]:
    """One AdamW step on the model ``params`` with ``grads`` (parameter
    name -> gradient): global-norm clipping to ``grad_clip``, bias-
    corrected moments, decoupled weight decay on every parameter of two or
    more dims in the reference's stacked tree (``stacked_ndim``: each
    layer's norm gains and QKV biases too, not ``final_norm``).  The
    parameters are written in place; returns (params, new state).
    ``grad_norm`` is the norm to clip by (a sharded model's global one;
    ``global_norm(grads)`` when None)."""
    step = state.step + 1
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    lr = _schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    new_m, new_v = {}, {}
    with torch.no_grad():
        for name, p in params.named_parameters():
            g = grads[name].float() * scale
            m = cfg.b1 * state.m[name] + (1 - cfg.b1) * g
            v = cfg.b2 * state.v[name] + (1 - cfg.b2) * g * g
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if stacked_ndim(name, p) >= 2:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            new_m[name], new_v[name] = m, v
    return params, AdamWState(step=step, m=new_m, v=new_v)


# ------------------------------------------------------------------ int8
# gradient compression with error feedback (cross-pod all-reduce trick)

def compress(g: torch.Tensor, residual: torch.Tensor):
    """Per-tensor symmetric int8 quantization; returns (q, scale,
    new_resid)."""
    g32 = g.float() + residual
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, g32 - deq


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _map2(fn, g, r):
    """(tree of fn(g, r)[0], tree of fn(g, r)[1]) over matching trees of
    tensors (dicts, lists, tuples)."""
    if isinstance(g, dict):
        pairs = {k: _map2(fn, g[k], r[k]) for k in g}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    if isinstance(g, (list, tuple)):
        pairs = [_map2(fn, a, b) for a, b in zip(g, r)]
        return type(g)(v[0] for v in pairs), type(g)(v[1] for v in pairs)
    return fn(g, r)


def compressed_psum(grads, residuals, axis_name: str):
    """Quantize -> all-reduce of the int32 codes -> dequantize, carrying
    error feedback, over the axis ``axis_name`` of the active mesh
    (``layers.activation_sharding``; the reference's runs inside a
    shard_map over its mesh).  Per leaf of ``grads`` / ``residuals``
    (tensors, or dicts / lists of them): one sum all-reduce of the codes
    and one max all-reduce of the scales.  As in the reference, the sum of
    codes quantized at each rank's own scale is dequantized at the largest
    scale.  Returns (summed, new residuals)."""
    mesh = L._ACT["mesh"]
    if mesh is None:
        raise ValueError("compressed_psum needs a mesh: run it under "
                         "layers.activation_sharding")
    grp = C.mesh_group(mesh, (axis_name,))

    def one(g, r):
        q, scale, new_r = compress(g, r)
        total = C.all_reduce(q.to(torch.int32), grp)
        scale_max = C.all_reduce(scale, grp, op="max")
        return decompress(total, scale_max), new_r

    return _map2(one, grads, residuals)
