"""Carry the reference's state across to the port.

The kernel-matrix side has no weights: its state is the dataset, the
kernel parameters, the preprocessed degrees (or row norms) and the hashed
estimator's bucket layout.  The LM's state is its parameter tree.  These
helpers build the port's objects from the same plain numbers the reference
was built from, so tests construct both sides from one set of numpy
arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kernels_fn import Kernel, make_kernel
from repro_torch.core.sampling.vertex import PrefixCDF
from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.kde_hash.ref import HashState
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def kernel_from_reference(name: str, bandwidth: float,
                          beta: float = 1.0) -> Kernel:
    """The port's Table-1 kernel with the reference kernel's ``name``,
    ``bandwidth`` and ``beta``."""
    if name == "rational_quadratic":
        return make_kernel(name, bandwidth=bandwidth, beta=beta)
    return make_kernel(name, bandwidth=bandwidth)


def dataset_from_numpy(x, device=None) -> torch.Tensor:
    """A (n, d) numpy dataset as a contiguous float32 tensor on
    ``device`` (the card by default)."""
    return as_f32(np.asarray(x), resolve_device(device))


def degrees_from_numpy(weights, seed: int = 0, device=None) -> PrefixCDF:
    """A numpy degree (or squared-row-norm) array as the port's float64
    ``PrefixCDF``, drawing from ``np.random.default_rng(seed)``."""
    return PrefixCDF(np.asarray(weights, np.float64), seed=seed,
                     device=device)


def hash_state_from_reference(state, device=None) -> HashState:
    """The reference's ``HashState`` (arrays read with ``np.asarray``) as
    the port's: ``members`` and ``overflow`` as int32 (the kernels' column
    type), the other integer arrays as int64 (uint32 keys keep their
    value), ``shift`` / ``self_stored`` as float32, on ``device``."""
    dev = resolve_device(device)

    def conv(name):
        a = getattr(state, name, None)     # x_bf16 is the port's own
        if a is None:
            return None
        a = np.array(a)
        if a.dtype.kind in "iu":
            a = a.astype(np.int32 if name in ("members", "overflow")
                         else np.int64)
        return torch.as_tensor(a).to(dev)

    return HashState(**{name: conv(name) for name in HashState._fields})


def _leaf(a, device: torch.device) -> torch.Tensor:
    """A reference parameter (numpy array) as a contiguous tensor on
    ``device``, copied (the reference's arrays may be read-only): a
    bfloat16 array (the reference's ``cast_params`` output, numpy dtype
    named "bfloat16") through its 16-bit integer view, so the bits are kept
    and ``ml_dtypes`` is not needed here; anything else as float32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.int16)))
        return bits.view(torch.bfloat16).to(device).contiguous()
    return as_f32(np.array(a, dtype=np.float32), device)


def params_from_reference(tree, cfg, device=None) -> "T.Transformer":
    """The reference's dense ``init_params`` tree (numpy arrays: ``embed``,
    ``layers`` stacked on a leading L axis, ``final_norm``, ``lm_head``
    unless tied) as the port's ``Transformer`` on ``device``.  A tree from
    the reference's ``cast_params`` (bfloat16 leaves beside the f32
    ``final_norm``) keeps its dtypes bit for bit.  Weights keep the reference's
    (in, out) layout: the port applies them as ``x @ w``, so nothing is
    transposed."""
    dev = resolve_device(device)

    def t(a):
        return _leaf(a, dev)

    lt = tree["layers"]
    attn, mlp = lt["attn"], lt["mlp"]
    bias = ("bq", "bk", "bv") if cfg.qkv_bias else ()
    layers = []
    for i in range(cfg.num_layers):
        a = L.Attention(*(t(attn[n][i]) for n in ("wq", "wk", "wv", "wo")),
                        *(t(attn[n][i]) for n in bias))
        m = L.MLP(*(t(mlp[n][i]) for n in ("w1", "w3", "w2")))
        layers.append(T.DenseLayer(t(lt["ln1"][i]), t(lt["ln2"][i]), a, m))
    head = tree.get("lm_head")
    return T.Transformer(cfg, t(tree["embed"]), layers, t(tree["final_norm"]),
                         None if head is None else t(head))


# ------------------------------------------------------------------ #
# the reference's stacked parameter tree <-> the port's parameter names
def _tree_paths(cfg):
    """(port name template, reference path) of every parameter of a dense
    config; a template with ``{i}`` is a layer parameter, stacked on the
    reference's leading L axis."""
    paths = [("embed", ("embed",)), ("final_norm", ("final_norm",))]
    if not cfg.tie_embeddings:
        paths.append(("lm_head", ("lm_head",)))
    layer = ["ln1", "ln2"] + [f"attn.{n}" for n in ("wq", "wk", "wv", "wo")]
    if cfg.qkv_bias:
        layer += [f"attn.{n}" for n in ("bq", "bk", "bv")]
    layer += [f"mlp.{n}" for n in ("w1", "w3", "w2")]
    paths += [("layers.{i}." + n, ("layers",) + tuple(n.split(".")))
              for n in layer]
    return paths


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array: bf16 as float32 (every bf16 value
    is a float32 value), anything else in its own dtype."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def named_to_tree(named, cfg) -> dict:
    """A dict keyed by the port's parameter names (tensors or arrays) as
    the reference's tree: numpy arrays, layer parameters stacked on a
    leading L axis."""
    tree: dict = {}
    for tmpl, path in _tree_paths(cfg):
        if "{i}" in tmpl:
            leaf = np.stack([_numpy(torch.as_tensor(named[tmpl.format(i=i)]))
                             for i in range(cfg.num_layers)])
        else:
            leaf = _numpy(torch.as_tensor(named[tmpl]))
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def tree_to_named(tree, cfg) -> dict:
    """The reference's tree (arrays) as numpy arrays (copies) keyed by the
    port's parameter names, layer parameters unstacked."""
    out = {}
    for tmpl, path in _tree_paths(cfg):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if "{i}" in tmpl:
            for i in range(cfg.num_layers):
                out[tmpl.format(i=i)] = np.array(leaf[i])
        else:
            out[tmpl] = np.array(leaf)
    return out


def params_to_reference(model) -> dict:
    """The port's ``Transformer`` as the reference's ``init_params`` tree of
    numpy arrays (bf16 parameters as float32 arrays of the same values)."""
    return named_to_tree(dict(model.named_parameters()), model.cfg)


def adamw_state_from_reference(state, model):
    """The reference's ``AdamWState`` (``step``, ``m``, ``v``: arrays read
    with ``np.asarray``, or the dict ``adamw_state_to_reference`` gives)
    as the port's, on the model's device: f32 moments keyed by the
    model's parameter names."""
    from repro_torch.train.optimizer import AdamWState
    get = state.get if isinstance(state, dict) else \
        (lambda k: getattr(state, k))
    dev = model.embed.device

    def moments(tree):
        return {k: as_f32(np.array(a, dtype=np.float32), dev)
                for k, a in tree_to_named(tree, model.cfg).items()}

    return AdamWState(
        step=torch.tensor(int(np.asarray(get("step"))), dtype=torch.int32,
                          device=dev),
        m=moments(get("m")), v=moments(get("v")))


def adamw_state_to_reference(state, cfg) -> dict:
    """The port's ``AdamWState`` as the reference's layout: {"step": int32
    array, "m": tree, "v": tree} of numpy arrays (``repro.train.
    optimizer.AdamWState(**...)`` takes it after ``jnp.asarray``)."""
    return {"step": np.asarray(int(state.step), np.int32),
            "m": named_to_tree(state.m, cfg),
            "v": named_to_tree(state.v, cfg)}
