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
from repro_torch.models import ssm as S
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
    """The reference's ``init_params`` tree of any family (numpy arrays:
    ``embed``, ``layers`` stacked on a leading L axis, ``final_norm``,
    ``lm_head`` unless tied, the hybrid's ``shared_attn``, the enc-dec
    ``encoder``) as the port's ``Transformer`` on ``device``.  A tree from
    the reference's ``cast_params`` (bfloat16 leaves beside the f32 ones)
    keeps its dtypes bit for bit.  Weights keep the reference's (in, out)
    layout: the port applies them as ``x @ w``, so nothing is
    transposed."""
    dev = resolve_device(device)
    named = {k: _leaf(a, dev) for k, a in tree_to_named(tree, cfg).items()}
    return model_from_named(cfg, named)


def model_from_named(cfg, named) -> "T.Transformer":
    """The port's ``Transformer`` of ``cfg`` holding ``named``'s tensors
    (parameter name -> tensor, the names ``_tree_paths`` lists)."""
    def attn(pre):
        bias = ("bq", "bk", "bv") if cfg.qkv_bias else ()
        return L.Attention(*(named[pre + n] for n in ("wq", "wk", "wv", "wo")),
                           *(named[pre + n] for n in bias))

    def mlp(pre, moe=cfg.is_moe):
        if moe:
            return L.MoE(*(named[pre + n] for n in ("router", "w1", "w3",
                                                    "w2")))
        return L.MLP(*(named[pre + n] for n in ("w1", "w3", "w2")))

    def dense(pre, encdec=False, moe=cfg.is_moe):
        extra = dict(ln_x=named[pre + "ln_x"],
                     xattn=attn(pre + "xattn.")) if encdec else {}
        return T.DenseLayer(named[pre + "ln1"], named[pre + "ln2"],
                            attn(pre + "attn."), mlp(pre + "mlp.", moe),
                            **extra)

    def layer(i):
        pre = f"layers.{i}."
        if cfg.ssm_kind == "rwkv6":
            return T.RwkvLayer(named[pre + "ln1"], named[pre + "ln2"],
                               S.RWKV6(*(named[pre + "mix." + n]
                                         for n in _RWKV6)),
                               mlp(pre + "mlp."))
        if cfg.ssm_kind == "mamba2":
            mix = S.Mamba2(*(named[pre + "mix." + n] for n in _MAMBA2))
            if cfg.hybrid_attn_every:
                return T.MambaLayer(named[pre + "ln1"], mix)
            return T.MambaLayer(named[pre + "ln1"], mix, named[pre + "ln2"],
                                mlp(pre + "mlp."))
        return dense(pre, cfg.is_encdec)

    shared = encoder = None
    if "shared_attn.ln" in named:
        shared = T.SharedAttn(named["shared_attn.ln"],
                              attn("shared_attn.attn."),
                              named["shared_attn.ln2"],
                              mlp("shared_attn.mlp.", False))
    if cfg.is_encdec:
        encoder = T.Encoder([dense(f"encoder.layers.{i}.", moe=False)
                             for i in range(cfg.encoder_layers)],
                            named["encoder.final_norm"])
    return T.Transformer(cfg, named["embed"],
                         [layer(i) for i in range(cfg.num_layers)],
                         named["final_norm"], named.get("lm_head"), shared,
                         encoder)


# ------------------------------------------------------------------ #
# the reference's stacked parameter tree <-> the port's parameter names
_RWKV6 = ("mu", "wr", "wk", "wv", "wg", "ww", "w0", "u", "wo")
_MAMBA2 = ("in_proj", "bc_proj", "dt_proj", "dt_bias", "a_log", "d_skip",
           "out_proj")


def _tree_paths(cfg):
    """(port name template, reference path, count) of every parameter of
    ``cfg``'s model: a template with ``{i}`` is a stacked layer parameter,
    ``count`` layers on the reference's leading axis (None for the
    others)."""
    def attn(pre):
        names = ["wq", "wk", "wv", "wo"] + (["bq", "bk", "bv"]
                                            if cfg.qkv_bias else [])
        return [f"{pre}.{n}" for n in names]

    def mlp(moe):
        return [f"mlp.{n}" for n in (("router",) if moe else ())
                + ("w1", "w3", "w2")]

    dense = ["ln1", "ln2"] + attn("attn")
    if cfg.ssm_kind == "rwkv6":
        layer = ["ln1", "ln2"] + [f"mix.{n}" for n in _RWKV6] + mlp(False)
    elif cfg.ssm_kind == "mamba2":
        layer = ["ln1"] + [f"mix.{n}" for n in _MAMBA2]
        if not cfg.hybrid_attn_every:
            layer += ["ln2"] + mlp(False)
    else:
        layer = dense + (["ln_x"] + attn("xattn") if cfg.is_encdec else []) \
            + mlp(cfg.is_moe)
    paths = [("embed", ("embed",), None),
             ("final_norm", ("final_norm",), None)]
    if not cfg.tie_embeddings:
        paths.append(("lm_head", ("lm_head",), None))
    paths += [("layers.{i}." + n, ("layers",) + tuple(n.split(".")),
               cfg.num_layers) for n in layer]
    if cfg.ssm_kind == "mamba2" and cfg.hybrid_attn_every:
        paths += [("shared_attn." + n, ("shared_attn",) + tuple(n.split(".")),
                   None) for n in ["ln", "ln2"] + attn("attn") + mlp(False)]
    if cfg.is_encdec:
        paths.append(("encoder.final_norm", ("encoder", "final_norm"), None))
        paths += [("encoder.layers.{i}." + n,
                   ("encoder", "layers") + tuple(n.split(".")),
                   cfg.encoder_layers) for n in dense + mlp(False)]
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
    for tmpl, path, count in _tree_paths(cfg):
        if count is not None:
            leaf = np.stack([_numpy(torch.as_tensor(named[tmpl.format(i=i)]))
                             for i in range(count)])
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
    for tmpl, path, count in _tree_paths(cfg):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if count is not None:
            for i in range(count):
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
