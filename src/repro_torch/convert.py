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
