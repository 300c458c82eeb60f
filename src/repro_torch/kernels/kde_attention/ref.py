"""Plain-torch oracles for kde_attention, from
``repro.kernels.kde_attention.ref``.

``exact_decode_attention`` is the ground truth; the sampled algorithm's
plain mirror is ``kernel.kde_decode_plain`` (``ops.kde_attention_ref``),
built on ``top_blocks`` and ``_group_lse`` below.
"""
from __future__ import annotations

import torch

_NEG_INF = -1.0e30


def exact_decode_attention(q, k, v, kv_valid: int | None = None):
    """q (b, hq, dh); k, v (b, hkv, S, dh) -> (b, hq, dh)."""
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / (dh ** 0.5)
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    sc = torch.einsum("bhd,bhsd->bhs", q.float(), kk.float()) * scale
    if kv_valid is not None:
        sc = torch.where(torch.arange(s, device=q.device)[None, None]
                         < kv_valid, sc, _NEG_INF)
    p = _softmax(sc)
    return torch.einsum("bhs,bhsd->bhd", p, vv.float()).to(q.dtype)


def _softmax(x):
    m = torch.amax(x, dim=-1, keepdim=True)
    e = torch.exp(x - m)
    return e / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)


def top_blocks(est_kv, top_p: int):
    """Indices (b, hkv, top_p) of the ``top_p`` largest block estimates,
    the larger first and ties to the lower block index, as ``lax.top_k``
    and the reference's stable ``argsort(-est_kv)`` order them."""
    order = torch.sort(est_kv, dim=-1, descending=True, stable=True).indices
    return order[..., :top_p]


def _group_lse(est, group):
    b, hq, nb = est.shape
    e = est.reshape(b, hq // group, group, nb)
    m = torch.amax(e, dim=2)
    return m + torch.log(torch.clamp(
        torch.sum(torch.exp(e - m[:, :, None, :]), dim=2), min=1e-30))
