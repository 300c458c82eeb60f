"""Plain-torch oracles for kde_attention: the mirror of
``repro.kernels.kde_attention.ref``.

``exact_decode_attention`` is the ground truth; ``kde_attention_ref``
mirrors the sampled algorithm (deterministic strided subsample, so the
same block selection as the kernel pipeline).
"""
from __future__ import annotations

import math

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


def block_lse_ref(q, k, *, scale, stride, kv_valid, bk):
    """Mirror of the level-1 kernel: every score, then the strided
    subsample of each block."""
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    kk = torch.repeat_interleave(k, group, dim=1).float()
    sc = torch.einsum("bhd,bhsd->bhs", q.float(), kk) * scale
    sc = torch.where(torch.arange(s, device=q.device)[None, None] < kv_valid,
                     sc, _NEG_INF)
    nb = s // bk
    sc = sc.reshape(b, hq, nb, bk)[..., ::stride]      # strided subsample
    m = torch.amax(sc, dim=-1)
    lse = m + torch.log(torch.clamp(
        torch.sum(torch.exp(sc - m[..., None]), dim=-1), min=1e-30))
    return lse + math.log(float(stride))


def kde_attention_ref(q, k, v, *, top_p, bk, stride, kv_valid=None):
    """Plain-torch mirror of ops.kde_attention (same block selection;
    ``torch.topk`` in place of the reference's argsort, so fully-masked
    blocks tied at -1e30 may be taken in another order -- the output does
    not depend on which of them are taken)."""
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / (dh ** 0.5)
    kv_valid = s if kv_valid is None else kv_valid
    est = block_lse_ref(q, k, scale=scale, stride=stride, kv_valid=kv_valid,
                        bk=bk)                              # (b, hq, nb)
    est_kv = _group_lse(est, group)                         # (b, hkv, nb)
    nb = est.shape[-1]
    sel = torch.topk(est_kv, min(top_p, nb), dim=-1).indices  # (b, hkv, P)

    elem = (sel[..., None] * bk
            + torch.arange(bk, device=q.device)).reshape(b, hkv, -1)
    idx = elem[..., None].expand(-1, -1, -1, dh)
    kg = torch.gather(k, 2, idx)
    vg = torch.gather(v, 2, idx)
    kpos_valid = elem < kv_valid                            # (b, hkv, P*bk)

    kk = torch.repeat_interleave(kg, group, dim=1).float()
    vv = torch.repeat_interleave(vg, group, dim=1)
    valid = torch.repeat_interleave(kpos_valid, group, dim=1)
    sc = torch.einsum("bhd,bhsd->bhs", q.float(), kk) * scale
    sc = torch.where(valid, sc, _NEG_INF)
    m = torch.amax(sc, dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l_sel = p.sum(-1)
    out = torch.einsum("bhs,bhsd->bhd", p, vv.float()) \
        / torch.clamp(l_sel, min=1e-30)[..., None]

    # residual mass from the unselected blocks' estimates
    sel_q = torch.repeat_interleave(sel, group, dim=1)      # (b, hq, P)
    chosen = torch.zeros((b, hq, nb), dtype=torch.bool, device=q.device)
    chosen.scatter_(2, sel_q, True)
    est_resid = torch.where(chosen, _NEG_INF, est)
    resid_mass = torch.exp(est_resid - m).sum(-1)
    frac = l_sel / torch.clamp(l_sel + resid_mass, min=1e-30)
    return (out * frac[..., None]).to(q.dtype)


def _group_lse(est, group):
    b, hq, nb = est.shape
    e = est.reshape(b, hq // group, group, nb)
    m = torch.amax(e, dim=2)
    return m + torch.log(torch.clamp(
        torch.sum(torch.exp(e - m[:, :, None, :]), dim=2), min=1e-30))
