"""Pure-torch oracles for kde_attention, the mirror of
``repro.kernels.kde_attention.ref``.

``exact_decode_attention`` is the ground truth; ``kde_attention_ref``
mirrors the sampled algorithm (deterministic strided subsample ->
identical block selection) with ``block_lse_ref`` as its level-1 sweep.
They are also the fused decode kernel's plain versions
(``kernel.kde_decode_plain`` / ``kernel.block_lse_plain`` name them, and
``ops.kde_attention_ref`` re-exports the first).
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


def block_lse_ref(q, k, *, scale: float, stride: int, kv_valid: int,
                  bk: int):
    """Level-1 estimates (b, hq, S / bk) in f32: for each (batch, q-head,
    key block of ``bk``), ``log(stride * sum_i exp(q . k_i * scale))`` over
    the block's keys ``i = 0, stride, 2 stride, ...``, positions ``>=
    kv_valid`` at -1e30.  Only the strided keys are read, each GQA group's
    q-heads against its kv-head (the reference scores every key, then
    subsamples: the same values)."""
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    nb = s // bk
    ks = k.reshape(b, hkv, nb, bk, dh)[:, :, :, ::stride].float()
    qg = q.reshape(b, hkv, hq // hkv, dh).float()
    sc = torch.einsum("bhgd,bhnid->bhgni", qg, ks) * scale
    pos = (torch.arange(nb, device=q.device)[:, None] * bk
           + torch.arange(0, bk, stride, device=q.device)[None, :])
    sc = torch.where(pos < kv_valid, sc, _NEG_INF)
    m = torch.amax(sc, dim=-1)
    lse = m + torch.log(torch.clamp(
        torch.sum(torch.exp(sc - m[..., None]), dim=-1), min=1e-30))
    return (lse + math.log(float(stride))).reshape(b, hq, nb)


def kde_attention_ref(q, k, v, *, top_p: int, bk: int, stride: int,
                      kv_valid: int | None = None, with_est: bool = False):
    """q (b, hq, dh); k, v (b, hkv, S, dh) -> out (b, hq, dh) in q's dtype
    (and the estimates (b, hq, S / bk) with ``with_est``, the port's
    addition): the reference's four steps in torch ops.  No ``kv_valid``
    means every key is valid.  Gathered keys and values past ``kv_valid``
    are zeroed before they are read (a cache's unwritten slots may hold
    anything); their scores are -1e30 either way."""
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    kv_valid = s if kv_valid is None else kv_valid
    group = hq // hkv
    nb = s // bk
    top_p = min(top_p, nb)
    scale = 1.0 / (dh ** 0.5)
    dev = q.device

    # (1) level-1 KDE estimates per block
    est = block_lse_ref(q, k, scale=scale, stride=stride,
                        kv_valid=kv_valid, bk=bk)         # (b, hq, nb)

    # (2) block selection (shared within each GQA group)
    est_kv = _group_lse(est, group)                       # (b, hkv, nb)
    sel = top_blocks(est_kv, top_p)                       # (b, hkv, P)

    # (3) gather + exact attention over the selected blocks
    elem = (sel[..., None] * bk
            + torch.arange(bk, device=dev)).reshape(b, hkv, -1)
    idx = elem[..., None].expand(-1, -1, -1, dh)
    kg = torch.gather(k, 2, idx)                          # (b, hkv, P*bk, dh)
    vg = torch.gather(v, 2, idx)
    qg = q.reshape(b, hkv, group, dh)
    valid = elem < kv_valid                               # (b, hkv, P*bk)
    kg = torch.where(valid[..., None], kg, 0.0)
    vg = torch.where(valid[..., None], vg, 0.0)
    sc = torch.einsum("bhgd,bhsd->bhgs", qg.float(), kg.float()) * scale
    sc = torch.where(valid[:, :, None, :], sc, _NEG_INF)
    m = torch.amax(sc, dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l_sel = p.sum(-1)                                     # (b, hkv, g)
    out = torch.einsum("bhgs,bhsd->bhgd", p, vg.float())
    out = out / torch.clamp(l_sel, min=1e-30)[..., None]

    # (4) denominator correction with the estimated residual mass
    sel_q = torch.repeat_interleave(sel, group, dim=1)    # (b, hq, P)
    chosen = torch.zeros((b, hq, nb), dtype=torch.bool, device=dev)
    chosen.scatter_(2, sel_q, True)
    est_resid = torch.where(chosen, _NEG_INF, est)
    m_q = m.reshape(b, hq, 1)
    resid_mass = torch.exp(est_resid - m_q).sum(-1)       # (b, hq)
    l_q = l_sel.reshape(b, hq)
    frac = l_q / torch.clamp(l_q + resid_mass, min=1e-30)
    out = (out.reshape(b, hq, dh) * frac[..., None]).to(q.dtype)
    return (out, est) if with_est else out
