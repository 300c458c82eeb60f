"""Sub-quadratic KDE decode attention -- the paper's technique as a serving
feature (DESIGN.md section 3); the port of ``repro.kernels.kde_attention.ops``.

Pipeline (one decode step, KV cache of length S):
  1. level-1 sweep: per-key-block strided-subsample lse estimates (the
     block-lse kernel on CUDA tensors, its plain version on CPU tensors);
  2. top-P block selection per kv-head (GQA group consensus);
  3. exact attention over the P gathered blocks;
  4. denominator correction with the estimated residual mass of the
     unselected blocks.
Steps 2-4 are torch ops, as the reference computes them outside Pallas.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kde_attention import kernel as _k
from repro_torch.kernels.kde_attention import ref as _ref

_NEG_INF = -1.0e30


def block_lse(q, k, *, scale, stride, kv_valid, bk):
    """Step (1): the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    fn = _k.block_lse_cuda if q.is_cuda else _k.block_lse_plain
    return fn(q, k, scale=scale, stride=stride, kv_valid=kv_valid, bk=bk)


def kde_attention(q, k, v, *, top_p: int, bk: int = 256, stride: int = 8,
                  kv_valid: int | None = None):
    """q (b, hq, dh); k, v (b, hkv, S, dh) -> (b, hq, dh).  S % bk == 0.

    ``torch.topk`` takes the top-P blocks; blocks tied at exactly -1e30
    (no valid key: early decode steps of a cache rounded up to bk) may be
    taken in another order than the reference's ``lax.top_k``, which does
    not change the output (their keys score -1e30 and their residual mass
    is exp(-1e30 - m) = 0)."""
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    nb = s // bk
    top_p = min(top_p, nb)
    scale = 1.0 / (dh ** 0.5)
    kv_valid = s if kv_valid is None else kv_valid
    dev = q.device

    # (1) level-1 KDE estimates per block
    est = block_lse(q, k, scale=scale, stride=stride, kv_valid=kv_valid,
                    bk=bk)                                # (b, hq, nb)

    # (2) block selection (shared within each GQA group)
    est_kv = _ref._group_lse(est, group)                  # (b, hkv, nb)
    sel = torch.topk(est_kv, top_p, dim=-1).indices       # (b, hkv, P)

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
    out = out.reshape(b, hq, dh) * frac[..., None]
    return out.to(q.dtype)


exact_decode_attention = _ref.exact_decode_attention
kde_attention_ref = _ref.kde_attention_ref
