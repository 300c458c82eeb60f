"""Plain-torch oracle for flash attention (causal, GQA), with lse output:
the mirror of ``repro.kernels.flash_attention.ref``."""
from __future__ import annotations

import torch

_NEG_INF = -1.0e30


def attention_ref(q, k, v, *, causal: bool, scale: float,
                  kv_valid: int | None = None):
    """q (b, hq, sq, dh); k, v (b, hkv, skv, dh) -> (out, lse).  Queries
    sit at the end of the key timeline (row i at position i + skv - sq)."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if kv_valid is not None:
        mask = mask & (kpos < kv_valid)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        mask = mask & (kpos <= qpos)
    s = torch.where(mask[None, None], s, _NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / torch.clamp(l, min=1e-30),
                       vv.float())
    lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
    return out.to(q.dtype), lse
