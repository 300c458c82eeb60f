"""Flash attention entry point: the reference's padding and causal offset,
then the kernel (CUDA tensors) or its plain version (CPU tensors).

Forward only: the reference's custom VJP (a recompute through
``attention_ref``) is the training slice's work, so an input that needs a
gradient raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import no_switch, not_in_slice
from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _ref


def _pad_seq(a, mult, axis):
    rem = (-a.shape[axis]) % mult
    if rem == 0:
        return a
    pad = [0, 0] * (a.dim() - 1 - axis) + [0, rem]
    return F.pad(a, pad)


def _next_mult(s, base=128):
    return base if s >= base else 1 << max(s - 1, 0).bit_length()


def flash_args(q, k, v, causal=True, bq=128, bk=128):
    """(k, v, keyword arguments) of the kernel and its plain version for
    ``flash_attention(q, k, v, causal, bq, bk)``, as the reference's
    ``ops._fwd_impl`` derives them: block sizes ``bq_`` / ``bk_`` from
    ``_next_mult``, k / v zero-padded to a ``bk_`` multiple (masked through
    ``kv_valid = skv``), and the causal offset taken from the padded
    lengths, ``offset = padded skv - padded sq``.  When sq != skv that
    offset differs from ``attention_ref``'s ``skv - sq``; the port mirrors
    the reference (ROADMAP.md section 3).  q is not padded: the reference
    slices its padded rows away."""
    sq, dh = q.shape[2], q.shape[3]
    skv = k.shape[2]
    bq_ = min(bq, max(_next_mult(sq), 8))
    bk_ = min(bk, max(_next_mult(skv), 8))
    sq_p = -(-sq // bq_) * bq_
    kp = _pad_seq(k, bk_, 2)
    vp = _pad_seq(v, bk_, 2)
    return kp, vp, dict(causal=causal, scale=1.0 / (dh ** 0.5),
                        kv_valid=skv, offset=kp.shape[2] - sq_p)


def flash_attention(q, k, v, causal=True, bq=128, bk=128, interpret=None,
                    with_lse=False):
    """q (b, hq, sq, dh); k, v (b, hkv, skv, dh) -> out (b, hq, sq, dh)
    (and lse (b, hq, sq) with ``with_lse``): the kernel on CUDA tensors,
    its plain version on CPU tensors, with ``flash_args``' padding and
    offset.  ``interpret`` must be None (the device chooses)."""
    no_switch("interpret", interpret)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise not_in_slice("a gradient through flash attention",
                           12)
    kp, vp, kw = flash_args(q, k, v, causal, bq, bk)
    fn = _k.flash_attention_cuda if q.is_cuda else _k.flash_attention_plain
    out, lse = fn(q, kp, vp, **kw)
    return (out, lse) if with_lse else out


attention_ref = _ref.attention_ref
