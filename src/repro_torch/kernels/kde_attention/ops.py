"""Sub-quadratic KDE decode attention -- the paper's technique as a serving
feature (DESIGN.md section 3); the port of ``repro.kernels.kde_attention.ops``.

Pipeline (one decode step, KV cache of length S):
  1. level-1 sweep: per-key-block strided-subsample lse estimates;
  2. top-P block selection per kv-head (GQA group consensus);
  3. exact attention over the P gathered blocks;
  4. denominator correction with the estimated residual mass of the
     unselected blocks.
On CUDA tensors all four steps are one launch of the fused decode kernel
(``kernel.kde_decode_cuda``); on CPU tensors they are the torch ops of
``ref.kde_attention_ref`` (``kernel.kde_decode_plain``), as the reference
computes steps 2-4 outside Pallas.
"""
from __future__ import annotations

from repro_torch.device import no_switch
from repro_torch.kernels.kde_attention import kernel as _k
from repro_torch.kernels.kde_attention import ref as _ref


def kde_attention(q, k, v, *, top_p: int, bk: int = 256, stride: int = 8,
                  kv_valid: int | None = None, interpret: bool | None = None):
    """q (b, hq, dh); k, v (b, hkv, S, dh) -> (b, hq, dh).  S % bk == 0.

    The top-P blocks are taken larger first, ties to the lower block index,
    as the reference's ``lax.top_k`` takes them; blocks tied at exactly
    -1e30 (no valid key: early decode steps of a cache rounded up to bk)
    may be taken in any order without changing the output (their keys
    score -1e30 and their residual mass is exp(-1e30 - m) = 0).
    ``interpret`` must be None (the device chooses)."""
    no_switch("interpret", interpret)
    kv_valid = k.shape[2] if kv_valid is None else kv_valid
    fn = _k.kde_decode_cuda if q.is_cuda else _k.kde_decode_plain
    return fn(q, k, v, top_p=top_p, bk=bk, stride=stride, kv_valid=kv_valid)


exact_decode_attention = _ref.exact_decode_attention
#: the plain mirror of ``kde_attention``, also the fused kernel's plain
#: version (``kernel.kde_decode_plain``)
kde_attention_ref = _ref.kde_attention_ref
