"""Hashed-KDE engine: host layout build + device programs.

``build_hash_state`` runs ONCE on the host (numpy only, a copy of the
reference's build with the same RNG call order): hash every dataset row
with a random-shifted grid, sort by packed key, and freeze the buckets into
the padded layout of ``ref.HashState``.  After that every read is a device
program:

* ``hashed_query``      -- (m,) NEAR-exact + HT-FAR row-sum estimates plus
  the realized NEAR eval counts; O(max_bucket + num_far) kernel evals per
  query instead of O(n) (Definition 1.1 / Section 3.1).  Its weighted pass
  is the weighted-kv-sum CUDA kernel on a CUDA tensor.
* ``hashed_block_sums`` -- (w, B) level-1 block-sum estimates for a
  frontier of dataset indices (the ``level1="hash"`` read of the depth-2
  sampler).  Its weighted pass is the weighted-kv CUDA kernel.

Both take their FAR noise explicitly (``draw_query_noise`` /
``draw_frontier_noise`` draw it from a ``torch.Generator``) and return the
reference's counter word for the same static shapes.  ``hashed_query``
sets ``HT_HEAVY`` by the rule of the reference's kernel branch on every
device: statically, when the HT weight ``n/num_far`` exceeds
``guards.ht_bound()`` (the kernel returns only the reduced sum, so no
per-sample test is possible).  The reference's jnp branch tests each FAR
value against ``ht_frac()`` instead; ROADMAP.md §3 records the divergence.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import not_in_slice, resolve_device
from repro_torch.ft import guards as _g
from repro_torch.kernels.kde_hash import kernel as _k
from repro_torch.kernels.kde_hash import ref as _ref
from repro_torch.kernels.kde_sampler.ref import BLOCK_SUM_FLOOR
from repro_torch.obs import counters as _c


# --------------------------------------------------------------------- #
# host layout build (numpy; the reference's ops.py build, same RNG order)
# --------------------------------------------------------------------- #
def default_cell_width(kernel) -> float:
    """Two bandwidths per grid cell (the ``GridHBE`` default)."""
    return 2.0 * float(kernel.bandwidth)


def draw_grid(rng, d: int, num_hash_dims: int, cell_width: float):
    """Draw the random-shifted grid (hash-dim subset + per-dim shift) with
    the exact ``GridHBE(seed=...)`` RNG call order."""
    dims = rng.choice(d, size=min(int(num_hash_dims), d),
                      replace=False).astype(np.int32)
    shift = rng.uniform(0.0, cell_width, size=len(dims)).astype(np.float32)
    return dims, shift


def grid_keys(xn: np.ndarray, dims, shift, cell_width: float) -> np.ndarray:
    """(k,) uint32 packed grid keys of rows ``xn`` (float32 shift/floor
    arithmetic, bitwise equal to the device-side ``ref.query_codes``)."""
    codes = np.floor((xn[:, dims] + shift) / cell_width).astype(np.int32)
    keys = np.zeros(len(xn), np.uint32)
    for j in range(codes.shape[1]):
        keys = keys * np.uint32(_ref.HASH_MULT) + codes[:, j].astype(np.uint32)
    return keys


def bucket_table(keys: np.ndarray, rows: np.ndarray, max_bucket: int, rng):
    """Freeze the buckets of one key slice into the padded layout:
    (sorted unique keys, (U, max_bucket) member table of GLOBAL row ids,
    stored counts, concatenated stored row ids, per-bucket truncation
    flags).  Oversized buckets store a seeded subsample."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    uniq, counts_full = np.unique(sk, return_counts=True)
    starts = np.concatenate([[0], np.cumsum(counts_full)[:-1]])
    mb = int(max_bucket)
    members = np.zeros((max(len(uniq), 1), mb), np.int32)
    counts = np.zeros(max(len(uniq), 1), np.int32)
    counts[:len(uniq)] = np.minimum(counts_full, mb)
    truncated = np.zeros(max(len(uniq), 1), bool)
    truncated[:len(uniq)] = counts_full > mb
    stored = [np.zeros(0, np.int64)]
    for b in range(len(uniq)):
        seg = rows[order[starts[b]:starts[b] + counts_full[b]]]
        if counts_full[b] > mb:
            seg = rng.choice(seg, size=mb, replace=False)
        members[b, :len(seg)] = seg
        stored.append(seg)
    return uniq, members, counts, np.concatenate(stored), truncated


def build_hash_state(x, kernel, cell_width: float | None = None,
                     num_hash_dims: int = 8, max_bucket: int = 256,
                     seed: int = 0, live=None, overflow_cap: int = 0,
                     device=None):
    """Host-side layout build (once per dataset): returns ``(HashState on
    device, cell_width)``.  The RNG call order (hash-dim choice, shift,
    per-bucket overflow subsampling) is the reference's, so the same
    data, seed and width give the same layout bit for bit."""
    if live is not None or overflow_cap:
        raise not_in_slice("build_hash_state(live=, overflow_cap=)",
                           "queue 1, item 7")
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    xn = np.asarray(x, np.float32)
    n, d = xn.shape
    rng = np.random.default_rng(seed)
    w = float(cell_width if cell_width is not None
              else default_cell_width(kernel))
    dims, shift = draw_grid(rng, d, num_hash_dims, w)
    rows = np.arange(n, dtype=np.int64)
    keys = grid_keys(xn, dims, shift, w)
    uniq, members, counts, stored_rows, truncated = bucket_table(
        keys, rows, max_bucket, rng)
    stored = np.zeros(n, np.float32)
    stored[stored_rows] = 1.0
    point_bucket = np.searchsorted(uniq, keys)

    def dev_i64(a):
        return torch.as_tensor(np.asarray(a, np.int64)).to(dev)

    state = _ref.HashState(
        dims=dev_i64(dims), shift=torch.as_tensor(shift).to(dev),
        keys=dev_i64(uniq), members=torch.as_tensor(members).to(dev),
        counts=dev_i64(counts), point_bucket=dev_i64(point_bucket),
        self_stored=torch.as_tensor(stored).to(dev),
        truncated=torch.as_tensor(truncated).to(dev), overflow=None)
    return state, w


# --------------------------------------------------------------------- #
# noise
# --------------------------------------------------------------------- #
def draw_query_noise(m: int, num_far: int, n: int, generator, device):
    """(m, num_far) int32 FAR row indices uniform on [0, n) for one
    ``hashed_query`` call; None when ``num_far == 0``."""
    if num_far == 0:
        return None
    return torch.randint(0, n, (m, num_far), generator=generator,
                         dtype=torch.int32, device=device)


def draw_frontier_noise(w: int, num_blocks: int, num_far: int,
                        block_size: int, generator, device):
    """(w, B, num_far) int32 in-block FAR offsets uniform on [0,
    block_size) for one ``hashed_block_sums`` call."""
    return torch.randint(0, block_size, (w, num_blocks, num_far),
                         generator=generator, dtype=torch.int32,
                         device=device)


# --------------------------------------------------------------------- #
# device programs
# --------------------------------------------------------------------- #
def _weighted_pass(q, x, cols, wgt, *, kind, inv_bw, beta, pairwise,
                   reduce_sum):
    """One weighted kernel-value pass: the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if q.is_cuda:
        fn = _k.weighted_kv_sum_cuda if reduce_sum else _k.weighted_kv_cuda
        return fn(q, x, cols, wgt, kind, inv_bw, beta)
    fn = _k.weighted_kv_sum_plain if reduce_sum else _k.weighted_kv_plain
    return fn(q, x, cols, wgt, kind, inv_bw, beta, pairwise)


def _widths(state):
    """(max_bucket, overflow capacity) -- the static gather widths."""
    ov = int(state.overflow.shape[0]) if state.overflow is not None else 0
    return int(state.members.shape[1]), ov


def hashed_query(x, y, state, fidx, *, kind, inv_bw, beta, pairwise=None,
                 cell_width, num_far, n):
    """(m,) row-sum estimates + (m,) realized NEAR eval counts + a counter
    word -- the Definition 1.1 read at O(max_bucket + num_far) evals per
    query.  The word's status flags bucket truncation, out-of-range member
    indices and (statically, see the module note) a heavy HT weight."""
    cols, wgt, cnt, trunc = _ref.query_gather(y, state, fidx, cell_width,
                                              num_far, n)
    corrupt = torch.any((cols < 0) | (cols >= n))
    est = _weighted_pass(y, x, cols, wgt, kind=kind, inv_bw=inv_bw,
                         beta=beta, pairwise=pairwise, reduce_sum=True)
    heavy = num_far > 0 and float(n) / num_far > _g.ht_bound()
    st = _g.merge(_g.flag_if(corrupt, _g.STATE_CORRUPT),
                  _g.flag_if(torch.any(trunc), _g.BUCKET_OVERFLOW),
                  _g.HT_HEAVY if heavy else 0, _g.result_status(est))
    m = y.shape[0]
    mb, ov = _widths(state)
    cw = _c.word(status=st, evals=m * (mb + ov + num_far), l1_reads=m,
                 far_samples=m * num_far, overflow=m * ov)
    return est, cnt, cw


def _hashed_block_sums(x, src, state, off, *, kind, inv_bw, beta,
                       pairwise=None, num_far, block_size, num_blocks, n):
    """Core of ``hashed_block_sums`` (also called from the fused sampler
    programs of ``kde_sampler.ops``).  Returns ``(block sums, status)``."""
    cols, wgt, _, trunc = _ref.frontier_gather(src, state, off, num_far,
                                               block_size, num_blocks, n)
    kv = _weighted_pass(x[src], x, cols, wgt, kind=kind, inv_bw=inv_bw,
                        beta=beta, pairwise=pairwise, reduce_sum=False)
    bs = _ref.scatter_block_sums(kv, cols, src, state, num_far, block_size,
                                 num_blocks)
    st = _g.merge(_g.flag_if(torch.any((cols < 0) | (cols >= n)),
                             _g.STATE_CORRUPT),
                  _g.flag_if(torch.any(trunc), _g.BUCKET_OVERFLOW),
                  _g.sums_status(bs, BLOCK_SUM_FLOOR))
    return bs, st


def hashed_block_sums(x, src, state, off, *, kind, inv_bw, beta,
                      pairwise=None, num_far, block_size, num_blocks, n):
    """(w, B) level-1 estimates of a dataset frontier from O(max_bucket +
    B num_far) evals per row: exact NEAR scatter + ``num_far`` stratified
    FAR slots per block.  Returns ``(block sums, counter word)``."""
    bs, st = _hashed_block_sums(x, src, state, off, kind=kind, inv_bw=inv_bw,
                                beta=beta, pairwise=pairwise,
                                num_far=num_far, block_size=block_size,
                                num_blocks=num_blocks, n=n)
    w = src.shape[0]
    mb, ov = _widths(state)
    far = int(num_blocks) * int(num_far)
    cw = _c.word(status=st, evals=w * (mb + ov + far), l1_reads=w,
                 far_samples=w * far, overflow=w * ov)
    return bs, cw
