"""Plain-torch hashing math and oracles of the hashed-KDE engine.

The torch mirror of ``repro.kernels.kde_hash.ref``.  The KAP22/DEANN
decomposition (Section 3.1 black-box slot) splits a KDE query into an
exact NEAR term over the query's random-shifted grid bucket and a
Horvitz-Thompson FAR term over uniform samples of the complement:

    KDE(y) = sum_{x in NEAR(y)} k(x, y)  +  (n/s) * sum_j k(x_{i_j}, y) *
                                             1{x_{i_j} not in NEAR(y)}

The HT weight has a known inclusion probability, so the FAR term is
unbiased for any bucket assignment (truncated buckets included).

Differences from the reference, all in form, none in the function:

* bucket keys are uint32 there; torch has no full uint32 arithmetic, so
  here they are int64 holding the same 32-bit value.  ``pack_codes``
  multiplies by the 32-bit ``HASH_MULT`` in two 16-bit halves, so no
  intermediate passes 2^48 and the wraparound is exact;
* the gathers take their FAR noise explicitly -- ``fidx`` (m, num_far)
  row indices for queries, ``off`` (w, B, num_far) in-block offsets for
  frontiers -- the way the port's other programs take Gumbel and uniform
  noise, so tests can feed both sides the reference's own draws;
* the gathers return the evaluation columns, not the gathered rows: the
  CUDA kernel reads ``x[cols]`` itself and never forms the (m, t, d)
  tensor.  The plain weighted pass forms it.  The columns come out int32
  (``members`` is int32, and so is the drawn FAR noise), the kernels'
  own column type, so no launch converts them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.kde_sampler.ref import (BLOCK_SUM_FLOOR, _L2_KINDS,
                                                 _finish_l2, _finish_l2_bf16,
                                                 check_precision, round_bf16)

# Knuth's 2^32 golden-ratio multiplier; the multiply-add wraps mod 2^32.
HASH_MULT = 2654435761
_MASK32 = 0xFFFFFFFF
_MULT_HI, _MULT_LO = HASH_MULT >> 16, HASH_MULT & 0xFFFF


class HashState(NamedTuple):
    """Device-resident padded-bucket layout (all tensors on one device).

    ``members`` holds GLOBAL dataset row indices, ``max_bucket`` slots per
    bucket with slot >= counts[b] as padding; buckets larger than
    ``max_bucket`` store a seeded subsample and their overflow members stay
    FAR-eligible.
    """

    dims: torch.Tensor          # (h,)  int64  hashed coordinate subset
    shift: torch.Tensor         # (h,)  f32    random grid shift
    keys: torch.Tensor          # (U,)  int64  sorted packed keys in [0, 2^32)
    members: torch.Tensor       # (U, max_bucket) int32 global row indices
    #                                          (the kernels' column type)
    counts: torch.Tensor        # (U,)  int64  stored member count
    point_bucket: torch.Tensor  # (n,)  int64  bucket id of each dataset row
    self_stored: torch.Tensor   # (n,)  f32    1.0 iff the row is stored in
    #                                          its own bucket's slots
    truncated: Optional[torch.Tensor] = None  # (U,) bool bucket overflowed
    overflow: Optional[torch.Tensor] = None   # (ov_cap,) int32 streaming
    #                                  region (-1 = free); None = static dataset
    # port only: (n, d) bf16, the dataset rounded to bf16 -- the bf16
    # weighted pass gathers it (half the bytes of the f32 rows); made once
    # per dataset by ``HashedKDE(precision="bf16")``, None otherwise
    x_bf16: Optional[torch.Tensor] = None


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """(m, h) int grid codes -> (m,) int64 keys in [0, 2^32): the
    reference's uint32 wraparound multiply-add, one pass per hashed
    dimension.  Negative codes enter as their two's-complement uint32."""
    h = torch.zeros(codes.shape[0], dtype=torch.int64, device=codes.device)
    for j in range(codes.shape[1]):
        c = codes[:, j].to(torch.int64) & _MASK32
        # h * HASH_MULT mod 2^32 from the multiplier's 16-bit halves: both
        # partial products stay below 2^48
        hi = ((h * _MULT_HI) & 0xFFFF) << 16
        h = (hi + h * _MULT_LO + c) & _MASK32
    return h


def query_codes(y: torch.Tensor, dims: torch.Tensor, shift: torch.Tensor,
                cell_width: float) -> torch.Tensor:
    """(m, h) int32 grid codes of query rows under the random-shifted grid:
    an f32 add, an IEEE f32 divide, then floor -- bitwise equal to the host
    layout build.  The divisor is a tensor: a Python-scalar divisor may be
    turned into a multiply by its reciprocal on the card."""
    yh = y.index_select(1, dims) + shift[None, :]
    cw = torch.full_like(shift, float(cell_width))
    return torch.floor(yh / cw[None, :]).to(torch.int32)


def rowwise_kv(q, xr, kind: str, inv_bw: float, beta: float, pairwise=None,
               precision: str = "f32", table=None):
    """Per-row kernel values k(q_i, xr_i_j): q (w, d), xr (w, t, d) ->
    (w, t).  The L2 kinds assemble d2 = max(qq + xx - 2 cross, 0) from the
    three sums, as the reference and the CUDA kernel do.
    ``precision="bf16"`` rounds both operands to bf16, sums the same three
    terms in f32 and finishes through the bf16 exp table (``table``, as
    the reference takes it: ``bf16_exp_table()`` as a tensor on q's
    device; None reads the cached one)."""
    if precision != "f32":
        check_precision(precision, kind, pairwise)
        q, xr = round_bf16(q), round_bf16(xr)
    if kind in _L2_KINDS:
        cross = torch.sum(q[:, None, :] * xr, dim=-1)
        xx = torch.sum(xr * xr, dim=-1)
        qq = torch.sum(q * q, dim=-1)
        d2 = qq[:, None] + xx - 2.0 * cross
        if precision != "f32":
            return _finish_l2_bf16(d2, kind, inv_bw, beta, table)
        return _finish_l2(d2, kind, inv_bw, beta)
    if kind == "laplacian":
        acc = torch.sum(torch.abs(q[:, None, :] - xr), dim=-1)
        return torch.exp(-acc * inv_bw)
    return torch.stack([pairwise(a[None, :], b)[0] for a, b in zip(q, xr)])


# --------------------------------------------------------------------- #
# shared gathers: (columns to evaluate, HT weights) for queries / frontiers
# --------------------------------------------------------------------- #
def _far_collide(fidx, mem, mvalid):
    """(w, s) mask: far sample j of row i hits a stored NEAR member."""
    return torch.any((fidx[:, :, None] == mem[:, None, :])
                     & mvalid[:, None, :], dim=-1)


def _ov_cols(ov, w: int):
    """Per-row exact columns of an overflow region: (w, ov_cap) clipped
    row ids + (w, ov_cap) validity.  ``ov`` is the state's (ov_cap,)
    region, broadcast to every row, or (w, ov_cap) regions of each row's
    own tenant (the stacked gathers); ``(None, None)`` for None."""
    if ov is None:
        return None, None
    if ov.dim() == 1:
        ov = ov[None, :].expand(w, ov.shape[0])
    return torch.clamp(ov, min=0), ov >= 0


def _ov_hits(fidx, ov):
    """(w, s) mask: far sample hits a live row of the overflow region
    ``ov`` ((ov_cap,) or per row (w, ov_cap); None: no region)."""
    if ov is None:
        return torch.zeros(fidx.shape, dtype=torch.bool, device=fidx.device)
    if ov.dim() == 1:
        ov = ov[None, :]
    return torch.any((fidx[:, :, None] == ov[:, None, :])
                     & (ov >= 0)[:, None, :], dim=-1)


def _far_hits_overflow(fidx, state: HashState):
    """(w, s) mask: far sample hits a live overflow row (those are already
    counted exactly by the overflow sweep)."""
    return _ov_hits(fidx, state.overflow)


def num_exact_cols(state: HashState) -> int:
    """Static count of exact (NEAR member + overflow) evaluation columns
    in the gathers below -- FAR columns start here."""
    mb = int(state.members.shape[1])
    return mb + (int(state.overflow.shape[0])
                 if state.overflow is not None else 0)


def _exact_cols(ov, mem, cnt, w: int):
    """(members + overflow columns, their 0/1 validity); ``ov`` as
    ``_ov_cols`` takes it."""
    mb = mem.shape[1]
    mvalid = torch.arange(mb, device=mem.device)[None, :] < cnt[:, None]
    ovc, ovvalid = _ov_cols(ov, w)
    if ovc is not None:
        mem = torch.cat([mem, ovc], dim=1)
        mvalid = torch.cat([mvalid, ovvalid], dim=1)
    return mem, mvalid


def lookup_buckets(y, state: HashState, cell_width: float):
    """(bucket id, hit) of query rows: hash on the device, then one
    vectorized ``searchsorted`` (side="left", as ``jnp.searchsorted``)
    over the sorted keys."""
    qkey = pack_codes(query_codes(y, state.dims, state.shift, cell_width))
    b = torch.clamp(torch.searchsorted(state.keys, qkey), 0,
                    state.keys.shape[0] - 1)
    return b, state.keys[b] == qkey


def query_gather(y, state: HashState, fidx, cell_width: float,
                 num_far: int, n: int):
    """Bucket lookup + FAR columns for arbitrary queries: the (w,
    max_bucket + num_far) evaluation columns, their weights (1 for valid
    NEAR slots, ``n/num_far`` for non-colliding FAR samples), the realized
    NEAR counts (Definition 1.1 eval accounting) and the per-row
    bucket-truncation flag.  ``fidx`` (w, num_far) holds the FAR draws,
    uniform on [0, n); None when ``num_far == 0``."""
    b, hit = lookup_buckets(y, state, cell_width)
    return _query_cols(state.members[b], state.counts[b], hit,
                       state.truncated[b] if state.truncated is not None
                       else None, state.overflow, fidx, num_far, n)


def _query_cols(mem, counts, hit, truncated, ov, fidx, num_far: int,
                n: int):
    """``query_gather`` after the bucket lookup: each row's bucket members
    ``mem``, their stored ``counts``, the ``hit`` flags, the buckets'
    ``truncated`` flags (or None) and the overflow region ``ov``."""
    cnt = torch.where(hit, counts, 0)
    mb = mem.shape[1]
    trunc = (hit & truncated if truncated is not None
             else torch.zeros_like(hit))
    w = mem.shape[0]
    mem, mvalid = _exact_cols(ov, mem, cnt, w)
    if num_far == 0:                       # static: NEAR-only estimate
        return mem, mvalid.to(torch.float32), cnt, trunc
    collide = (_far_collide(fidx, mem[:, :mb], mvalid[:, :mb])
               | _ov_hits(fidx, ov))
    cols = torch.cat([mem, fidx.to(mem.dtype)], dim=1)
    wgt = torch.cat([mvalid.to(torch.float32),
                     (float(n) / num_far)
                     * (1.0 - collide.to(torch.float32))], dim=1)
    return cols, wgt, cnt, trunc


def frontier_gather(src, state: HashState, off, num_far: int,
                    block_size: int, num_blocks: int, n: int):
    """Bucket lookup + STRATIFIED FAR columns for a frontier of DATASET
    indices (the level-1 read): the bucket id is a dense ``point_bucket``
    gather, and ``off`` (w, B, num_far) holds ``num_far`` uniform in-block
    offsets per block.  The HT weight is ``block_size/num_far``;
    out-of-range tail slots and collisions with stored NEAR members or the
    row itself get weight 0.  Returns (cols, wgt, NEAR counts, truncation
    flags)."""
    b = state.point_bucket[src]
    bc = torch.clamp(b, min=0)
    return _frontier_cols(src, b, state.members[bc], state.counts[bc],
                          state.truncated[bc] if state.truncated is not None
                          else None, state.overflow, off, num_far,
                          block_size, num_blocks, n)


def _frontier_cols(src, b, mem, counts, truncated, ov, off, num_far: int,
                   block_size: int, num_blocks: int, n: int):
    """``frontier_gather`` after the bucket lookup: each row's bucket id
    ``b`` (-1: none), its members, stored counts and truncation flag (or
    None), and the overflow region ``ov``."""
    w = src.shape[0]
    nohit = b < 0
    cnt = torch.where(nohit, 0, counts)
    mb = mem.shape[1]
    trunc = (truncated & ~nohit if truncated is not None
             else torch.zeros_like(nohit))
    mem, mvalid = _exact_cols(ov, mem, cnt, w)
    base = torch.arange(num_blocks, dtype=off.dtype,
                        device=src.device) * block_size
    fidx = (base[None, :, None] + off).reshape(w, num_blocks * num_far)
    dead = (_far_collide(fidx, mem[:, :mb], mvalid[:, :mb])
            | _ov_hits(fidx, ov) | (fidx == src[:, None])
            | (fidx >= n))
    fidx = torch.clamp(fidx, max=n - 1)
    cols = torch.cat([mem, fidx.to(mem.dtype)], dim=1)
    wgt = torch.cat([mvalid.to(torch.float32),
                     (float(block_size) / num_far)
                     * (1.0 - dead.to(torch.float32))], dim=1)
    return cols, wgt, cnt, trunc


# --------------------------------------------------------------------- #
# oracles
# --------------------------------------------------------------------- #
def weighted_kv_ref(q, x, cols, wgt, kind: str, inv_bw: float,
                    beta: float, pairwise=None, precision: str = "f32"):
    """w_ij k(q_i, x[cols_ij]) as (m, t), columns clamped to [0, n) as a
    JAX gather clamps them."""
    xr = x[torch.clamp(cols, 0, x.shape[0] - 1)]
    return rowwise_kv(q, xr, kind, inv_bw, beta, pairwise, precision) * wgt


def hashed_query_ref(x, y, state: HashState, fidx, kind: str, inv_bw: float,
                     beta: float, cell_width: float, num_far: int, n: int,
                     pairwise=None, precision: str = "f32"):
    """NEAR-exact + HT-FAR row-sum estimates: (m,) estimates and the (m,)
    realized NEAR eval counts."""
    cols, wgt, cnt, _ = query_gather(y, state, fidx, cell_width, num_far, n)
    kv = weighted_kv_ref(y, x, cols, wgt, kind, inv_bw, beta, pairwise,
                         precision)
    return torch.sum(kv, dim=1), cnt


def hashed_block_sums_ref(x, src, state: HashState, off, kind: str,
                          inv_bw: float, beta: float, num_far: int,
                          block_size: int, num_blocks: int, n: int,
                          pairwise=None):
    """Hashed level-1 frontier read: (w, B) block-sum estimates from
    O(max_bucket + B num_far) kernel evals per row."""
    cols, wgt, _, _ = frontier_gather(src, state, off, num_far, block_size,
                                      num_blocks, n)
    kv = weighted_kv_ref(x[src], x, cols, wgt, kind, inv_bw, beta, pairwise)
    return scatter_block_sums(kv, cols, src, state, num_far, block_size,
                              num_blocks)


def scatter_block_sums(kv, cols, src, state: HashState, num_far: int,
                       block_size: int, num_blocks: int):
    """Finish of the hashed level-1 read: scatter the weighted NEAR values
    into their blocks, reshape-reduce the block-indexed FAR values,
    subtract the self kernel from the own block iff stored, floor every
    block at 1e-12."""
    return _scatter_sums(kv, cols, src, state.self_stored[src],
                         num_exact_cols(state), num_far, block_size,
                         num_blocks)


def _scatter_sums(kv, cols, src, self_st, nex: int, num_far: int,
                  block_size: int, num_blocks: int):
    """``scatter_block_sums`` with each row's self-stored weight
    ``self_st`` and the exact column count ``nex`` given."""
    w = src.shape[0]
    bs = kv[:, nex:].reshape(w, num_blocks, num_far).sum(-1)
    bs = bs.scatter_add(1, (cols[:, :nex] // block_size).long(), kv[:, :nex])
    own = src // block_size
    corr = torch.arange(num_blocks, device=src.device)[None, :] \
        == own[:, None]
    bs = torch.where(corr, bs - self_st[:, None], bs)
    return torch.clamp(bs, min=BLOCK_SUM_FLOOR)


# --------------------------------------------------------------------- #
# stacked tenants (the serving layer's batched groups, DESIGN.md §13)
#
# ``stack`` is a HashState whose every tensor has a leading tenant axis of
# T equal-shape layouts (``ops.stack_hash_states``); ``trow`` (rows,)
# int64 is each row's tenant.  The gathers below return the columns of the
# single-state gathers, tenant-relative, row for row: each row reads only
# its own tenant's layout.
# --------------------------------------------------------------------- #
def stacked_lookup(y, stack: HashState, trow, cell_width: float):
    """``lookup_buckets`` of each query row in its own tenant's layout:
    the row's grid codes under its tenant's dims and shift (the same f32
    add, divide and floor), then one ``searchsorted`` over the T sorted
    key tables laid end to end with the tenant index in bits 32+ (each
    table stays sorted and below the next).  Returns (tenant-relative
    bucket id, hit)."""
    t, u = stack.keys.shape
    shift = stack.shift[trow]
    yh = torch.gather(y, 1, stack.dims[trow]) + shift
    cw = torch.full_like(shift, float(cell_width))
    qkey = pack_codes(torch.floor(yh / cw).to(torch.int32)) + (trow << 32)
    tenant = torch.arange(t, device=y.device)
    keys = (stack.keys + (tenant << 32)[:, None]).reshape(-1)
    first = trow * u
    b = torch.minimum(torch.maximum(torch.searchsorted(keys, qkey), first),
                      first + u - 1)
    return b - first, keys[b] == qkey


def stacked_query_gather(y, stack: HashState, trow, fidx, cell_width: float,
                         num_far: int, n: int):
    """``query_gather`` of rows of stacked tenants: (cols, wgt, NEAR
    counts, truncation flags), cols tenant-relative."""
    b, hit = stacked_lookup(y, stack, trow, cell_width)
    return _query_cols(stack.members[trow, b], stack.counts[trow, b], hit,
                       stack.truncated[trow, b]
                       if stack.truncated is not None else None,
                       stack.overflow[trow]
                       if stack.overflow is not None else None,
                       fidx, num_far, n)


def stacked_frontier_gather(src, stack: HashState, trow, off, num_far: int,
                            block_size: int, num_blocks: int, n: int):
    """``frontier_gather`` of frontier rows of stacked tenants (``src``
    tenant-relative): (cols, wgt, NEAR counts, truncation flags)."""
    b = stack.point_bucket[trow, src]
    bc = torch.clamp(b, min=0)
    return _frontier_cols(src, b, stack.members[trow, bc],
                          stack.counts[trow, bc],
                          stack.truncated[trow, bc]
                          if stack.truncated is not None else None,
                          stack.overflow[trow]
                          if stack.overflow is not None else None,
                          off, num_far, block_size, num_blocks, n)


def stacked_scatter_block_sums(kv, cols, src, stack: HashState, trow,
                               num_far: int, block_size: int,
                               num_blocks: int):
    """``scatter_block_sums`` of frontier rows of stacked tenants."""
    nex = int(stack.members.shape[-1]) + (
        int(stack.overflow.shape[-1]) if stack.overflow is not None else 0)
    return _scatter_sums(kv, cols, src, stack.self_stored[trow, src], nex,
                         num_far, block_size, num_blocks)
