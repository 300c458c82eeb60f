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

A mutating dataset (DESIGN.md §12) builds over its live rows with an
overflow region (``build_hash_state(live=, overflow_cap=)``), and
``HashPatcher`` keeps that layout current in O(m) host work a mutation
batch plus one device scatter; both reads sweep the overflow region as
exact columns, so the weighted kernels run at t = max_bucket +
overflow_cap (+ the FAR columns).

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

from repro_torch.device import resolve_device
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
    data, seed and width give the same layout bit for bit.

    Streaming extensions (DESIGN.md §12): ``live`` masks the padded rows
    actually hashed -- dead (sentinel) slots get ``point_bucket = -1`` and
    never enter a bucket; ``overflow_cap > 0`` attaches an (empty)
    overflow region of that static capacity, the landing zone
    :class:`HashPatcher` appends mutated rows into between compactions."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    xn = np.asarray(x, np.float32)
    n, d = xn.shape
    rng = np.random.default_rng(seed)
    w = float(cell_width if cell_width is not None
              else default_cell_width(kernel))
    dims, shift = draw_grid(rng, d, num_hash_dims, w)
    if live is None:
        rows = np.arange(n, dtype=np.int64)
    else:
        rows = np.where(np.asarray(live, bool))[0].astype(np.int64)
    keys = grid_keys(xn[rows], dims, shift, w)
    uniq, members, counts, stored_rows, truncated = bucket_table(
        keys, rows, max_bucket, rng)
    stored = np.zeros(n, np.float32)
    stored[stored_rows] = 1.0
    point_bucket = np.full(n, -1, np.int64)
    point_bucket[rows] = np.searchsorted(uniq, keys)

    def dev_i64(a):
        return torch.as_tensor(np.asarray(a, np.int64)).to(dev)

    state = _ref.HashState(
        dims=dev_i64(dims), shift=torch.as_tensor(shift).to(dev),
        keys=dev_i64(uniq), members=torch.as_tensor(members).to(dev),
        counts=dev_i64(counts), point_bucket=dev_i64(point_bucket),
        self_stored=torch.as_tensor(stored).to(dev),
        truncated=torch.as_tensor(truncated).to(dev),
        overflow=(torch.full((int(overflow_cap),), -1, dtype=torch.int32,
                             device=dev) if overflow_cap else None))
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
                   reduce_sum, precision="f32"):
    """One weighted kernel-value pass: the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor or for a custom kind (its
    ``pairwise``, on every device: ``kde_sampler.ops.custom_kind``)."""
    if q.is_cuda and pairwise is None:
        fn = _k.weighted_kv_sum_cuda if reduce_sum else _k.weighted_kv_cuda
        return fn(q, x, cols, wgt, kind, inv_bw, beta, precision)
    fn = _k.weighted_kv_sum_plain if reduce_sum else _k.weighted_kv_plain
    return fn(q, x, cols, wgt, kind, inv_bw, beta, pairwise, precision)


def _rows(x, state, precision):
    """The dataset the weighted pass gathers: the state's bf16-resident
    copy at ``precision="bf16"`` where the estimator made one, else x (or
    the stacked copies of a ``stack_hash_states`` layout and the arena).
    Raises ValueError when the copy cannot be x's: another shape or
    another device."""
    if precision == "bf16" and state.x_bf16 is not None:
        xb = state.x_bf16
        if xb.shape != x.shape or xb.device != x.device:
            raise ValueError(
                f"the state's bf16 copy of the dataset is {tuple(xb.shape)} "
                f"on {xb.device}, but x is {tuple(x.shape)} on {x.device}: "
                f"the state was built for another dataset")
        return xb
    return x


def _widths(state):
    """(max_bucket, overflow capacity) -- the static gather widths (of one
    layout or of a ``stack_hash_states`` stack)."""
    ov = int(state.overflow.shape[-1]) if state.overflow is not None else 0
    return int(state.members.shape[-1]), ov


def hashed_query(x, y, state, fidx, *, kind, inv_bw, beta, pairwise=None,
                 cell_width, num_far, n, precision="f32"):
    """(m,) row-sum estimates + (m,) realized NEAR eval counts + a counter
    word -- the Definition 1.1 read at O(max_bucket + num_far) evals per
    query.  The word's status flags bucket truncation, out-of-range member
    indices and (statically, see the module note) a heavy HT weight.  At
    ``precision="bf16"`` the weighted pass gathers ``state.x_bf16`` where
    the state has it (the same values as x rounded)."""
    cols, wgt, cnt, trunc = _ref.query_gather(y, state, fidx, cell_width,
                                              num_far, n)
    corrupt = torch.any((cols < 0) | (cols >= n))
    est = _weighted_pass(y, _rows(x, state, precision), cols, wgt,
                         kind=kind, inv_bw=inv_bw,
                         beta=beta, pairwise=pairwise, reduce_sum=True,
                         precision=precision)
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
                       pairwise=None, num_far, block_size, num_blocks, n,
                       precision="f32"):
    """Core of ``hashed_block_sums`` (also called from the fused sampler
    programs of ``kde_sampler.ops``).  Returns ``(block sums, status)``."""
    cols, wgt, _, trunc = _ref.frontier_gather(src, state, off, num_far,
                                               block_size, num_blocks, n)
    kv = _weighted_pass(x[src], _rows(x, state, precision), cols, wgt,
                        kind=kind, inv_bw=inv_bw,
                        beta=beta, pairwise=pairwise, reduce_sum=False,
                        precision=precision)
    bs = _ref.scatter_block_sums(kv, cols, src, state, num_far, block_size,
                                 num_blocks)
    st = _g.merge(_g.flag_if(torch.any((cols < 0) | (cols >= n)),
                             _g.STATE_CORRUPT),
                  _g.flag_if(torch.any(trunc), _g.BUCKET_OVERFLOW),
                  _g.sums_status(bs, BLOCK_SUM_FLOOR))
    return bs, st


def hashed_block_sums(x, src, state, off, *, kind, inv_bw, beta,
                      pairwise=None, num_far, block_size, num_blocks, n,
                      precision="f32"):
    """(w, B) level-1 estimates of a dataset frontier from O(max_bucket +
    B num_far) evals per row: exact NEAR scatter + ``num_far`` stratified
    FAR slots per block.  Returns ``(block sums, counter word)``.  The
    queries are x[src]; at ``precision="bf16"`` the rows are gathered from
    ``state.x_bf16`` where the state has it."""
    bs, st = _hashed_block_sums(x, src, state, off, kind=kind, inv_bw=inv_bw,
                                beta=beta, pairwise=pairwise,
                                num_far=num_far, block_size=block_size,
                                num_blocks=num_blocks, n=n,
                                precision=precision)
    w = src.shape[0]
    mb, ov = _widths(state)
    far = int(num_blocks) * int(num_far)
    cw = _c.word(status=st, evals=w * (mb + ov + far), l1_reads=w,
                 far_samples=w * far, overflow=w * ov)
    return bs, cw


# --------------------------------------------------------------------- #
# batched multi-tenant serving entry points (DESIGN.md §13)
# --------------------------------------------------------------------- #
def stack_hash_states(states):
    """Stack equal-shape ``HashState`` layouts along a new leading tenant
    axis for the batched multi-tenant paths.  All layouts must agree in
    every tensor's shape and dtype (bucket count, ``max_bucket``, padded
    row count, overflow capacity, hash dims), and a field absent from one
    (``overflow``, ``x_bf16``: None) must be absent from all -- the serving
    layer keys its batch groups by exactly this signature.  Raises
    ``ValueError`` on a mismatch rather than padding: phantom padded
    buckets would change the FAR complement every Horvitz-Thompson draw
    sees."""
    if not states:
        raise ValueError("stack_hash_states needs at least one state")
    s0 = states[0]
    for st in states[1:]:
        for a, b in zip(st, s0):
            if (a is None) != (b is None) or (
                    a is not None and (a.shape != b.shape
                                       or a.dtype != b.dtype)):
                raise ValueError(
                    "HashState layouts differ in shape/dtype -- serve "
                    "these tenants in separate batch groups")
    return _ref.HashState(*(None if f[0] is None else torch.stack(f)
                            for f in zip(*states)))


def _lane_any(mask, lanes: int) -> torch.Tensor:
    """(lanes,) bool: any element of each lane's rows of ``mask``."""
    return mask.reshape(lanes, -1).any(dim=1)


def _lane_flag(mask, lanes: int, flag: int) -> torch.Tensor:
    return _lane_any(mask, lanes).to(torch.int64) * flag


def batched_hashed_query(xa, tidx, y, state, fidx, *, kind, inv_bw, beta,
                         pairwise, cell_width, num_far, n,
                         precision="f32"):
    """R hashed Definition 1.1 query requests across stacked tenants in
    ONE weighted-kv-sum launch: ``xa`` (T, n, d) the stacked tenant rows
    (the arena), ``state`` a ``stack_hash_states`` layout, ``tidx`` (R,)
    each request's tenant, ``y`` (R, q, d) its query points and ``fidx``
    (R, q, num_far) its FAR draws (``draw_query_noise`` per request; None
    when ``num_far == 0``).  Each row's columns come from its own tenant's
    layout and are offset into the flattened arena.  Returns (estimates
    (R, q), NEAR eval counts (R, q), per-request counter words (R,
    obs.WIDTH)) -- each lane is ``hashed_query`` on its tenant with its
    noise."""
    r, q, d = y.shape
    dev = y.device
    tidx = torch.as_tensor(tidx, dtype=torch.int64).to(dev)
    trow = tidx.repeat_interleave(q)
    yr = y.reshape(r * q, d)
    fr = fidx.reshape(r * q, -1) if fidx is not None else None
    cols, wgt, cnt, trunc = _ref.stacked_query_gather(
        yr, state, trow, fr, cell_width, num_far, n)
    corrupt = (cols < 0) | (cols >= n)
    arena = _rows(xa, state, precision)
    acols = (cols.to(torch.int64) + (trow * n)[:, None]).to(torch.int32)
    est = _weighted_pass(yr, arena.reshape(-1, d), acols, wgt, kind=kind,
                         inv_bw=inv_bw, beta=beta, pairwise=pairwise,
                         reduce_sum=True, precision=precision).reshape(r, q)
    heavy = num_far > 0 and float(n) / num_far > _g.ht_bound()
    st = (_lane_flag(corrupt, r, _g.STATE_CORRUPT)
          | _lane_flag(trunc, r, _g.BUCKET_OVERFLOW)
          | (_g.HT_HEAVY if heavy else 0)
          | _lane_flag(~torch.isfinite(est), r, _g.NONFINITE_RESULT))
    mb, ov = _widths(state)
    cw = _c.lane_words(st, evals=q * (mb + ov + num_far), l1_reads=q,
                       far_samples=q * num_far, overflow=q * ov)
    return est, cnt.reshape(r, q), cw


def stacked_hashed_block_sums(xa, src, trow, state, off, *, kind, inv_bw,
                              beta, pairwise=None, num_far, block_size,
                              num_blocks, n, precision="f32"):
    """The hashed level-1 read of frontier rows of stacked tenants in one
    weighted-kv launch: ``src`` (rows,) tenant-relative, ``trow`` (rows,)
    each row's tenant, ``off`` (rows, B, num_far) its FAR offsets.
    Returns (block sums (rows, B), corrupt (rows,), truncated (rows,))
    for the callers' per-lane status words."""
    d = xa.shape[-1]
    cols, wgt, _, trunc = _ref.stacked_frontier_gather(
        src, state, trow, off, num_far, block_size, num_blocks, n)
    arena = _rows(xa, state, precision)
    rows = trow * n + src
    acols = (cols.to(torch.int64) + (trow * n)[:, None]).to(torch.int32)
    flat = arena.reshape(-1, d)
    kv = _weighted_pass(xa.reshape(-1, d)[rows], flat, acols, wgt,
                        kind=kind, inv_bw=inv_bw, beta=beta,
                        pairwise=pairwise, reduce_sum=False,
                        precision=precision)
    bs = _ref.stacked_scatter_block_sums(kv, cols, src, state, trow,
                                         num_far, block_size, num_blocks)
    return bs, ((cols < 0) | (cols >= n)).any(dim=1), trunc


# --------------------------------------------------------------------- #
# streaming patches (DESIGN.md §12)
# --------------------------------------------------------------------- #
def _apply_hash_patch(state, bidx, brows, bcnt, pidx, pb, ss, ovidx, ovval):
    """Scatter a host-computed hash patch into the state's tensors in
    place: rewrite the touched bucket rows wholesale (the host already
    deduplicated them) plus the touched per-point and overflow entries.
    O(touched) device work, no rehash, no sort."""
    dev = state.members.device

    def put(t, idx, val):
        t.index_copy_(0, torch.as_tensor(np.asarray(idx, np.int64)).to(dev),
                      torch.as_tensor(np.asarray(val)).to(dev, t.dtype))

    put(state.members, bidx, brows)
    put(state.counts, bidx, bcnt)
    put(state.point_bucket, pidx, pb)
    put(state.self_stored, pidx, ss)
    put(state.overflow, ovidx, ovval)


class HashPatcher:
    """Incremental ``HashState`` maintenance for a mutating dataset.

    Keeps host numpy mirrors of the (host-built anyway) bucket tables and
    patches them in O(m) per mutation batch, in the reference's order, so
    a patched state is bitwise the reference's; the device state is
    updated by one scatter over the touched entries.  The placement policy
    (DESIGN.md §12):

    * insert whose grid cell exists in the frozen ``keys`` and whose
      bucket has free slots -> splice into the bucket at its slot-sorted
      position (rows arrive tail-first from ``DynamicDataset``, so the
      patched member table stays bitwise equal to a fresh rebuild);
    * otherwise -> append to the **overflow region**, which every query /
      frontier read sweeps exactly (weight 1) until :attr:`needs_rebuild`
      tells the owner to compact (rebuild via ``build_hash_state``);
    * delete -> left-shift out of its bucket (or clear its overflow slot).

    Saturated overflow sets ``guards.OVERFLOW_SATURATED`` in :attr:`flags`
    and forces :attr:`needs_rebuild`; touching an RNG-subsampled
    (truncated) bucket stays *correct* but loses bitwise rebuild parity,
    which :attr:`exact_parity` records.
    """

    def __init__(self, state, cell_width: float):
        if state.overflow is None:
            raise ValueError("HashPatcher needs a state built with "
                             "overflow_cap > 0")

        def host(t, dtype):
            return np.array(t.cpu().numpy(), dtype, copy=True)

        self.cell_width = float(cell_width)
        self.dims = host(state.dims, np.int32)
        self.shift = host(state.shift, np.float32)
        self.keys = host(state.keys, np.uint32)      # frozen, sorted
        self.members = host(state.members, np.int32)
        self.counts = host(state.counts, np.int32)
        self.point_bucket = host(state.point_bucket, np.int32)
        self.self_stored = host(state.self_stored, np.float32)
        self.truncated = (host(state.truncated, bool)
                          if state.truncated is not None
                          else np.zeros(len(self.keys), bool))
        self.overflow = host(state.overflow, np.int32)
        self.max_bucket = int(self.members.shape[1])
        self.flags = 0
        self.needs_rebuild = False
        self.exact_parity = True

    @property
    def overflow_fill(self) -> int:
        """Occupied overflow slots (monitoring / compaction policy)."""
        return int((self.overflow >= 0).sum())

    def _remove(self, slot: int, touched_b: set, touched_ov: set) -> None:
        b = int(self.point_bucket[slot])
        if self.self_stored[slot] > 0.0:
            if b >= 0:                      # stored in its bucket's slots
                cnt = int(self.counts[b])
                row = self.members[b]
                pos = np.where(row[:cnt] == slot)[0]
                if pos.size:
                    p = int(pos[0])
                    row[p:cnt - 1] = row[p + 1:cnt]
                    row[cnt - 1] = 0
                    self.counts[b] = cnt - 1
                    touched_b.add(b)
                    if self.truncated[b]:
                        self.exact_parity = False
            pos = np.where(self.overflow == slot)[0]
            if pos.size:                    # stored in the overflow region
                self.overflow[pos[0]] = -1
                touched_ov.add(int(pos[0]))
        elif b >= 0 and self.truncated[b]:
            # an unstored member of a truncated bucket: nothing to remove,
            # but a rebuild would resample the smaller bucket
            self.exact_parity = False
        self.point_bucket[slot] = -1
        self.self_stored[slot] = 0.0

    def _insert(self, slot: int, row_x: np.ndarray, touched_b: set,
                touched_ov: set) -> None:
        key = grid_keys(row_x[None, :], self.dims, self.shift,
                        self.cell_width)[0]
        pos = int(np.searchsorted(self.keys, key))
        hit = pos < len(self.keys) and self.keys[pos] == key
        b = pos if hit else -1
        if hit and int(self.counts[b]) < self.max_bucket \
                and not self.truncated[b]:
            cnt = int(self.counts[b])
            row = self.members[b]
            at = int(np.searchsorted(row[:cnt], slot))
            row[at + 1:cnt + 1] = row[at:cnt]
            row[at] = slot
            self.counts[b] = cnt + 1
            self.point_bucket[slot] = b
            self.self_stored[slot] = 1.0
            touched_b.add(b)
            return
        free = np.where(self.overflow < 0)[0]
        if free.size == 0:
            self.flags |= _g.OVERFLOW_SATURATED
            self.needs_rebuild = True
            return
        self.overflow[free[0]] = slot
        touched_ov.add(int(free[0]))
        # NEAR reads of this row still see its cell's exact members (if
        # the cell has a frozen bucket); the row itself is swept via the
        # overflow region, so its self kernel IS stored exactly
        self.point_bucket[slot] = b
        self.self_stored[slot] = 1.0
        self.exact_parity = False

    def apply(self, state, slots, old_x, new_x, old_live, new_live):
        """Patch the mirrors for one coalesced mutation batch and scatter
        the touched entries into the device ``state`` (its tensors are
        updated in place and the state is returned); when the overflow
        region saturates, ``state`` is returned untouched with
        :attr:`needs_rebuild` set -- the caller must compact before serving
        another query."""
        slots = np.asarray(slots, np.int64)
        old_live = np.asarray(old_live, bool)
        new_live = np.asarray(new_live, bool)
        new_x = np.asarray(new_x, np.float32)
        touched_b: set = set()
        touched_ov: set = set()
        for i, s in enumerate(slots):
            s = int(s)
            if old_live[i]:
                self._remove(s, touched_b, touched_ov)
            if new_live[i]:
                self._insert(s, new_x[i], touched_b, touched_ov)
        if self.needs_rebuild:
            return state
        bidx = np.fromiter(sorted(touched_b), np.int64,
                           count=len(touched_b))
        ovidx = np.fromiter(sorted(touched_ov), np.int64,
                            count=len(touched_ov))
        _apply_hash_patch(state, bidx, self.members[bidx],
                          self.counts[bidx], slots, self.point_bucket[slots],
                          self.self_stored[slots], ovidx,
                          self.overflow[ovidx])
        return state
