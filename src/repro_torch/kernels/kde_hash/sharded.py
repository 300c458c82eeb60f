"""Mesh-resident hashed-KDE table on ``torch.distributed`` (DESIGN.md §10,
sharded schedule).

Each shard owns a contiguous run of dataset rows (the §9 layout of
``kde_sampler.sharded``: ``n`` rows padded to ``P * shard_size`` with
far-offset sentinel rows) and hashes ITS OWN rows into a local bucket
table under the one global (dims, shift) grid, so the union of the local
NEAR sets is exactly the flat engine's NEAR set.  One query batch is:

1. every shard hashes the replicated queries, looks the keys up in its
   LOCAL sorted table and evaluates its NEAR members exactly -- no
   collective;
2. every shard takes ``num_far`` uniform row offsets in its OWN
   ``shard_size`` slots (its slice of the replicated noise; sentinel rows
   have kernel value exactly 0) with the local HT weight
   ``shard_size / num_far``; NEAR + FAR is one weighted-kv-sum launch on
   the card over the shard's own rows -- no collective;
3. ONE all-reduce of the (estimate partial, NEAR-count partial) pair makes
   the Definition 1.1 estimates replicated.

Exactly one all-reduce and no exchange a query batch; no dataset row moves
between shards.  The host builds every shard's table (the same RNG order
as the reference: grid, then the shards' truncation subsamples in shard
order) and keeps numpy mirrors of all of them, so a streaming
``patch_rows`` runs the same host placement on every rank and each rank
scatters its own shard's writes: zero collectives.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import as_f32
from repro_torch.ft import guards as _g
from repro_torch.kernels.kde_hash import ops as _ops
from repro_torch.kernels.kde_hash import ref as _ref
from repro_torch.kernels.kde_rowsum.ops import _PAD_OFFSET
from repro_torch.kernels.kde_sampler import sharded as _sh
from repro_torch.kernels.kde_sampler.ref import static_pairwise
from repro_torch.obs import counters as _c

# Sorted-key padding: a real key's lookup never lands on a pad slot (pad
# counts are 0 anyway).
_PAD_KEY = 0xFFFFFFFF


class ShardedHashTable:
    """Per-shard bucket tables + the one-all-reduce collective query.

    ``shard_keys`` / ``shard_members`` / ``shard_counts`` /
    ``shard_truncated`` / ``shard_overflow`` are the host mirrors of every
    shard's padded table (``(P, U)``, ``(P, U, max_bucket)``, ...); the
    rank's own table lives on the mesh's device.  SPMD: every rank calls
    ``query`` and ``patch_rows`` with the same arguments."""

    def __init__(self, mesh, x, kernel, *, cell_width: float | None = None,
                 num_hash_dims: int = 8, max_bucket: int = 256,
                 num_far_samples: int = 64,
                 data_axes: Sequence[str] = ("data",), seed: int = 0,
                 live=None, overflow_cap: int = 0, device=None):
        self.grp = _sh.mesh_group(mesh, data_axes)
        self.device = _sh.mesh_device(mesh, device)
        P = self.grp.size
        if isinstance(x, torch.Tensor):
            xn = x.detach().cpu().numpy().astype(np.float32)
        else:
            xn = np.asarray(x, np.float32)
        n, d = xn.shape
        shard_size = -(-n // P)
        rng = np.random.default_rng(seed)
        w = float(cell_width if cell_width is not None
                  else _ops.default_cell_width(kernel))
        dims, shift = _ops.draw_grid(rng, d, num_hash_dims, w)
        mb = int(max_bucket)
        live_h = None if live is None else np.asarray(live, bool)
        per_shard = []
        for p in range(P):
            lo, hi = p * shard_size, min((p + 1) * shard_size, n)
            if live_h is None:
                rows = np.arange(lo, hi, dtype=np.int64)
            else:                 # streaming: hash the LIVE local rows only
                rows = lo + np.where(live_h[lo:hi])[0].astype(np.int64)
            uniq, members, counts, _, trunc = _ops.bucket_table(
                _ops.grid_keys(xn[rows], dims, shift, w), rows, mb, rng)
            per_shard.append((uniq, members, counts, trunc))
        ov_cap = int(overflow_cap)
        u_pad = max(max(len(s[0]) for s in per_shard), 1)
        self.shard_keys = np.full((P, u_pad), _PAD_KEY, np.uint32)
        self.shard_members = np.zeros((P, u_pad, mb), np.int32)
        self.shard_counts = np.zeros((P, u_pad), np.int32)
        self.shard_truncated = np.zeros((P, u_pad), bool)
        self.shard_overflow = np.full((P, max(ov_cap, 1)), -1, np.int32)
        for p, (uniq, members, counts, trunc) in enumerate(per_shard):
            k = len(uniq)
            self.shard_keys[p, :k] = uniq
            self.shard_members[p, :k] = members[:k]
            self.shard_counts[p, :k] = counts
            self.shard_truncated[p, :k] = trunc[:k]
        self.dims, self.shift = dims, shift
        self.cell_width = w
        self.n, self.d = n, d
        self.num_shards = P
        self.shard_size = shard_size
        self.max_bucket = mb
        self.num_far = int(num_far_samples)
        self.overflow_cap = ov_cap
        self.kind = kernel.name
        self.inv_bw = 1.0 / kernel.bandwidth
        self.beta = float(getattr(kernel, "beta", 1.0))
        self.pairwise = static_pairwise(kernel)
        self.flags = 0
        self.needs_rebuild = False
        self.exact_parity = True
        # table-level truncation bit, frozen at build time (a per-query
        # hit would need a second collective to replicate)
        self._truncated = bool(self.shard_truncated.any())
        n_pad = P * shard_size
        xp = torch.as_tensor(xn)
        if n_pad > n:
            sent = torch.full((n_pad - n, d), _PAD_OFFSET,
                              dtype=torch.float32) + xp[-1:]
            xp = torch.cat([xp, sent], dim=0)
        #: the padded dataset, replicated (the rank's rows are a view)
        self.x_pad = xp.to(self.device).contiguous()
        self._lo = self.grp.index * shard_size
        self.x_sh = self.x_pad[self._lo:self._lo + shard_size]
        self._dims = torch.as_tensor(dims.astype(np.int64)).to(self.device)
        self._shift = torch.as_tensor(shift).to(self.device)
        self._upload()

    def _upload(self) -> None:
        """The rank's own table, from the host mirrors, on its device."""
        p, dev = self.grp.index, self.device
        self._keys = torch.as_tensor(
            self.shard_keys[p].astype(np.int64)).to(dev)
        self._members = torch.as_tensor(self.shard_members[p]).to(dev)
        self._counts = torch.as_tensor(
            self.shard_counts[p].astype(np.int64)).to(dev)
        self._overflow = (torch.as_tensor(self.shard_overflow[p]).to(dev)
                          if self.overflow_cap else None)

    def draw_noise(self, m: int, generator):
        """The replicated FAR noise of one query batch: (P, m, num_far)
        int32 row offsets, uniform on [0, shard_size); each shard takes
        its own slice.  None when ``num_far == 0``."""
        if self.num_far == 0:
            return None
        return torch.randint(0, self.shard_size,
                             (self.num_shards, m, self.num_far),
                             generator=generator, dtype=torch.int32,
                             device=self.device)

    def query(self, y, noise=None):
        """(m,) replicated row-sum estimates + (m,) NEAR eval counts + a
        counter word: the local NEAR lookup and FAR partial (one
        weighted-kv-sum launch on the card), then exactly ONE all-reduce
        (PSUMS slot 1).  The status comes from replicated or static values
        only: build-time truncation, the static per-shard HT weight bound,
        a saturated overflow region, non-finite estimates."""
        y = as_f32(y, self.device)
        m = y.shape[0]
        qkey = _ref.pack_codes(_ref.query_codes(y, self._dims, self._shift,
                                                self.cell_width))
        b = torch.clamp(torch.searchsorted(self._keys, qkey), 0,
                        self._keys.shape[0] - 1)
        hit = self._keys[b] == qkey
        fidx = None
        if self.num_far:
            fidx = self._lo + noise[self.grp.index].to(torch.int64)
        cols, wgt, cnt, _ = _ref._query_cols(
            self._members[b], self._counts[b], hit, None, self._overflow,
            fidx, self.num_far, self.shard_size)
        # every referenced row is the shard's own: gather from the local
        # slice (member-pad slots point at global row 0 -- clamped here,
        # masked by their 0 weight)
        cols_l = torch.clamp(cols.to(torch.int64) - self._lo, 0,
                             self.shard_size - 1).to(torch.int32)
        part = _ops._weighted_pass(y, self.x_sh, cols_l, wgt, kind=self.kind,
                                   inv_bw=self.inv_bw, beta=self.beta,
                                   pairwise=self.pairwise, reduce_sum=True)
        pay = _sh.all_reduce(torch.stack([part.double(), cnt.double()]),
                             self.grp)
        est, cnt = pay[0].float(), pay[1].to(torch.int64)
        heavy = (self.num_far > 0
                 and float(self.shard_size) / self.num_far > _g.ht_bound())
        st = _g.merge(_g.BUCKET_OVERFLOW if self._truncated else 0,
                      _g.HT_HEAVY if heavy else 0,
                      self.flags & _g.OVERFLOW_SATURATED,
                      _g.result_status(est))
        P = self.num_shards
        per_row = P * (self.max_bucket + self.overflow_cap + self.num_far)
        cw = _c.word(status=st, evals=m * per_row, l1_reads=m,
                     far_samples=m * P * self.num_far,
                     overflow=m * P * self.overflow_cap, psums=1)
        return est, cnt, cw

    # ------------------------------------------------------------------ #
    # streaming patches (DESIGN.md §12)
    # ------------------------------------------------------------------ #
    def _lookup(self, p: int, row_x: np.ndarray):
        """(bucket pos, hit) of a coordinate row in shard ``p``'s frozen
        sorted key table."""
        key = _ops.grid_keys(row_x[None, :], self.dims, self.shift,
                             self.cell_width)[0]
        u = int(np.searchsorted(self.shard_keys[p], key))
        u = min(u, self.shard_keys.shape[1] - 1)
        return u, bool(self.shard_keys[p, u] == key)

    def _remove_host(self, p, slot, row_x, touched_b, touched_ov, undo_b,
                     undo_ov) -> None:
        u, hit = self._lookup(p, row_x)
        if hit:
            cnt = int(self.shard_counts[p, u])
            row = self.shard_members[p, u]
            pos = np.where(row[:cnt] == slot)[0]
            if pos.size:
                if (p, u) not in undo_b:
                    undo_b[(p, u)] = (row.copy(), cnt)
                at = int(pos[0])
                row[at:cnt - 1] = row[at + 1:cnt]
                row[cnt - 1] = 0
                self.shard_counts[p, u] = cnt - 1
                touched_b.add((p, u))
                if self.shard_truncated[p, u]:
                    self.exact_parity = False
                return
        pos = np.where(self.shard_overflow[p] == slot)[0]
        if pos.size:
            at = int(pos[0])
            if (p, at) not in undo_ov:
                undo_ov[(p, at)] = int(self.shard_overflow[p, at])
            self.shard_overflow[p, at] = -1
            touched_ov.add((p, at))
            return
        # an unstored member of a truncated bucket (or a never-hashed
        # row): nothing to remove, but a rebuild would resample
        self.exact_parity = False

    def _insert_host(self, p, slot, row_x, touched_b, touched_ov, undo_b,
                     undo_ov) -> bool:
        u, hit = self._lookup(p, row_x)
        if hit and int(self.shard_counts[p, u]) < self.max_bucket \
                and not self.shard_truncated[p, u]:
            cnt = int(self.shard_counts[p, u])
            row = self.shard_members[p, u]
            if (p, u) not in undo_b:
                undo_b[(p, u)] = (row.copy(), cnt)
            at = int(np.searchsorted(row[:cnt], slot))
            row[at + 1:cnt + 1] = row[at:cnt]
            row[at] = slot
            self.shard_counts[p, u] = cnt + 1
            touched_b.add((p, u))
            return True
        free = np.where(self.shard_overflow[p] < 0)[0]
        if free.size == 0:
            return False                        # shard overflow saturated
        at = int(free[0])
        if (p, at) not in undo_ov:
            undo_ov[(p, at)] = int(self.shard_overflow[p, at])
        self.shard_overflow[p, at] = slot
        touched_ov.add((p, at))
        self.exact_parity = False
        return True

    def patch_rows(self, slots, old_x, new_x, old_live, new_live) -> bool:
        """Apply one COALESCED mutation batch (``coalesce_mutations``:
        first-touch old, last-touch new a slot): the flat ``HashPatcher``
        placement a shard -- splice into the owning shard's frozen bucket
        when it has room, else that shard's overflow region -- on the
        host mirrors of every rank alike, then each rank scatters its own
        shard's touched bucket rows, overflow slots and the mutated dataset
        rows: zero collectives.  A slot's owner is ``slot // shard_size``,
        so query gathers stay shard-local.  Returns False (mirrors
        restored, device state untouched, ``needs_rebuild`` set,
        ``OVERFLOW_SATURATED`` flagged) when a shard's overflow region is
        full."""
        if self.overflow_cap == 0:
            raise ValueError("patch_rows needs a table built with "
                             "overflow_cap > 0")
        slots = np.asarray(slots, np.int64)
        old_x = np.asarray(old_x, np.float32)
        new_x = np.asarray(new_x, np.float32)
        old_live = np.asarray(old_live, bool)
        new_live = np.asarray(new_live, bool)
        touched_b: set = set()
        touched_ov: set = set()
        undo_b: dict = {}
        undo_ov: dict = {}
        for i, s in enumerate(slots):
            s = int(s)
            p = s // self.shard_size
            if old_live[i]:
                self._remove_host(p, s, old_x[i], touched_b, touched_ov,
                                  undo_b, undo_ov)
            if new_live[i] and not self._insert_host(
                    p, s, new_x[i], touched_b, touched_ov, undo_b,
                    undo_ov):
                for (q, u), (row, cnt) in undo_b.items():
                    self.shard_members[q, u] = row
                    self.shard_counts[q, u] = cnt
                for (q, at), val in undo_ov.items():
                    self.shard_overflow[q, at] = val
                self.flags |= _g.OVERFLOW_SATURATED
                self.needs_rebuild = True
                return False
        me, dev = self.grp.index, self.device

        def put(t, idx, val):
            if len(idx):
                t.index_copy_(0, torch.as_tensor(np.asarray(idx, np.int64))
                              .to(dev), torch.as_tensor(val).to(dev, t.dtype))

        bu = sorted(u for p, u in touched_b if p == me)
        put(self._members, bu, self.shard_members[me, bu])
        put(self._counts, bu, self.shard_counts[me, bu].astype(np.int64))
        ov = sorted(a for p, a in touched_ov if p == me)
        put(self._overflow, ov, self.shard_overflow[me, ov])
        put(self.x_pad, slots, new_x)
        return True

    @property
    def overflow_fill(self) -> int:
        """Occupied overflow slots across all shards (compaction policy)."""
        return int((self.shard_overflow >= 0).sum())
