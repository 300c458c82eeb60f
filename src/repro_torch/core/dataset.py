"""Versioned mutable dataset state for the streaming kernel-graph engine.

Every structure the estimators freeze at build time -- the §2 level-1
block sums, the Section 4 per-frontier cache, the ``HashState`` -- is keyed
on the *dataset*, so a mutable dataset needs an identity the caches can be
validated against.  :class:`DynamicDataset` provides exactly that
(DESIGN.md §12):

* a **capacity-padded** point tensor ``x_pad`` of fixed shape
  ``(capacity, d)`` with precomputed norms ``x_sq_pad`` and the liveness
  mask ``live_dev`` on the dataset's device.  Insert / delete / update are
  in-place ``index_copy_`` scatters into them, so shapes never change
  until :meth:`compact` or a capacity growth;
* **delete = masked sentinel**: a deleted slot's coordinates move to the
  kernels' far-offset pad convention (``kde_rowsum.ops._PAD_OFFSET``), its
  squared norm overflows to ``inf`` and every builtin kernel evaluates to
  exactly ``0.0`` against it -- dead slots are transparent to block sums
  and degrees wherever they sit;
* **insert = append at the tail watermark**: freed holes are never reused
  before an explicit :meth:`compact`, so slot ids stay monotone in
  insertion order and patched hash buckets keep the slot-sorted member
  order a fresh rebuild would produce;
* a monotone **epoch** counter plus a bounded mutation **journal**:
  consumers cache ``(dataset_id, epoch)`` next to any derived state and
  either *patch* (replaying ``mutations_since(their_epoch)``) or *rebuild*
  (when the journal no longer covers the gap).

The scatters mutate the tensors consumers hold, so only the journal
carries old values: it keeps host copies of every batch's ``old_x`` and
``new_x``, which later scatters never change.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.kde_rowsum.ops import _PAD_OFFSET

_DATASET_IDS = itertools.count(1)


def coalesce_mutations(batches):
    """Telescope a journal slice into ONE effective mutation batch.

    Per touched slot the old side is its state at the *first* touch and
    the new side its state at the *last* -- intermediate hops cancel
    (Section 2's kernel sums are linear in the rows), so consumers patch
    against the post-mutation arrays exactly once.  Returns ``(slots,
    old_x, new_x, old_live, new_live)`` host arrays.
    """
    first, last = {}, {}
    for b in batches:
        for i, s in enumerate(np.asarray(b.slots)):
            s = int(s)
            if s not in first:
                first[s] = (b.old_x[i], b.old_live[i])
            last[s] = (b.new_x[i], b.new_live[i])
    slots = np.array(sorted(first), np.int32)
    if slots.size == 0:
        d = batches[0].old_x.shape[1] if batches else 0
        return (slots, np.zeros((0, d), np.float32),
                np.zeros((0, d), np.float32), np.zeros(0, bool),
                np.zeros(0, bool))
    old_x = np.stack([first[int(s)][0] for s in slots]).astype(np.float32)
    new_x = np.stack([last[int(s)][0] for s in slots]).astype(np.float32)
    old_live = np.array([first[int(s)][1] for s in slots], bool)
    new_live = np.array([last[int(s)][1] for s in slots], bool)
    return slots, old_x, new_x, old_live, new_live


@dataclasses.dataclass(frozen=True)
class MutationBatch:
    """One journaled mutation batch: everything a consumer needs to patch.

    ``old_x`` / ``new_x`` hold the touched rows' coordinates before / after
    (sentinel coordinates for the dead side of inserts / deletes) as host
    copies, and the ``old_live`` / ``new_live`` masks say which side is
    real -- together they reduce every mutation kind to "slot moved from
    old to new".
    """

    epoch: int
    kind: str                       # "insert" | "delete" | "update"
    slots: np.ndarray               # (m,) int32
    old_x: np.ndarray               # (m, d) float32
    new_x: np.ndarray               # (m, d) float32
    old_live: np.ndarray            # (m,) bool
    new_live: np.ndarray            # (m,) bool


def attach_device(dataset, device):
    """The device of a consumer attached to ``dataset``: the dataset's own
    (``device=None``); another device raises ValueError."""
    if device is not None and resolve_device(device) != dataset.device:
        raise ValueError(f"the dataset lives on {dataset.device}, not on "
                         f"{resolve_device(device)}")
    return dataset.device


class DynamicDataset:
    """Mutable point set with epoch versioning (DESIGN.md §12).

    The logical dataset consumers build engines over is the full padded
    tensor: ``n = capacity`` everywhere, with dead slots at sentinel
    coordinates contributing exactly zero kernel mass.  ``device=None``
    places it on the CUDA card; tests pass ``device="cpu"``.
    """

    def __init__(self, x, capacity: Optional[int] = None,
                 journal_limit: int = 64, device=None):
        """Build from an (n0, d) initial point set; ``capacity`` bounds the
        total slot count (default: n0 plus 25% insert headroom)."""
        x0 = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
        x0 = np.asarray(x0, np.float32)
        if x0.ndim != 2 or x0.shape[0] < 1:
            raise ValueError("DynamicDataset needs a non-empty (n, d) array")
        n0, d = x0.shape
        if capacity is None:
            capacity = n0 + max(n0 // 4, 64)
        capacity = int(capacity)
        if capacity < n0:
            raise ValueError(f"capacity {capacity} < initial rows {n0}")
        self.device = resolve_device(device)
        self.d = int(d)
        self.capacity = capacity
        self.dataset_id = next(_DATASET_IDS)
        self.epoch = 0
        self._watermark = n0
        # the kernels' far-offset pad convention: sentinel rows sit
        # _PAD_OFFSET away from a real row; their squared norms overflow to
        # inf and every builtin kernel value is exactly 0.0 in f32
        self._sentinel = x0[-1] + np.float32(_PAD_OFFSET)
        pad = np.broadcast_to(self._sentinel, (capacity - n0, d))
        self._set_rows(np.concatenate([x0, pad], axis=0))
        self.live_host = np.zeros((capacity,), bool)
        self.live_host[:n0] = True
        self.live_dev = torch.as_tensor(self.live_host).to(self.device)
        self._journal: collections.deque = collections.deque(
            maxlen=int(journal_limit))
        self._journal_floor = 0     # oldest epoch the journal can bridge

    def _set_rows(self, xp: np.ndarray) -> None:
        """Allocate ``x_pad`` / ``x_sq_pad`` anew from host rows (build and
        the structural moves; mutations scatter in place)."""
        self.x_pad = as_f32(xp, self.device)
        self.x_sq_pad = torch.sum(self.x_pad * self.x_pad, dim=-1)

    # ------------------------------------------------------------ views
    @property
    def n(self) -> int:
        """Logical (padded) length -- the static ``n`` consumers build with."""
        return self.capacity

    @property
    def num_live(self) -> int:
        """Number of live (non-sentinel) rows."""
        return int(self.live_host.sum())

    @property
    def version(self) -> Tuple[int, int]:
        """The cache key contract: ``(dataset_id, epoch)``."""
        return (self.dataset_id, self.epoch)

    def live_slots(self) -> np.ndarray:
        """Host int32 slot ids of the live rows, ascending."""
        return np.where(self.live_host)[0].astype(np.int32)

    def _index(self, slots) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slots, np.int64)).to(self.device)

    def live_x(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Compact device ``(x, x_sq)`` over live rows only (O(n) gather);
        for consumers that rebuild rather than patch."""
        idx = self._index(self.live_slots())
        return self.x_pad[idx], self.x_sq_pad[idx]

    def is_live(self, slots) -> bool:
        """True iff every slot in ``slots`` is currently live -- the
        consumer-side epoch-mismatch check (``guards.EPOCH_STALE``)."""
        return bool(self.live_host[np.asarray(slots, np.int64)].all())

    # -------------------------------------------------------- mutations
    def _apply_rows(self, slots: np.ndarray, rows: np.ndarray,
                    live_val: bool) -> None:
        """Device-resident mutation core: scatter ``rows``, their norms and
        the liveness value into the padded tensors, in place."""
        idx = self._index(slots)
        r = as_f32(rows, self.device)
        self.x_pad.index_copy_(0, idx, r)
        self.x_sq_pad.index_copy_(0, idx, torch.sum(r * r, dim=-1))
        self.live_dev.index_fill_(0, idx, live_val)

    def _rows_of(self, slots: np.ndarray) -> np.ndarray:
        """Host copy of the current coordinates of ``slots``."""
        return self.x_pad[self._index(slots)].cpu().numpy()

    def _record(self, kind: str, slots: np.ndarray, old_x: np.ndarray,
                new_x: np.ndarray, old_live: np.ndarray,
                new_live: np.ndarray) -> None:
        self.epoch += 1
        if len(self._journal) == self._journal.maxlen:
            self._journal_floor = self._journal[0].epoch
        self._journal.append(MutationBatch(
            epoch=self.epoch, kind=kind, slots=slots, old_x=old_x,
            new_x=new_x, old_live=old_live, new_live=new_live))

    def _reset_journal(self) -> None:
        """Structural change (compact / grow): patching is impossible, every
        consumer behind the new epoch must rebuild."""
        self._journal.clear()
        self._journal_floor = self.epoch

    def insert_rows(self, rows) -> np.ndarray:
        """Append new points at the tail watermark; returns their slots.

        Holes left by deletes are deliberately *not* reused (slot-order
        monotonicity is what keeps patched hash buckets bitwise equal to a
        rebuild); run :meth:`compact` to reclaim them.
        """
        rows = np.asarray(rows, np.float32).reshape(-1, self.d)
        m = rows.shape[0]
        if m == 0:
            return np.zeros((0,), np.int32)
        if self._watermark + m > self.capacity:
            self._grow(self._watermark + m)
        slots = np.arange(self._watermark, self._watermark + m,
                          dtype=np.int32)
        old_x = np.broadcast_to(self._sentinel, (m, self.d)).copy()
        self._watermark += m
        self.live_host[slots] = True
        self._apply_rows(slots, rows, True)
        self._record("insert", slots, old_x, rows.copy(),
                     np.zeros(m, bool), np.ones(m, bool))
        return slots

    def delete_rows(self, slots) -> None:
        """Mask slots out of the dataset (sentinel coordinates: every
        kernel value against them is exactly 0.0)."""
        slots = np.unique(np.asarray(slots, np.int32))
        if slots.size == 0:
            return
        if not self.live_host[slots].all():
            raise ValueError("delete_rows: some slots are not live")
        m = slots.shape[0]
        old_x = self._rows_of(slots)
        new_x = np.broadcast_to(self._sentinel, (m, self.d)).copy()
        self.live_host[slots] = False
        self._apply_rows(slots, new_x, False)
        self._record("delete", slots, old_x, new_x,
                     np.ones(m, bool), np.zeros(m, bool))

    def update_rows(self, slots, rows) -> None:
        """Move live points to new coordinates in place."""
        slots = np.asarray(slots, np.int32)
        rows = np.asarray(rows, np.float32).reshape(-1, self.d)
        if slots.shape[0] != rows.shape[0]:
            raise ValueError("update_rows: slots/rows length mismatch")
        if slots.size == 0:
            return
        if np.unique(slots).size != slots.size:
            raise ValueError("update_rows: duplicate slots in one batch")
        if not self.live_host[slots].all():
            raise ValueError("update_rows: some slots are not live")
        m = slots.shape[0]
        old_x = self._rows_of(slots)
        self._apply_rows(slots, rows, True)
        self._record("update", slots, old_x, rows.copy(),
                     np.ones(m, bool), np.ones(m, bool))

    # ------------------------------------------------- structural moves
    def compact(self) -> None:
        """Pack live rows into the lowest slots and reset the watermark.

        Slot ids change, so this is a *structural* epoch bump: the journal
        resets and every consumer rebuilds from scratch.
        """
        x_live = self._rows_of(self.live_slots())
        n_live = x_live.shape[0]
        pad = np.broadcast_to(self._sentinel,
                              (self.capacity - n_live, self.d))
        self._set_rows(np.concatenate([x_live, pad], axis=0))
        self.live_host = np.zeros((self.capacity,), bool)
        self.live_host[:n_live] = True
        self.live_dev = torch.as_tensor(self.live_host).to(self.device)
        self._watermark = n_live
        self.epoch += 1
        self._reset_journal()

    def _grow(self, min_capacity: int) -> None:
        """Reallocate at >= ``min_capacity`` (doubling): shapes change, so
        like :meth:`compact` this forces consumers to rebuild."""
        new_cap = max(2 * self.capacity, int(min_capacity))
        pad = np.broadcast_to(self._sentinel,
                              (new_cap - self.capacity, self.d))
        self._set_rows(np.concatenate([self.x_pad.cpu().numpy(), pad],
                                      axis=0))
        self.capacity = new_cap
        live = np.zeros((new_cap,), bool)
        live[:len(self.live_host)] = self.live_host
        self.live_host = live
        self.live_dev = torch.as_tensor(self.live_host).to(self.device)
        self.epoch += 1
        self._reset_journal()

    # ----------------------------------------------------- consumer API
    def mutations_since(self, epoch: int) -> Optional[List[MutationBatch]]:
        """Journal slice a consumer at ``epoch`` must replay to catch up,
        oldest first; ``None`` when the journal can no longer bridge the
        gap (journal overflow, compact, grow, or a foreign dataset) --
        the consumer must rebuild."""
        epoch = int(epoch)
        if epoch == self.epoch:
            return []
        if epoch > self.epoch or epoch < self._journal_floor:
            return None
        out = [b for b in self._journal if b.epoch > epoch]
        if not out or out[0].epoch != epoch + 1:
            return None
        return out
