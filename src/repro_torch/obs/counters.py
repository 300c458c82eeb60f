"""Device counter words (DESIGN.md §15.1), on torch tensors.

Every program returns a ``(WIDTH,)`` counter word next to its result.
Slot 0 is the ``ft.guards`` status bitmask; slots 1+ count realized device
work.  The reference holds the word as uint32; torch's uint32 arithmetic
is incomplete, so the port holds the slots as int64 and reduces the
counters mod 2^32 wherever the reference wraps.  For the same static
shapes every slot equals the reference's.

===========  ====  =====================================================
slot name     idx  meaning
===========  ====  =====================================================
STATUS          0  ``ft.guards`` status bitmask (or-folded)
EVALS           1  realized kernel evaluations executed by the program
L1_READS        2  level-1 block-structure reads (rows read x 1)
DRAWS           3  categorical / Gumbel draws realized
RETRIES         4  rejection-sampling fallback rows (REJECT_EXHAUSTED)
FAR_SAMPLES     5  Hashing-Based-Estimator FAR samples drawn
OVERFLOW        6  hash overflow-region columns swept
PSUMS           7  collective reductions executed by the program
===========  ====  =====================================================

Fold rule (loop carries, host accumulation): slot 0 ors, slots 1+ add.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

WIDTH = 8

STATUS = 0
EVALS = 1
L1_READS = 2
DRAWS = 3
RETRIES = 4
FAR_SAMPLES = 5
OVERFLOW = 6
PSUMS = 7

COUNTER_SLOTS: Dict[str, int] = {
    "status": STATUS, "evals": EVALS, "l1_reads": L1_READS, "draws": DRAWS,
    "retries": RETRIES, "far_samples": FAR_SAMPLES, "overflow": OVERFLOW,
    "psums": PSUMS,
}

_MOD = 1 << 32


def word(status=0, evals=0, l1_reads=0, draws=0, retries=0, far_samples=0,
         overflow=0, psums=0, device=None) -> torch.Tensor:
    """Build one ``(WIDTH,)`` int64 counter word.  Counters are python
    ints (static shape products, wrapped mod 2^32); ``status`` is a python
    int or a 0-d tensor, and a tensor status keeps the word on its device
    without a host synchronisation."""
    counts = [int(v) % _MOD for v in (evals, l1_reads, draws, retries,
                                      far_samples, overflow, psums)]
    if isinstance(status, torch.Tensor):
        dev = status.device
        head = status.reshape(1).to(torch.int64)
    else:
        dev = torch.device("cpu") if device is None else torch.device(device)
        head = torch.tensor([int(status) % _MOD], dtype=torch.int64,
                            device=dev)
    return torch.cat([head, torch.tensor(counts, dtype=torch.int64,
                                         device=dev)])


def lane_words(status: torch.Tensor, **counts) -> torch.Tensor:
    """(R, WIDTH) words of R lanes of one batched program: each lane's
    own status (an (R,) int tensor, on its device) and the same static
    counts (``word``'s keywords) in every lane."""
    w = word(device=status.device, **counts).repeat(status.shape[0], 1)
    w[:, STATUS] = status.to(torch.int64) % _MOD
    return w


def fold(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fold two counter words: status bits or, counters add mod 2^32."""
    b = b.to(a.device)
    return torch.cat([a[..., :1] | b[..., :1],
                      (a[..., 1:] + b[..., 1:]) % _MOD], dim=-1)


def fold_status(w: torch.Tensor, status) -> torch.Tensor:
    """Or extra status bits (a python int or a tensor broadcasting
    against the words' slot 0) into a word's slot 0, counters untouched."""
    out = w.clone()
    st = status.to(torch.int64).to(w.device) \
        if isinstance(status, torch.Tensor) else int(status) % _MOD
    out[..., STATUS] = w[..., STATUS] | st
    return out


def scale(w: torch.Tensor, k: int) -> torch.Tensor:
    """``k`` repetitions of the same program: status unchanged, counters
    multiplied mod 2^32."""
    return torch.cat([w[..., :1], (w[..., 1:] * (int(k) % _MOD)) % _MOD],
                     dim=-1)


def status_of(w):
    """The status bitmask of a scalar status OR a counter word: python
    ints pass through, 0-d tensors pass through, words read slot 0 and
    batched ``(R, WIDTH)`` words read column 0."""
    if isinstance(w, (int, np.integer)):
        return w
    if not isinstance(w, torch.Tensor):
        w = torch.as_tensor(np.asarray(w))
    if w.dim() == 0:
        return w
    return w[..., STATUS]


def is_word(w) -> bool:
    """True when ``w`` is a counter word (trailing dim == WIDTH)."""
    if isinstance(w, (int, np.integer)):
        return False
    shape = tuple(w.shape) if isinstance(w, torch.Tensor) \
        else np.shape(w)
    return len(shape) > 0 and int(shape[-1]) == WIDTH


def counter(w, slot) -> int:
    """Host-side read of one counter slot (name or index) of a word --
    batched words sum over the batch axis, the status slot or-folds."""
    idx = COUNTER_SLOTS[slot] if isinstance(slot, str) else int(slot)
    arr = _host(w)
    if idx == STATUS:
        return int(np.bitwise_or.reduce(arr[:, STATUS] % _MOD))
    return int(arr[:, idx].sum())


def _host(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    return np.asarray(w, np.int64).reshape(-1, WIDTH)


def totals(w) -> Dict[str, int]:
    """Host-side dict view of a word (or a batch of words, fold-reduced)."""
    arr = _host(w)
    out = {"status": int(np.bitwise_or.reduce(arr[:, STATUS]))}
    for name, idx in COUNTER_SLOTS.items():
        if idx != STATUS:
            out[name] = int(arr[:, idx].sum())
    return out


class HostTotals:
    """Host-side accumulator reconciling device words against the
    analytic ``.evals`` counters: python-int sums (no wrap across calls),
    one ``note(word)`` per program return."""

    def __init__(self):
        self.counts: Dict[str, int] = {
            k: 0 for k in COUNTER_SLOTS if k != "status"}
        self.status = 0
        self.words = 0

    def note(self, w) -> int:
        """Fold one word (or batch of words) in; returns its status bits."""
        t = totals(w)
        st = t.pop("status")
        self.status |= st
        self.words += 1
        for k, v in t.items():
            self.counts[k] += v
        return st

    def as_dict(self) -> Dict[str, int]:
        return dict(status=self.status, words=self.words, **self.counts)

    def __getitem__(self, k: str) -> int:
        return self.counts[k]
