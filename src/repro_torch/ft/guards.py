"""Device-side status flags (DESIGN.md §11), on torch tensors.

Same bit layout as ``repro.ft.guards``.  A status is a python int or a
0-d int64 tensor on the program's device; the helpers below are cheap
reductions over values a program already holds, so building a status
costs no kernel evaluations and no host synchronisation.  Flags are
advisory by default; with ``REPRO_CHECKS=1`` :func:`raise_on_status`
turns them into :class:`EstimationError`.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.obs.counters import WIDTH as _WIDTH

NONFINITE = 1 << 0
ZERO_MASS = 1 << 1
REJECT_EXHAUSTED = 1 << 2
BUCKET_OVERFLOW = 1 << 3
HT_HEAVY = 1 << 4
STATE_CORRUPT = 1 << 5
CG_NO_CONVERGE = 1 << 6
NONFINITE_RESULT = 1 << 7
OVERFLOW_SATURATED = 1 << 8
EPOCH_STALE = 1 << 9

STATUS_NAMES = {
    NONFINITE: "NONFINITE",
    ZERO_MASS: "ZERO_MASS",
    REJECT_EXHAUSTED: "REJECT_EXHAUSTED",
    BUCKET_OVERFLOW: "BUCKET_OVERFLOW",
    HT_HEAVY: "HT_HEAVY",
    STATE_CORRUPT: "STATE_CORRUPT",
    CG_NO_CONVERGE: "CG_NO_CONVERGE",
    NONFINITE_RESULT: "NONFINITE_RESULT",
    OVERFLOW_SATURATED: "OVERFLOW_SATURATED",
    EPOCH_STALE: "EPOCH_STALE",
}

#: flags that a re-keyed retry can plausibly clear (transient sampling luck)
RETRYABLE = REJECT_EXHAUSTED | HT_HEAVY
#: flags that mean the estimate itself is garbage and must escalate
FATAL = NONFINITE | ZERO_MASS | STATE_CORRUPT | NONFINITE_RESULT


def host_status(status) -> int:
    """Host-side status coercion: python ints pass through, 0-d tensors
    and arrays are read, counter words (trailing dim 8) read slot 0, and
    batches or-fold over the batch axis."""
    if isinstance(status, (int, np.integer)):
        return int(status)
    if isinstance(status, torch.Tensor):
        status = status.detach().cpu().numpy()
    arr = np.asarray(status)
    if arr.ndim == 0:
        return int(arr)
    if arr.shape[-1] == _WIDTH:
        arr = arr[..., 0]
    return int(np.bitwise_or.reduce(
        (arr.astype(np.int64) % (1 << 32)).reshape(-1)))


def decode_status(status) -> list:
    """Human-readable flag names set in a status (or a word's slot 0)."""
    s = host_status(status)
    return [name for bit, name in STATUS_NAMES.items() if s & bit]


def checks_enabled() -> bool:
    """True when ``REPRO_CHECKS=1`` -- flags become hard errors."""
    return os.environ.get("REPRO_CHECKS", "0") not in ("", "0")


def ht_bound() -> float:
    """Static HT inverse-probability weight bound (``REPRO_HT_BOUND``)."""
    return float(os.environ.get("REPRO_HT_BOUND", "4096"))


def ht_frac() -> float:
    """Fraction of |far estimate| one sample may contribute before the
    draw is flagged ``HT_HEAVY`` (``REPRO_HT_FRAC``)."""
    return float(os.environ.get("REPRO_HT_FRAC", "0.95"))


class EstimationError(RuntimeError):
    """A program raised a status flag under ``REPRO_CHECKS=1``."""


def raise_on_status(status, context: str = "", allow: int = 0) -> int:
    """Host-side check point: raise when checks are on and flags outside
    ``allow`` are set.  Returns the python-int status either way."""
    s = host_status(status)
    bad = s & ~allow
    if bad and checks_enabled():
        raise EstimationError(
            f"{context or 'fused program'}: status flags "
            f"{decode_status(bad)} (status=0x{s:x})")
    return s


def count_flags(counter: dict, status) -> dict:
    """Accumulate per-flag event counts into ``counter`` (name -> int)."""
    s = host_status(status)
    for bit, name in STATUS_NAMES.items():
        if s & bit:
            counter[name] = counter.get(name, 0) + 1
    return counter


# ------------------------------------------------------- tensor helpers
def flag_if(cond: torch.Tensor, flag: int) -> torch.Tensor:
    """int64 ``flag`` where the 0-d bool ``cond`` holds, else 0."""
    return cond.to(torch.int64) * flag


def merge(*statuses):
    """Bitwise-or of python-int and 0-d tensor statuses; a tensor if any
    input is one (it stays on its device)."""
    out = 0
    for s in statuses:
        out = s | out if isinstance(s, torch.Tensor) else out | s
    return out


def nonfinite_status(*arrays, flag: int = NONFINITE) -> torch.Tensor:
    """``flag`` if any element of any array is NaN/Inf."""
    bad = None
    for a in arrays:
        b = ~torch.isfinite(a).all()
        bad = b if bad is None else bad | b
    return flag_if(bad, flag)


def sums_status(bs: torch.Tensor, floor: float) -> torch.Tensor:
    """Status of a (m, B) level-1 block-sum read: NONFINITE for NaN/Inf,
    ZERO_MASS when some row's blocks all sat at the clamping floor."""
    nf = ~torch.isfinite(bs).all()
    zero = (bs <= 2.0 * floor).all(dim=-1).any()
    return flag_if(nf, NONFINITE) | flag_if(zero, ZERO_MASS)


def result_status(*arrays) -> torch.Tensor:
    """NONFINITE_RESULT if any program output element is NaN/Inf."""
    return nonfinite_status(*arrays, flag=NONFINITE_RESULT)
