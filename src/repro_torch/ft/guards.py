"""Device-side status flags (DESIGN.md §11), on torch tensors.

Same bit layout as ``repro.ft.guards``.  A status is a python int or a
0-d int64 tensor on the program's device; the helpers below are cheap
reductions over values a program already holds, so building a status
costs no kernel evaluations and no host synchronisation.  Flags are
advisory by default; with ``REPRO_CHECKS=1`` :func:`raise_on_status`
turns them into :class:`EstimationError`.

:class:`RobustEstimator` is the degradation policy on top of the flags: a
Definition 1.1 estimator that retries flagged draws with a fresh draw and
escalates hash -> stratified -> exact per query row, recording the cost in
the ordinary ``.evals`` counters.
"""
from __future__ import annotations

import functools
import os
import warnings

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


def raise_per_request(statuses, contexts, allow: int = 0):
    """Per-request fan-out of :func:`raise_on_status` for the serving
    layer's batched status words (DESIGN.md §13): ONE host copy of the
    (R,) status vector, then the ordinary checks policy applied per
    request.  ``contexts`` is one string or a sequence aligned with the
    requests.  Returns ``(statuses, errors)`` -- python ints plus, aligned,
    the ``EstimationError`` built for each flagged request (None when the
    request is clean or checks are off).  Never raises itself: one
    poisoned request must not take down the other lanes of a serving
    tick.  Accepts an (R,) status vector or an (R, obs.WIDTH) stack of
    counter words (slot 0 is the per-request status)."""
    if isinstance(statuses, torch.Tensor):
        statuses = statuses.detach().cpu().numpy()
    arr = np.asarray(statuses).astype(np.int64) % (1 << 32)
    if arr.ndim == 2:                       # (R, WIDTH) counter words
        arr = arr[:, 0]
    on = checks_enabled()
    out, errors = [], []
    for i, s in enumerate(arr.reshape(-1).tolist()):
        s = int(s)
        ctx = contexts if isinstance(contexts, str) else contexts[i]
        bad = s & ~allow
        errors.append(EstimationError(
            f"{ctx or 'serving request'}: status flags "
            f"{decode_status(bad)} (status=0x{s:x})")
            if bad and on else None)
        out.append(s)
    return out, errors


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


def totals_status(tot, num_blocks: int, floor: float) -> torch.Tensor:
    """Status from row *totals* instead of the blocks: NONFINITE for
    NaN/Inf, ZERO_MASS when some row total sits at the floor of all its
    ``num_blocks`` blocks -- :func:`sums_status`'s contract without the
    (m, B) sums."""
    tot = torch.as_tensor(tot)
    nf = ~torch.isfinite(tot).all()
    zero = (tot <= 2.0 * floor * num_blocks).any()
    return flag_if(nf, NONFINITE) | flag_if(zero, ZERO_MASS)


def result_status(*arrays) -> torch.Tensor:
    """NONFINITE_RESULT if any program output element is NaN/Inf."""
    return nonfinite_status(*arrays, flag=NONFINITE_RESULT)


# -------------------------------------------------------- staged fallback
def checked(fn):
    """Wrap a program so that a NaN or Inf in any floating tensor it
    returns (nested in tuples, lists and dicts) raises
    ``FloatingPointError`` naming the output: the debug mode in which the
    float faults the status bits summarize become hard errors (the
    reference's ``checkify`` float checks; torch has no in-program check,
    so the outputs are checked on return, one host read a call)."""
    def walk(out, path):
        if isinstance(out, torch.Tensor):
            if out.is_floating_point() and not bool(torch.isfinite(
                    out).all()):
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', 'program')}: non-finite "
                    f"value in output {path or '0'}")
        elif isinstance(out, (tuple, list)):
            for i, o in enumerate(out):
                walk(o, f"{path}[{i}]")
        elif isinstance(out, dict):
            for k, o in out.items():
                walk(o, f"{path}[{k!r}]")

    @functools.wraps(fn)
    def run(*args, **kw):
        out = fn(*args, **kw)
        walk(out, "")
        return out
    return run


def _rekeys(stage) -> bool:
    """True for the stages the reference retries with a re-keyed draw (its
    ``hasattr(stage, "_split")``): the stratified and hashed estimators,
    whose torch generators advance on every call, and the exact-block one
    (a ``StratifiedKDE`` subclass there; its retry repeats its values)."""
    from repro_torch.core.kde.base import ExactBlockKDE
    return hasattr(stage, "_gen") or isinstance(stage, ExactBlockKDE)


class RobustEstimator:
    """Definition 1.1 estimator with staged degradation (DESIGN.md §11).

    Wraps the ordinary ``make_estimator`` backends in the escalation chain
    ``hash -> stratified -> exact``.  Per query batch it

    1. runs the cheapest stage and reads its ``last_status`` word,
    2. retries rows whose estimate is non-finite / non-positive (or whose
       batch raised a retryable flag) once with a fresh draw -- the
       randomized stages advance their generators on every call,
    3. escalates still-bad rows to the next stage; the final exact stage
       is always accepted.

    Every stage charges the shared ``.evals`` counter, so the cost of
    degradation stays auditable.  The chain is built lazily: a clean
    workload never pays for the exact oracle.  ``x`` may be a
    ``DynamicDataset`` (duck-typed: ``live_x`` / ``epoch``): the wrapper
    then answers over the live rows at the dataset's current epoch,
    dropping its built stages on a mutation.  The stages live on
    ``device`` (the dataset's own when one is attached).
    """

    def __init__(self, x, kernel, seed: int = 0,
                 stages=("hash", "stratified", "exact"), max_retries: int = 1,
                 stage_kw: dict | None = None, device=None, **kw):
        from repro_torch.device import as_f32, resolve_device
        self._dataset = x if hasattr(x, "live_x") and hasattr(x, "epoch") \
            else None
        if self._dataset is not None:
            from repro_torch.core.dataset import attach_device
            self.device = attach_device(self._dataset, device)
            self.x, self.x_sq = self._dataset.live_x()
            self._ds_epoch = int(self._dataset.epoch)
        else:
            self.device = resolve_device(device)
            self.x = as_f32(x, self.device)
            self.x_sq = torch.sum(self.x * self.x, dim=-1)
            self._ds_epoch = 0
        self.stage_rebuilds = 0
        self.kernel = kernel
        self.n = int(self.x.shape[0])
        self.d = int(self.x.shape[1])
        self.stage_names = tuple(stages)
        self.max_retries = int(max_retries)
        self._seed = int(seed)
        self._kw = dict(kw)
        self._stage_kw = dict(stage_kw or {})
        self._stages = {}
        self.status = 0
        self.flag_counts: dict = {}
        self.retries = 0
        self.escalations = {name: 0 for name in self.stage_names[1:]}

    def _sync(self) -> None:
        """Epoch check at stage entry: if the attached dataset mutated
        since the stages were built, refresh the row arrays and drop every
        built stage -- serving them would escalate against stale data."""
        ds = self._dataset
        if ds is None or self._ds_epoch == int(ds.epoch):
            return
        self.x, self.x_sq = ds.live_x()
        self.n = int(self.x.shape[0])
        self.stage_rebuilds += len(self._stages)
        self._stages.clear()
        self._ds_epoch = int(ds.epoch)

    def _stage(self, name: str):
        self._sync()
        if name not in self._stages:
            from repro_torch.core.kde.base import make_estimator
            kw = dict(self._kw)
            kw.update(self._stage_kw.get(name, {}))
            kw.setdefault("device", self.device)
            self._stages[name] = make_estimator(name, self.x, self.kernel,
                                                seed=self._seed, **kw)
        return self._stages[name]

    @property
    def evals(self) -> int:
        """Total kernel evaluations across every stage touched so far."""
        return sum(int(s.evals) for s in self._stages.values())

    @evals.setter
    def evals(self, value: int):
        # consumers reset counters by assignment; push the reset down
        for s in self._stages.values():
            s.evals = 0
        if int(value) != 0:
            raise ValueError("RobustEstimator.evals can only be reset to 0")

    @staticmethod
    def _bad_rows(vals) -> np.ndarray:
        v = np.asarray(vals, np.float64)
        return ~np.isfinite(v) | (v <= 0.0)

    @staticmethod
    def _host(vals: torch.Tensor) -> np.ndarray:
        return vals.detach().cpu().numpy().astype(np.float64)

    def query(self, y) -> torch.Tensor:
        """(m, d) -> (m,) row-sum estimates, degraded per row as needed.

        A non-final stage that *raises* ``EstimationError`` (its own
        ``REPRO_CHECKS`` policy firing) is treated like an all-bad batch
        and escalated -- the wrapper IS the recovery path, so only a
        failure of the final stage propagates."""
        from repro_torch.device import as_f32
        y = as_f32(y, self.device)
        m = int(y.shape[0])
        out = np.full((m,), np.nan, np.float64)
        pending = np.arange(m)
        for depth, name in enumerate(self.stage_names):
            if pending.size == 0:
                break
            stage = self._stage(name)
            if depth > 0:
                self.escalations[name] += int(pending.size)
            last = depth == len(self.stage_names) - 1
            sub = y[torch.as_tensor(pending).to(self.device)]
            try:
                vals = self._host(stage.query(sub))
            except EstimationError:
                if last:
                    raise
                status = host_status(getattr(stage, "status", 0))
                self.status |= status
                count_flags(self.flag_counts, status)
                continue                    # escalate every pending row
            status = host_status(getattr(stage, "last_status", 0))
            bad = self._bad_rows(vals)
            if (status & FATAL) and not last:
                # batch-level corruption: per-row values may LOOK sane, so
                # no row from this batch is trustworthy -- escalate them all
                bad = np.ones_like(bad)
            retryable = ((status & RETRYABLE) or bad.any()) \
                and not (status & FATAL)
            if retryable and not last and self.max_retries > 0 \
                    and _rekeys(stage):
                redo = np.where(bad)[0] if bad.any() else np.arange(len(vals))
                self.retries += int(redo.size)
                try:
                    rows = torch.as_tensor(pending[redo]).to(self.device)
                    vals[redo] = self._host(stage.query(y[rows]))
                    status |= host_status(getattr(stage, "last_status", 0))
                except EstimationError:
                    pass                    # retry failed too -> escalate
                bad = self._bad_rows(vals)
            self.status |= status
            count_flags(self.flag_counts, status)
            if last:
                bad = np.zeros_like(bad)
            good = ~bad
            out[pending[good]] = vals[good]
            pending = pending[bad]
        # the wrapper's own check point: flags a stage recovered from are
        # history, so only an unrecovered (non-finite) OUTPUT is fatal
        if checks_enabled() and not np.all(np.isfinite(out)):
            raise EstimationError(
                "RobustEstimator.query: non-finite output survived the "
                f"final '{self.stage_names[-1]}' stage "
                f"(accumulated flags {decode_status(self.status)})")
        return torch.as_tensor(out, dtype=torch.float32).to(self.device)

    def query1(self, y) -> float:
        """Single-point convenience wrapper around ``query``."""
        return float(self.query(y[None, :])[0])

    def degrees(self, batch: int = 1024) -> np.ndarray:
        """Algorithm 4.3 degree sweep through the staged chain."""
        from repro_torch.core.sampling.vertex import host_degree_loop
        return host_degree_loop(self, batch)


def warn_fallback_rate(fallbacks: int, draws: int, rounds: int,
                       slack: float, context: str = "sample_exact") -> None:
    """Warn when rejection-fallback frequency exceeds the Theorem 4.12
    prediction: accept prob >= 1/c per round -> all-reject rate
    <= (1 - 1/c)^rounds."""
    if draws <= 0 or fallbacks <= 0:
        return
    c = max(float(slack), 1.0 + 1e-9)
    predicted = (1.0 - 1.0 / c) ** int(rounds)
    rate = fallbacks / draws
    if rate > max(2.0 * predicted, 1e-3):
        warnings.warn(
            f"{context}: rejection fallback rate {rate:.3g} exceeds the "
            f"(1-1/c)^rounds prediction {predicted:.3g} "
            f"(c={c:.3g}, rounds={rounds}) -- level-1 estimates are "
            f"under-covering the true row mass", RuntimeWarning,
            stacklevel=3)
