"""Weighted vertex (degree) sampling -- Algorithms 4.3, 4.5, 4.6.

Preprocessing: n KDE queries give the weighted degrees p_i.  Sampling from
{p_i} is then the dense inverse-CDF form of the Algorithm 4.5 tree descent
(Lemma 4.8).  ``PrefixCDF`` accumulates prefix sums in float64 on the host
and draws with ``np.random.default_rng(seed)`` exactly as the reference
does, so the same weights and seed give the same indices; the normalized
CDF is exported once as a float32 device tensor for the fused edge-batch
program (per-entry rounding of an exactly-accumulated CDF is unbiased).
``sample_from_positive_array`` and ``tree_descent_sample`` are the
reference's host forms of Algorithm 4.5.  Over a mutable dataset
(``DynamicDataset``, DESIGN.md §12) ``streaming_degrees`` queries the live
rows only and ``DegreeSampler(dataset=)`` patches its degrees at the next
read after a mutation.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.kde.base import KDEBase
from repro_torch.device import resolve_device


class PrefixCDF:
    """Inverse-CDF sampler over a positive weight array.

    Host path: float64 prefix sums + ``np.searchsorted``.  Device path:
    ``cdf_device`` / ``probs_device`` / ``weights_device`` are float32
    tensors on ``device``, rounded from the float64 accumulation (never
    re-accumulated in float32) and exported once.
    """

    def __init__(self, weights: np.ndarray, seed: int = 0, device=None):
        w = np.asarray(weights, np.float64)
        self.weights = w
        self._prefix = np.cumsum(w)           # float64 accumulation
        self.total = float(self._prefix[-1])
        self._rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self._cdf_dev: Optional[torch.Tensor] = None
        self._probs_dev: Optional[torch.Tensor] = None
        self._weights_dev: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return len(self.weights)

    def sample(self, size: int) -> np.ndarray:
        """Draw ``size`` iid indices i ~ w_i / sum w."""
        u = self._rng.uniform(0.0, self.total, size=size)
        return np.searchsorted(self._prefix, u, side="right").clip(
            0, len(self.weights) - 1)

    def prob(self, idx) -> np.ndarray:
        """Probability this sampler assigns to index idx (w_i / sum w)."""
        return self.weights[np.asarray(idx)] / self.total

    def _export(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a.astype(np.float32)).to(self.device)

    @property
    def cdf_device(self) -> torch.Tensor:
        """Normalized float32 prefix array for device inverse-CDF draws."""
        if self._cdf_dev is None:
            self._cdf_dev = self._export(self._prefix / self.total)
        return self._cdf_dev

    @property
    def probs_device(self) -> torch.Tensor:
        """Float32 probabilities w_i / sum w on the device, divided in
        float64 and rounded once."""
        if self._probs_dev is None:
            self._probs_dev = self._export(self.weights / self.total)
        return self._probs_dev

    @property
    def weights_device(self) -> torch.Tensor:
        """Raw float32 weight array on the device."""
        if self._weights_dev is None:
            self._weights_dev = self._export(self.weights)
        return self._weights_dev


def host_degree_loop(estimator: KDEBase, batch: int = 1024) -> np.ndarray:
    """Algorithm 4.3 as batched estimator queries of the dataset against
    itself, minus the kernel's per-point diagonal (1.0 for the Table-1
    kinds)."""
    from repro_torch.kernels.kde_sampler.ref import BUILTIN_KINDS
    n = estimator.n
    out = np.zeros(n, np.float64)
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        out[lo:hi] = estimator.query(estimator.x[lo:hi]).cpu().numpy()
    if estimator.kernel.name in BUILTIN_KINDS:
        return out - 1.0         # k(x, x) = 1 exactly for Table-1 kernels
    return out - estimator.kernel.pairs(
        estimator.x, estimator.x).cpu().numpy().astype(np.float64)


def streaming_degrees(estimator: KDEBase, dataset,
                      batch: int = 1024) -> np.ndarray:
    """Algorithm 4.3 over a mutable padded dataset (DESIGN.md §12): only
    LIVE rows are queried (a sentinel query against a sentinel data row
    evaluates ``inf - inf``), dead slots get weight exactly 0 -- the
    inverse CDF then never draws them -- and the 1e-12 positivity clamp
    applies to live entries only.  Estimators attached to the same dataset
    answer through their own streaming-aware ``degrees()``."""
    from repro_torch.kernels.kde_sampler.ref import BUILTIN_KINDS
    if getattr(estimator, "_dataset", None) is dataset \
            and hasattr(estimator, "degrees"):
        out = np.asarray(estimator.degrees(), np.float64)
    else:
        sync = getattr(estimator, "_sync", None)
        if sync is not None:
            sync()
        ls = np.asarray(dataset.live_slots())
        out = np.zeros(estimator.n, np.float64)
        x = estimator.x
        for lo in range(0, len(ls), batch):
            sel = torch.as_tensor(ls[lo:lo + batch].astype(np.int64)).to(
                x.device)
            out[ls[lo:lo + batch]] = estimator.query(x[sel]).cpu().numpy()
        if estimator.kernel.name in BUILTIN_KINDS:
            out[ls] -= 1.0
        else:
            lv = torch.as_tensor(ls.astype(np.int64)).to(x.device)
            out[ls] -= estimator.kernel.pairs(x[lv], x[lv]).cpu().numpy()
    live = np.zeros(len(out), bool)
    live[np.asarray(dataset.live_slots())] = True
    return np.where(live, np.maximum(out, 1e-12), 0.0)


def approximate_degrees(estimator: KDEBase, batch: int = 1024) -> np.ndarray:
    """Algorithm 4.3: p_i = KDE_X(x_i) - k(x_i, x_i), clamped positive.
    Estimators exposing a ``degrees()`` method (the hashed ``HashedKDE``)
    are dispatched to it instead of the host batch loop, at the
    estimator's own batch size (so its counter words match the
    reference's, whose dispatch passes no batch either)."""
    if hasattr(estimator, "degrees"):
        return np.maximum(np.asarray(estimator.degrees(), np.float64),
                          1e-12)
    return np.maximum(host_degree_loop(estimator, batch), 1e-12)


class DegreeSampler:
    """Algorithm 4.6: sample vertices proportional to (approximate) degree.
    The degree CDF lives on the estimator's device.

    With ``mesh=`` the estimator must be mesh-resident (a ``ShardedKDE``,
    or any estimator with a ``degrees()`` method) and the Algorithm 4.3
    preprocessing runs as its collective program (the ring for exact
    reads, batched collective queries for stratified ones) instead of a
    host batch loop.

    With ``dataset=`` (a ``DynamicDataset`` the estimator was built over)
    the degrees cover the padded capacity, dead slots at exactly 0, and
    every public entry brings them to the dataset's current epoch: a
    ``degree_delta`` patch of the coalesced mutations, or a rebuild when
    the journal cannot bridge the gap (``rebuilds`` counts those)."""

    def __init__(self, estimator: KDEBase, seed: int = 0, mesh=None,
                 dataset=None):
        if mesh is not None and not hasattr(estimator, "degrees"):
            raise ValueError("DegreeSampler(mesh=...) needs a mesh-resident"
                             " estimator (core.kde.distributed.ShardedKDE)")
        self._estimator = estimator
        self._seed = seed
        self._dataset = dataset
        self._ds_epoch = int(dataset.epoch) if dataset is not None else 0
        self.rebuilds = 0
        if dataset is not None:
            self.degrees = streaming_degrees(estimator, dataset)
        else:
            self.degrees = approximate_degrees(estimator)
        self._cdf = PrefixCDF(self.degrees, seed=seed,
                              device=estimator.device)
        self.total = self._cdf.total

    # ------------------------------------------------------------------ #
    # streaming contract (DESIGN.md §12)
    def _rebuild_estimator(self) -> None:
        """Journal-gap path: estimators attached to the same dataset
        rebuild themselves; dense estimators are reconstructed over the
        dataset's current padded tensor.  As in the reference, a
        stratified or exact-block estimator comes back as a
        ``StratifiedKDE`` with the same block size and samples a block (an
        exact-block one reads every row of a block: the exact sums by the
        stratified read, plain torch), an ``ExactKDE`` as an ``ExactKDE``.
        Sub-sampling estimators (``rs`` / ``grid_hbe``) have no
        live-mass-preserving rebuild and are rejected."""
        est = self._estimator
        ds = self._dataset
        if getattr(est, "_dataset", None) is ds and hasattr(est, "_sync"):
            est._sync()
            return
        from repro_torch.core.kde.base import (ExactBlockKDE, ExactKDE,
                                               StratifiedKDE)
        kw = dict(precision=est.precision, device=ds.device)
        if isinstance(est, (StratifiedKDE, ExactBlockKDE)):
            self._estimator = StratifiedKDE(
                ds.x_pad, est.kernel, block_size=est.block_size,
                samples_per_block=est.samples_per_block, seed=self._seed,
                **kw)
        elif isinstance(est, ExactKDE):
            self._estimator = ExactKDE(ds.x_pad, est.kernel, **kw)
        else:
            raise ValueError(
                f"{type(est).__name__} has no streaming rebuild; attach "
                "the dataset to the estimator (HashedKDE(dataset=...)) or "
                "use a dense estimator")

    def _sync(self) -> None:
        """Epoch check at every public entry: patch the degree vector by
        the coalesced mutation delta (``ops.degree_delta``, O(n m) evals
        for an m-row batch) and re-accumulate the float64 prefix CDF
        (O(n)); journal gaps recompute degrees from scratch.  Mutated
        slots get exact recomputes, so repeated patching does not drift
        beyond the estimator's own error on untouched rows.  The CDF's
        draws are reseeded by ``seed + epoch``."""
        ds = self._dataset
        if ds is None or self._ds_epoch == int(ds.epoch):
            return
        from repro_torch.core.dataset import coalesce_mutations
        est = self._estimator
        batches = ds.mutations_since(self._ds_epoch)
        if batches is None:
            self._rebuild_estimator()
            self.degrees = streaming_degrees(self._estimator, ds)
            self.rebuilds += 1
        else:
            slots, old_x, new_x, old_live, new_live = \
                coalesce_mutations(batches)
            if hasattr(est, "patch_rows"):     # mesh adapter: idempotent
                est.patch_rows(slots, new_x)
            elif getattr(est, "_dataset", None) is ds:
                est._sync()                    # self-syncing (HashedKDE)
            else:                              # dense: refresh the norms
                est.x = ds.x_pad
                est.x_sq = ds.x_sq_pad
            from repro_torch.kernels.kde_sampler import ops as _ops
            from repro_torch.kernels.kde_sampler.ref import static_pairwise
            k = est.kernel
            dev = ds.device

            def put(a, dtype=torch.float32):
                return torch.as_tensor(a).to(dev, dtype)

            d, cw = _ops.degree_delta(
                put(self.degrees), ds.x_pad, ds.x_sq_pad,
                put(slots, torch.int64), put(old_x), put(new_x),
                put(old_live, torch.bool), put(new_live, torch.bool),
                kind=k.name, inv_bw=1.0 / k.bandwidth,
                beta=getattr(k, "beta", 1.0), pairwise=static_pairwise(k))
            d = d.cpu().numpy().astype(np.float64)
            est.evals += 2 * len(slots) * len(d)
            if hasattr(est, "device_counters"):
                est.device_counters.note(cw)
            live = np.zeros(len(d), bool)
            live[np.asarray(ds.live_slots())] = True
            self.degrees = np.where(live, np.maximum(d, 1e-12), 0.0)
        # seed varies by epoch so rebuilds do not replay the draw stream
        self._cdf = PrefixCDF(self.degrees, seed=self._seed + int(ds.epoch),
                              device=ds.device)
        self.total = self._cdf.total
        self._ds_epoch = int(ds.epoch)

    def sample(self, size: int) -> np.ndarray:
        """Draw ``size`` vertices u ~ deg(u) / sum deg (Algorithm 4.6)."""
        self._sync()
        return self._cdf.sample(size)

    def prob(self, idx) -> np.ndarray:
        """Probability this sampler assigns to vertex idx."""
        self._sync()
        return self._cdf.prob(idx)

    @property
    def cdf_device(self) -> torch.Tensor:
        """Normalized float32 prefix array for the fused edge-batch op."""
        self._sync()
        return self._cdf.cdf_device

    @property
    def degrees_device(self) -> torch.Tensor:
        """Raw float32 degree array for the fused edge-batch op."""
        self._sync()
        return self._cdf.weights_device


def sample_from_positive_array(a: np.ndarray, size: int, rng) -> np.ndarray:
    """Algorithm 4.5 in its dense form (host numpy, the reference's)."""
    prefix = np.cumsum(np.asarray(a, np.float64))
    u = rng.uniform(0.0, prefix[-1], size=size)
    return np.searchsorted(prefix, u, side="right").clip(0, len(a) - 1)


def tree_descent_sample(a: np.ndarray, rng) -> int:
    """Literal Algorithm 4.5 (binary descent on segment sums) -- the
    reference implementation that certifies the dense form."""
    lo, hi = 0, len(a)
    prefix = np.concatenate([[0.0], np.cumsum(np.asarray(a, np.float64))])

    def seg(l, h):  # A_{l,h} query via prefix sums (O(1), as Thm 4.9 notes)
        return prefix[h] - prefix[l]

    while hi - lo > 1:
        mid = lo + (hi - lo) // 2
        wl, wr = seg(lo, mid), seg(mid, hi)
        if rng.uniform() <= wl / max(wl + wr, 1e-30):
            hi = mid
        else:
            lo = mid
    return lo
