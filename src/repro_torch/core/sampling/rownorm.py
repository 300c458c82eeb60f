"""Row-norm^2 (length-squared) sampling of the kernel matrix -- Section 5.2.

For kernels with k(x,y)^2 = k(cx, cy) the squared row norms of K are the
row sums of the kernel matrix of the *scaled* dataset cX, so n KDE queries
against cX give the FKV sampling distribution: exact (the rowsum CUDA
kernel on the card) or by any estimator ``make_estimator`` builds -- ``rs``
(a uniform subsample a query, reduced by the same rowsum kernel, the
paper's sub-linear setting), ``stratified``, ``exact_block`` or ``hash``.
Prefix sums accumulate in float64 through the shared ``PrefixCDF``; the
sketch rows ``K_{idx,*} / sqrt(s p_i)`` are one device program
(``kde_sampler.ops.kernel_rows``).  With ``dataset=`` (a
``DynamicDataset``, DESIGN.md §12; dense estimators only) the squared row
norms cover the padded capacity, dead slots at 0, and are patched by
``ops.degree_delta`` on the scaled rows at the next read after a mutation.
With ``mesh=`` (exact, exact-block or stratified row norms) the row-norm
structure over cX is a ``ShardedKDE`` and the sketch rows are the sharded
engine's ``kernel_rows`` (the local column block, one all-gather); every
rank of the mesh calls each entry point (SPMD).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dataset import attach_device
from repro_torch.core.kde.base import KDEBase, make_estimator
from repro_torch.core.kde.distributed import ShardedKDE
from repro_torch.core.kernels_fn import Kernel, squared_kernel_dataset
from repro_torch.core.sampling.vertex import PrefixCDF
from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.kde_sampler.sharded import ShardedBlocks, mesh_device
from repro_torch.obs import metrics as _m


class RowNormSampler:
    """Section 5.2: sample row indices i ~ ||K_i,*||_2^2 / ||K||_F^2 via n
    KDE queries (by ``estimator``) against the scaled dataset cX.  Cost: n
    KDE queries of preprocessing + ``len(idx) * n`` evals per ``rows``
    call.

    >>> s = RowNormSampler(x, laplacian(1.0)); idx = s.sample(150)
    """

    def __init__(self, x, kernel: Kernel, estimator: str = "exact",
                 seed: int = 0, mesh=None, data_axes=("data",),
                 dataset=None, device=None, **est_kw):
        # streaming attach (DESIGN.md §12): dense estimators only -- the
        # row-norm structure lives over the SCALED padded tensor, which is
        # recomputed row-wise (cX) at every sync
        if dataset is not None:
            if mesh is not None:
                raise ValueError("RowNormSampler(dataset=) is single-"
                                 "device; drop mesh= or the dataset")
            if estimator not in ("exact", "exact_block", "stratified"):
                raise ValueError(
                    f"streaming row norms need a dense estimator "
                    f"(exact/exact_block/stratified), got {estimator!r}")
            device = attach_device(dataset, device)
            x = dataset.x_pad
        self._dataset = dataset
        self._ds_epoch = int(dataset.epoch) if dataset is not None else 0
        self._est_name = estimator
        self._est_kw = dict(est_kw)
        self._seed = seed
        self.rebuilds = 0
        self.device = (mesh_device(mesh, device) if mesh is not None
                       else resolve_device(device))
        self.x = as_f32(x, self.device)        # shared device dataset
        self.x_sq = torch.sum(self.x * self.x, dim=-1)
        self.kernel = kernel
        xs = squared_kernel_dataset(kernel, self.x)
        self._rows_engine = None
        if mesh is not None:
            # the row-norm KDE structure over cX and the sketch-row reads
            # over X both live sharded; queries and rows are collective
            # programs, the prefix CDF stays the float64 host accumulation
            if estimator not in ("exact", "exact_block", "stratified"):
                raise ValueError(
                    f"mesh= supports exact/exact_block/stratified row-norm "
                    f"estimators, got {estimator!r}")
            self._est: KDEBase = ShardedKDE(
                mesh, xs, kernel,
                exact=(estimator in ("exact", "exact_block")),
                data_axes=data_axes, seed=seed, device=self.device,
                **est_kw)
            self._rows_engine = ShardedBlocks(
                mesh, self.x, kernel, block_size=self._est.block_size,
                exact=True, data_axes=data_axes, device=self.device)
        else:
            self._est = make_estimator(estimator, xs, kernel, seed=seed,
                                       device=self.device, **est_kw)
        self.n = int(xs.shape[0])
        with _m.span("row_norms"):
            self.row_norms_sq = self._init_probs(xs)
            self._cdf = PrefixCDF(self.row_norms_sq, seed=seed,
                                  device=self.device)
        self.total = self._cdf.total          # ~= ||K||_F^2
        self._row_evals = 0
        from repro_torch.kernels.kde_sampler.ref import static_pairwise
        self._row_cfg = dict(kind=kernel.name, inv_bw=1.0 / kernel.bandwidth,
                             beta=getattr(kernel, "beta", 1.0),
                             pairwise=static_pairwise(kernel))

    def _init_probs(self, xs: torch.Tensor) -> np.ndarray:
        """n KDE queries against cX -> squared row norms, diagonal
        included (k(x,x)^2 = 1); no self-subtraction.  With a streaming
        dataset only LIVE rows are queried (scaled sentinels stay safe as
        data columns but not as queries); dead slots get weight 0."""
        probs = np.zeros(self.n, np.float64)
        batch = 1024
        if self._dataset is None:
            for lo in range(0, self.n, batch):
                hi = min(lo + batch, self.n)
                probs[lo:hi] = _m.to_host(self._est.query(xs[lo:hi])).numpy()
            return np.maximum(probs, 1e-12)
        ls = np.asarray(self._dataset.live_slots())
        for lo in range(0, len(ls), batch):
            sel = ls[lo:lo + batch]
            idx = torch.as_tensor(sel.astype(np.int64)).to(self.device)
            probs[sel] = self._est.query(xs[idx]).cpu().numpy()
        probs[ls] = np.maximum(probs[ls], 1e-12)
        return probs

    # ------------------------------------------------------------------ #
    # streaming contract (DESIGN.md §12)
    def _sync(self) -> None:
        """Epoch check at every public entry: rescale the coalesced
        mutation rows by the squaring constant, patch the squared row
        norms through the same ``degree_delta`` program as the degree
        path (plus the diagonal the row norms keep), and re-accumulate the
        prefix CDF; journal gaps rebuild the estimator over the freshly
        scaled padded tensor."""
        ds = self._dataset
        if ds is None or self._ds_epoch == int(ds.epoch):
            return
        from repro_torch.core.dataset import coalesce_mutations
        self.x = ds.x_pad
        self.x_sq = ds.x_sq_pad
        xs = squared_kernel_dataset(self.kernel, self.x)
        xs_sq = torch.sum(xs * xs, dim=-1)
        batches = ds.mutations_since(self._ds_epoch)
        if batches is None:
            self.n = int(xs.shape[0])
            self._est = make_estimator(self._est_name, xs, self.kernel,
                                       seed=self._seed, device=self.device,
                                       **self._est_kw)
            self.row_norms_sq = self._init_probs(xs)
            self.rebuilds += 1
        else:
            self._est.x = xs               # the scaled tensor is recomputed
            self._est.x_sq = xs_sq
            slots, old_x, new_x, old_live, new_live = \
                coalesce_mutations(batches)
            c = float(self.kernel.squaring_constant)
            from repro_torch.kernels.kde_sampler import ops as _ops

            def put(a, dtype=torch.float32):
                return torch.as_tensor(a).to(self.device, dtype)

            d, cw = _ops.degree_delta(
                put(self.row_norms_sq), xs, xs_sq, put(slots, torch.int64),
                put(old_x) * c, put(new_x) * c, put(old_live, torch.bool),
                put(new_live, torch.bool), **self._row_cfg)
            d = d.cpu().numpy().astype(np.float64)
            self._est.device_counters.note(cw)
            # degree_delta recomputes mutated rows as row sum MINUS the
            # self kernel; row norms keep the diagonal (k(x,x)^2 = 1)
            d[slots] += np.asarray(new_live, np.float64)
            self._est.evals += 2 * len(slots) * self.n
            live = np.zeros(self.n, bool)
            live[np.asarray(ds.live_slots())] = True
            self.row_norms_sq = np.where(live, np.maximum(d, 1e-12), 0.0)
        self._cdf = PrefixCDF(self.row_norms_sq,
                              seed=self._seed + int(ds.epoch),
                              device=self.device)
        self.total = self._cdf.total
        self._ds_epoch = int(ds.epoch)

    @property
    def evals(self) -> int:
        """Kernel evaluations spent on preprocessing + row reads."""
        return self._est.evals + self._row_evals

    def sample(self, size: int) -> np.ndarray:
        """Draw ``size`` iid row indices i ~ ||K_i,*||^2 (Section 5.2)."""
        with _m.span("row_draws"):
            self._sync()
            return self._cdf.sample(size)

    def prob(self, idx) -> np.ndarray:
        """Probability this sampler assigns to row idx."""
        self._sync()
        return self._cdf.prob(idx)

    def rows_device(self, idx: np.ndarray) -> torch.Tensor:
        """Exact kernel rows K_{idx,*} as one device program (f32 tensor
        on the sampler's device)."""
        from repro_torch.kernels.kde_sampler import ops as sampler_ops
        self._sync()
        sel = _m.to_device(np.asarray(idx, np.int64), self.device)
        self._row_evals += len(idx) * self.n
        if self._rows_engine is not None:
            out, cw = self._rows_engine.kernel_rows(self.x[sel])
        else:
            out, cw = sampler_ops.kernel_rows(self.x[sel], self.x, self.x_sq,
                                              **self._row_cfg)
        self._est.device_counters.note(cw)
        return out

    def rows(self, idx: np.ndarray) -> np.ndarray:
        """Exact kernel rows K_{idx,*} as a numpy array."""
        return self.rows_device(idx).cpu().numpy()

    def sketch_rows_device(self, idx: np.ndarray) -> torch.Tensor:
        """The FKV sketch S as a float64 device tensor: rows K_{idx,*}
        rescaled by 1/sqrt(s p_i) (the ``sketch_rows`` span)."""
        with _m.span("sketch_rows"):
            scale = 1.0 / np.sqrt(np.maximum(len(idx) * self.prob(idx),
                                             1e-30))
            scale = _m.to_device(scale, self.device, torch.float64)
            return self.rows_device(idx).double() * scale[:, None]

    def sketch_rows(self, idx: np.ndarray) -> np.ndarray:
        """The FKV sketch S: rows K_{idx,*} rescaled by 1/sqrt(s p_i)."""
        return self.sketch_rows_device(idx).cpu().numpy()
