"""Device-resident hashed KDE estimator -- the Section 3.1 black-box slot.

``HashedKDE`` adapts the ``repro_torch.kernels.kde_hash`` engine to the
Definition 1.1 estimator interface: the KAP22/DEANN near/far decomposition
(exact NEAR term over the query's random-shifted grid bucket + a
Horvitz-Thompson FAR term over uniform complement samples) as one device
program per query batch, whose weighted pass is the weighted-kv-sum CUDA
kernel on the card -- O(max_bucket + num_far_samples) kernel evals per
query instead of the dense backends' O(n).  ``precision="bf16"`` runs that
pass in the bf16 policy (its bf16 kernel instance) on a bf16-resident copy
of the dataset, ``state.x_bf16``, made once here (half the gathered bytes;
the same values as the rounded f32 rows); the bucket layout, the FAR draws
and the HT weights are the same at either precision.

With ``dataset=`` (a ``DynamicDataset``) the estimator builds over the
padded capacity, hashes the live rows only, keeps an overflow region of
``overflow_cap`` columns (default ``max(64, n // 64)``) and patches its
layout at the next query after a mutation (``kde_hash.ops.HashPatcher``),
rebuilding when the journal cannot bridge the gap or the region fills.
The bf16 copy is re-rounded at the mutated rows on every patch.

With ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``, f32 only) the
bucket tables live sharded over the mesh's ``data_axes``
(``kde_hash.sharded.ShardedHashTable``): each rank sweeps its own shard's
NEAR and FAR columns in one weighted-kv-sum launch and a query batch is one
all-reduce; every rank calls each entry point (SPMD).  ``use_pallas`` /
``interpret`` must be None (the dataset's device chooses the kernel).
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from repro_torch.core.dataset import attach_device
from repro_torch.core.kde.base import KDEBase
from repro_torch.core.kernels_fn import Kernel
from repro_torch.device import as_f32, no_switch
from repro_torch.ft import guards as _g
from repro_torch.kernels.kde_hash.sharded import ShardedHashTable
from repro_torch.kernels.kde_sampler.ref import round_bf16
from repro_torch.kernels.kde_sampler.sharded import mesh_device


class HashedKDE(KDEBase):
    """Definition 1.1 estimator over the static padded-bucket layout.

    Per query: <= ``max_bucket`` exact NEAR evals + ``num_far_samples``
    HT-weighted FAR evals.  ``evals`` counts the *realized* NEAR reads plus
    the FAR budget -- the paper's Section 7 cost metric.  FAR draws come
    from a ``torch.Generator`` on the estimator's device seeded by ``seed``
    (the layout build draws from ``np.random.default_rng(seed)``, as the
    reference's).

    >>> est = HashedKDE(x, gaussian(1.0)); est.query(x[:32])
    """

    def __init__(self, x, kernel: Kernel, cell_width: float | None = None,
                 num_hash_dims: int = 8, num_far_samples: int = 64,
                 max_bucket: int = 256, seed: int = 0,
                 use_pallas: bool | None = None,
                 interpret: bool | None = None, mesh=None,
                 data_axes=("data",), dataset=None,
                 overflow_cap: int | None = None, precision: str = "f32",
                 device=None):
        no_switch("use_pallas", use_pallas)
        no_switch("interpret", interpret)
        if mesh is not None:
            if precision != "f32":
                raise ValueError("precision='bf16' is single-device for "
                                 "now: the sharded hash table is f32")
            device = mesh_device(mesh, device)
        if dataset is not None:
            device = attach_device(dataset, device)
            x = dataset.x_pad      # engines build over the padded capacity
        super().__init__(x, kernel, precision=precision, device=device)
        from repro_torch.kernels.kde_hash import ops as _ops
        self._ops = _ops
        self.num_far_samples = int(num_far_samples)
        self.max_bucket = int(max_bucket)
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        # guards (DESIGN.md §11): last_status is the most recent batch's
        # word, status the or-fold over the estimator's lifetime
        self.last_status = 0
        self.status = 0
        self.flag_counts: Counter = Counter()
        # streaming attach (DESIGN.md §12): derived state is keyed on the
        # dataset's (id, epoch); queries transparently patch-or-rebuild
        self._dataset = dataset
        self._ds_epoch = int(dataset.epoch) if dataset is not None else 0
        self._patcher = None
        self.rebuilds = 0
        if overflow_cap is None:
            overflow_cap = max(64, self.n // 64) if dataset is not None \
                else 0
        self._build_kw = dict(cell_width=cell_width,
                              num_hash_dims=int(num_hash_dims),
                              max_bucket=self.max_bucket, seed=int(seed),
                              overflow_cap=int(overflow_cap))
        self._mesh = mesh
        self._data_axes = tuple(data_axes)
        self.engine = None
        self._build()

    def _build(self) -> None:
        """(Re)build the bucket layout at the current dataset epoch; also
        the compaction path of the streaming contract."""
        from repro_torch.kernels.kde_sampler.ref import static_pairwise
        live = None
        if self._dataset is not None:
            live = self._dataset.live_host
            self.x = self._dataset.x_pad
            self.x_sq = self._dataset.x_sq_pad
            self.n = int(self.x.shape[0])
        if self._mesh is not None:
            self.engine = ShardedHashTable(
                self._mesh, self.x, self.kernel, live=live,
                num_far_samples=self.num_far_samples,
                data_axes=self._data_axes, device=self.device,
                **self._build_kw)
            self.state = None
            self.cell_width = self.engine.cell_width
            return
        self.state, self.cell_width = self._ops.build_hash_state(
            self.x, self.kernel, live=live, device=self.device,
            **self._build_kw)
        if self.precision == "bf16":
            self.state = self.state._replace(
                x_bf16=round_bf16(self.x).to(torch.bfloat16))
        self._patcher = (self._ops.HashPatcher(self.state, self.cell_width)
                         if self._dataset is not None else None)
        kernel = self.kernel
        self._cfg = dict(kind=kernel.name, inv_bw=1.0 / kernel.bandwidth,
                         beta=getattr(kernel, "beta", 1.0),
                         pairwise=static_pairwise(kernel),
                         cell_width=self.cell_width,
                         num_far=min(self.num_far_samples, self.n), n=self.n,
                         precision=self.precision)

    def compact(self) -> None:
        """Fold the overflow region back into a fresh bucket layout at the
        current epoch (the lazy compaction of DESIGN.md §12)."""
        self._build()
        self.rebuilds += 1
        if self._dataset is not None:
            self._ds_epoch = int(self._dataset.epoch)

    def _sync(self) -> None:
        """Epoch check at query entry: patch the bucket layout by the
        coalesced mutation delta, or rebuild when the journal cannot
        bridge the gap or the overflow region saturated.  Saturation sets
        ``guards.OVERFLOW_SATURATED`` (an ``EstimationError`` under
        ``REPRO_CHECKS=1``; otherwise an automatic compaction)."""
        ds = self._dataset
        if ds is None or self._ds_epoch == int(ds.epoch):
            return
        from repro_torch.core.dataset import coalesce_mutations
        batches = ds.mutations_since(self._ds_epoch)
        if batches is None:        # journal overflow / compact / grow
            self.compact()
            return
        self.x = ds.x_pad
        self.x_sq = ds.x_sq_pad
        slots, old_x, new_x, old_live, new_live = \
            coalesce_mutations(batches)
        if self.engine is not None:
            saturated = not self.engine.patch_rows(slots, old_x, new_x,
                                                   old_live, new_live)
        else:
            self.state = self._patcher.apply(self.state, slots, old_x,
                                             new_x, old_live, new_live)
            saturated = self._patcher.needs_rebuild
        if saturated:
            s = _g.OVERFLOW_SATURATED
            self.last_status = s
            self.status |= s
            _g.count_flags(self.flag_counts, s)
            _g.raise_on_status(s, context="HashedKDE.sync",
                               allow=_g.BUCKET_OVERFLOW | _g.HT_HEAVY)
            self.compact()
            return
        if self.state is not None and self.state.x_bf16 is not None:
            # the bf16 copy follows the mutated rows (sentinels included)
            idx = torch.as_tensor(slots.astype(np.int64)).to(self.device)
            self.state.x_bf16.index_copy_(
                0, idx, round_bf16(self.x[idx]).to(torch.bfloat16))
        self._ds_epoch = int(ds.epoch)

    def _note(self, word) -> int:
        """Fold one program's counter word into the guard state and
        ``device_counters``; fatal flags raise under ``REPRO_CHECKS=1``."""
        s = self.device_counters.note(word)
        self.last_status = s
        self.status |= s
        _g.count_flags(self.flag_counts, s)
        _g.raise_on_status(s, context="HashedKDE.query",
                           allow=_g.BUCKET_OVERFLOW | _g.HT_HEAVY)
        return s

    def query(self, y: torch.Tensor) -> torch.Tensor:
        """NEAR-exact + FAR-sampled row-sum estimates (Section 3.1): one
        device program per batch.  The batch's status lands in
        ``last_status`` (or-folded into ``status``)."""
        y = as_f32(y, self.device)
        self._sync()
        if self.engine is not None:
            eng = self.engine
            est, cnt, cw = eng.query(y, eng.draw_noise(y.shape[0],
                                                       self._gen))
            self.evals += int(cnt.sum()) \
                + y.shape[0] * eng.num_far * eng.num_shards
            self._note(cw)
            return est
        num_far = self._cfg["num_far"]
        fidx = self._ops.draw_query_noise(y.shape[0], num_far, self.n,
                                          self._gen, self.device)
        est, cnt, cw = self._ops.hashed_query(self.x, y, self.state, fidx,
                                              **self._cfg)
        self.evals += int(cnt.sum()) + y.shape[0] * num_far
        self._note(cw)
        return est

    def degrees(self, batch: int = 1024) -> np.ndarray:
        """Algorithm 4.3 over the hashed structure: n queries of the
        dataset against itself minus the self kernel --
        O(n (max_bucket + num_far_samples)) kernel evals in all.  With a
        streaming dataset attached only the LIVE rows are queried (a
        sentinel query against a sentinel FAR sample would evaluate
        ``inf - inf``); dead slots report degree exactly 0."""
        from repro_torch.core.sampling.vertex import host_degree_loop
        if self._dataset is None:
            return host_degree_loop(self, batch)
        self._sync()
        ls = self._dataset.live_slots()
        out = np.zeros(self.n, np.float64)
        for lo in range(0, len(ls), batch):
            sel = ls[lo:lo + batch]
            idx = torch.as_tensor(sel.astype(np.int64)).to(self.device)
            out[sel] = self.query(self.x[idx]).cpu().numpy()
        out[ls] -= 1.0           # k(x, x) = 1 for the Table-1 kernels
        return out
