"""Device-resident hashed KDE estimator -- the Section 3.1 black-box slot.

``HashedKDE`` adapts the ``repro_torch.kernels.kde_hash`` engine to the
Definition 1.1 estimator interface: the KAP22/DEANN near/far decomposition
(exact NEAR term over the query's random-shifted grid bucket + a
Horvitz-Thompson FAR term over uniform complement samples) as one device
program per query batch, whose weighted pass is the weighted-kv-sum CUDA
kernel on the card -- O(max_bucket + num_far_samples) kernel evals per
query instead of the dense backends' O(n).

This slice covers static datasets on one device: ``mesh=`` and
``dataset=`` raise ``NotImplementedError``.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from repro_torch.core.kde.base import KDEBase
from repro_torch.core.kernels_fn import Kernel
from repro_torch.device import as_f32, not_in_slice
from repro_torch.ft import guards as _g


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
                 max_bucket: int = 256, seed: int = 0, mesh=None,
                 dataset=None, overflow_cap: int | None = None,
                 precision: str = "f32", device=None):
        if mesh is not None:
            raise not_in_slice("HashedKDE(mesh=)", "queue 1, item 9")
        if dataset is not None or overflow_cap:
            raise not_in_slice("HashedKDE(dataset=, overflow_cap=)",
                               "queue 1, item 7")
        super().__init__(x, kernel, precision=precision, device=device)
        from repro_torch.kernels.kde_hash import ops as _ops
        from repro_torch.kernels.kde_sampler.ref import static_pairwise
        self._ops = _ops
        self.num_far_samples = int(num_far_samples)
        self.max_bucket = int(max_bucket)
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        # guards (DESIGN.md §11): last_status is the most recent batch's
        # word, status the or-fold over the estimator's lifetime
        self.last_status = 0
        self.status = 0
        self.flag_counts: Counter = Counter()
        self.state, self.cell_width = _ops.build_hash_state(
            self.x, kernel, cell_width=cell_width,
            num_hash_dims=int(num_hash_dims), max_bucket=self.max_bucket,
            seed=int(seed), device=self.device)
        self._cfg = dict(kind=kernel.name, inv_bw=1.0 / kernel.bandwidth,
                         beta=getattr(kernel, "beta", 1.0),
                         pairwise=static_pairwise(kernel),
                         cell_width=self.cell_width,
                         num_far=min(self.num_far_samples, self.n), n=self.n)

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
        O(n (max_bucket + num_far_samples)) kernel evals in all."""
        from repro_torch.core.sampling.vertex import host_degree_loop
        return host_degree_loop(self, batch)
