"""Practical hash-based KDE estimator (DEANN-style, [KAP22] cited in §3.1).

The KAP22/DEANN decomposition:

    KDE(y) =  sum_{x in NEAR(y)} k(x, y)        (exact, few points)
            + (n - |NEAR|) * E_{x ~ FAR}[k(x,y)] (uniform sampling)

with NEAR(y) found by a random-shifted grid hash (one hash per scale).
``GridHBE`` is the host oracle of this family: a per-query host loop whose
bucket layout and draws come from ``np.random.default_rng(seed)`` in the
reference's call order (hash dims, shift, per-query bucket subsample, FAR
draws, the degenerate resample), so the same seed gives the same buckets
and the same FAR samples.  Kernel values are ``kernel.pairwise`` on the
estimator's device -- no kernel launch, as in the reference.
``HashedKDE`` (``hashed.py``) is the device-resident form of the same
estimator.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kde.base import KDEBase
from repro_torch.core.kernels_fn import Kernel
from repro_torch.device import as_f32


class GridHBE(KDEBase):
    """KAP22/DEANN-style estimator (Section 3.1 black-box slot):
    exact NEAR term over a random-shifted grid bucket + RS FAR term;
    per query <= max_bucket + num_far_samples kernel evals."""

    def __init__(self, x, kernel: Kernel, cell_width: float | None = None,
                 num_hash_dims: int = 8, num_far_samples: int = 64,
                 max_bucket: int = 256, seed: int = 0, device=None):
        super().__init__(x, kernel, device=device)
        self._rng = np.random.default_rng(seed)
        w = cell_width if cell_width is not None else 2.0 * kernel.bandwidth
        self.cell_width = float(w)
        self.num_far_samples = int(num_far_samples)
        self.max_bucket = int(max_bucket)
        dims = self._rng.choice(self.d, size=min(num_hash_dims, self.d),
                                replace=False)
        self.hash_dims = np.asarray(dims)
        self.shift = self._rng.uniform(0.0, w, size=len(dims)).astype(
            np.float32)
        xn = self.x.cpu().numpy()
        codes = np.floor((xn[:, self.hash_dims] + self.shift) / w).astype(
            np.int64)
        # Pack the integer grid coordinates into one bucket key.
        self._keys = self._pack(codes)
        order = np.argsort(self._keys, kind="stable")
        self._sorted_keys = self._keys[order]
        self._sorted_idx = order

    @staticmethod
    def _pack(codes: np.ndarray) -> np.ndarray:
        h = np.zeros(codes.shape[0], np.uint64)
        for j in range(codes.shape[1]):
            h = h * np.uint64(0x9E3779B97F4A7C15) \
                + codes[:, j].astype(np.uint64)
        return h

    def _bucket(self, key: np.uint64) -> np.ndarray:
        lo = np.searchsorted(self._sorted_keys, key, side="left")
        hi = np.searchsorted(self._sorted_keys, key, side="right")
        idx = self._sorted_idx[lo:hi]
        if len(idx) > self.max_bucket:
            idx = self._rng.choice(idx, size=self.max_bucket, replace=False)
        return idx

    def _kv(self, yi: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
        """(k,) kernel values of one query against dataset rows ``rows``."""
        sel = torch.as_tensor(np.asarray(rows, np.int64)).to(self.device)
        return self.kernel.pairwise(yi, self.x[sel])[0]

    def query(self, y: torch.Tensor) -> torch.Tensor:
        """NEAR-exact + FAR-sampled row-sum estimates (Section 3.1)."""
        y = as_f32(y, self.device)
        yn = y.cpu().numpy()
        m = yn.shape[0]
        codes = np.floor((yn[:, self.hash_dims] + self.shift)
                         / self.cell_width).astype(np.int64)
        keys = self._pack(codes)
        out = np.zeros(m, np.float32)
        for i in range(m):
            near = self._bucket(keys[i])
            n_near = len(near)
            yi = y[i:i + 1]
            total = 0.0
            if n_near:
                self.evals += n_near
                total += float(torch.sum(self._kv(yi, near)))
            n_far = self.n - n_near
            if n_far > 0 and self.num_far_samples > 0:
                s = min(self.num_far_samples, self.n)
                samp = self._rng.integers(0, self.n, size=s)
                self.evals += s
                kv = self._kv(yi, samp).cpu().numpy()
                if n_near:
                    near_set = np.zeros(self.n, bool)
                    near_set[near] = True
                    hits = near_set[samp]
                    if hits.all():
                        # Degenerate case: every FAR sample landed in the
                        # NEAR bucket, so the masked ratio estimate would be
                        # 0/0 -> 0.  Resample from the explicit complement
                        # (an exact sweep when it is no larger than the
                        # budget).
                        comp = np.flatnonzero(~near_set)
                        if len(comp) <= s:
                            samp2 = comp
                        else:
                            samp2 = self._rng.choice(comp, size=s,
                                                     replace=False)
                        self.evals += len(samp2)
                        kv2 = self._kv(yi, samp2).cpu().numpy()
                        total += n_far * float(kv2.mean())
                    else:
                        kv = kv * (~hits)
                        frac = 1.0 - hits.mean()
                        total += n_far * float(kv.sum()) / (s * frac)
                else:
                    total += self.n * float(kv.mean())
            out[i] = total
        return torch.as_tensor(out).to(self.device)
