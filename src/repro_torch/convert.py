"""Carry the reference's state across to the port.

The system has no weights: its state is the dataset, the kernel
parameters, the preprocessed degrees (or row norms) and the hashed
estimator's bucket layout.  These helpers
build the port's objects from the same plain numbers the reference was
built from, so tests construct both sides from one set of numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kernels_fn import Kernel, make_kernel
from repro_torch.core.sampling.vertex import PrefixCDF
from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.kde_hash.ref import HashState


def kernel_from_reference(name: str, bandwidth: float,
                          beta: float = 1.0) -> Kernel:
    """The port's Table-1 kernel with the reference kernel's ``name``,
    ``bandwidth`` and ``beta``."""
    if name == "rational_quadratic":
        return make_kernel(name, bandwidth=bandwidth, beta=beta)
    return make_kernel(name, bandwidth=bandwidth)


def dataset_from_numpy(x, device=None) -> torch.Tensor:
    """A (n, d) numpy dataset as a contiguous float32 tensor on
    ``device`` (the card by default)."""
    return as_f32(np.asarray(x), resolve_device(device))


def degrees_from_numpy(weights, seed: int = 0, device=None) -> PrefixCDF:
    """A numpy degree (or squared-row-norm) array as the port's float64
    ``PrefixCDF``, drawing from ``np.random.default_rng(seed)``."""
    return PrefixCDF(np.asarray(weights, np.float64), seed=seed,
                     device=device)


def hash_state_from_reference(state, device=None) -> HashState:
    """The reference's ``HashState`` (arrays read with ``np.asarray``) as
    the port's: ``members`` as int32, the other integer arrays as int64
    (uint32 keys keep their value), ``shift`` / ``self_stored`` as
    float32, on ``device``."""
    dev = resolve_device(device)

    def conv(name):
        a = getattr(state, name)
        if a is None:
            return None
        a = np.array(a)
        if a.dtype.kind in "iu":
            a = a.astype(np.int32 if name == "members" else np.int64)
        return torch.as_tensor(a).to(dev)

    return HashState(**{name: conv(name) for name in HashState._fields})
