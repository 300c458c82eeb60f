"""Public entry points of the kde_rowsum kernels.

Dispatch goes by the tensor's device: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain version.  The CUDA kernels mask
ragged query rows and dataset columns themselves, so nothing is padded
per call.  ``_pad_rows`` keeps the reference's pad convention for the
plain oracles: rows at ``+_PAD_OFFSET`` in every coordinate drive the
squared distance to f32 ``inf`` and every kernel value to exactly 0.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.device import no_switch, tile_size
from repro_torch.kernels.kde_rowsum import kernel as _k
from repro_torch.kernels.kde_sampler.ref import (check_precision,
                                                 static_pairwise)

# ||pad||^2 = d * 1e60 overflows f32 -> d2 = inf -> k = 0 for every kind.
_PAD_OFFSET = 1.0e30


def _pad_rows(a: torch.Tensor, mult: int, offset: float) -> torch.Tensor:
    rem = (-a.shape[0]) % mult
    if rem == 0:
        return a
    pad = torch.full((rem, a.shape[1]), offset, dtype=a.dtype,
                     device=a.device) + a[-1:]
    return torch.cat([a, pad], dim=0)


def _check_placeholders(bm, bn, interpret, kernel: Kernel,
                        precision: str) -> None:
    tile_size("bm", bm)
    tile_size("bn", bn)
    no_switch("interpret", interpret)
    check_precision(precision, kernel.name, static_pairwise(kernel))


def kde_rowsum(q: torch.Tensor, x: torch.Tensor, kernel: Kernel,
               bm: int | None = None, bn: int | None = None,
               interpret: bool | None = None,
               precision: str = "f32") -> torch.Tensor:
    """KDE oracle: (m,) row sums of the kernel matrix block k(q, x).

    ``bm`` / ``bn`` are the reference's tile sizes: checked to be positive
    ints and otherwise ignored (the kernel's plan sizes its own tiles), so
    the output is the same function whatever their value.  ``interpret``
    must be None: a CPU tensor takes the plain version.  ``precision=
    "bf16"`` (L2 kinds) runs the bf16 kernel, or its plain version."""
    _check_placeholders(bm, bn, interpret, kernel, precision)
    args = (q.float().contiguous(), x.float().contiguous(), kernel.name,
            1.0 / kernel.bandwidth, getattr(kernel, "beta", 1.0), precision)
    return _k.rowsum_cuda(*args) if q.is_cuda else _k.rowsum_plain(*args)


def kde_blocksum(q: torch.Tensor, x: torch.Tensor, kernel: Kernel,
                 bm: int = 128, bn: int = 256, interpret: bool | None = None,
                 precision: str = "f32") -> torch.Tensor:
    """Level-1 read: (m, ceil(n/bn)) per-block kernel sums.  ``bn`` is the
    semantic level-1 block size (it fixes the output width); ``bm``, the
    reference's query tile, is checked and ignored (the output is the same
    function whatever its value); ``interpret`` must be None."""
    tile_size("bn", bn)
    _check_placeholders(bm, None, interpret, kernel, precision)
    args = (q.float().contiguous(), x.float().contiguous(), kernel.name,
            1.0 / kernel.bandwidth, getattr(kernel, "beta", 1.0), int(bn),
            precision)
    return _k.blocksum_cuda(*args) if q.is_cuda else _k.blocksum_plain(*args)
