"""Public API of the port: the paper's algorithms over black-box KDE
queries, as ``repro.core`` exports them, for every name the port has.

    from repro_torch.core import (gaussian, spectral_sparsify, fkv_lowrank,
                                  NeighborSampler, make_estimator, ...)
"""
from repro_torch.core.kernels_fn import (Kernel, exponential, gaussian,
                                         laplacian, make_kernel,
                                         median_bandwidth,
                                         rational_quadratic)
from repro_torch.core.kde.base import (ExactBlockKDE, ExactKDE, RSKDE,
                                       StratifiedKDE, make_estimator)
from repro_torch.core.sampling.vertex import (DegreeSampler, PrefixCDF,
                                              approximate_degrees)
from repro_torch.core.sampling.edge import EdgeSampler, NeighborSampler
from repro_torch.core.sampling.rownorm import RowNormSampler
from repro_torch.core.sparsify import (SparseGraph, resparsify,
                                       spectral_sparsify)
from repro_torch.core.lowrank import (countsketch_lowrank, fkv_lowrank,
                                      subspace_iteration)
