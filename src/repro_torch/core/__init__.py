"""Public API of the port: the paper's algorithms over black-box KDE
queries, as ``repro.core`` exports them.

    from repro_torch.core import (gaussian, spectral_sparsify, fkv_lowrank,
                                  top_eigenvalue, approximate_spectrum, ...)
"""
from repro_torch.core.kernels_fn import (Kernel, exponential, gaussian,
                                         laplacian, make_kernel,
                                         median_bandwidth,
                                         rational_quadratic)
from repro_torch.core.kde.base import (ExactBlockKDE, ExactKDE, RSKDE,
                                       StratifiedKDE, make_estimator)
from repro_torch.core.kde.multilevel import MultiLevelKDE
from repro_torch.core.sampling.vertex import (DegreeSampler, PrefixCDF,
                                              approximate_degrees)
from repro_torch.core.sampling.edge import EdgeSampler, NeighborSampler
from repro_torch.core.sampling.walks import random_walks
from repro_torch.core.sampling.rownorm import RowNormSampler
from repro_torch.core.sparsify import (SparseGraph, resparsify,
                                       spectral_sparsify)
from repro_torch.core.laplacian import cg_laplacian, solve_kernel_laplacian
from repro_torch.core.lowrank import (countsketch_lowrank, fkv_lowrank,
                                      subspace_iteration)
from repro_torch.core.spectrum import (approximate_spectrum, emd_1d,
                                       exact_spectrum)
from repro_torch.core.eigen import top_eigenvalue, top_eigenvalue_exact
from repro_torch.core.cluster.local import same_cluster_test
from repro_torch.core.cluster.spectral import (cluster_accuracy,
                                               laplacian_eigenvectors, kmeans,
                                               spectral_cluster)
from repro_torch.core.graph.arboricity import (estimate_arboricity,
                                               exact_arboricity)
from repro_torch.core.graph.triangles import (estimate_triangle_weight,
                                              exact_triangle_weight)

# Importing ``core.laplacian`` above bound the package attribute
# ``laplacian`` to that submodule; the public name is the kernel, as
# imported from ``kernels_fn`` (the reference's package keeps the
# submodule there).
from repro_torch.core.kernels_fn import laplacian  # noqa: E402,F811
