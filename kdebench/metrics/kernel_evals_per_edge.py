"""`kernel_evals_per_edge`: the kernel evaluations the sparsifiers report
(``SparseGraph.kernel_evals``) over their edges."""


def read(ctx):
    w = ctx["work"]
    if not w.get("edges"):
        return None
    return w["kernel_evals"] / w["edges"]
