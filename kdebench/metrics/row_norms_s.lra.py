"""`row_norms_s.lra`: device seconds a traced call of the `row_norms` span
(the squared-row-norm sweep to the host probabilities and their CDF)."""
from kdebench.spans import stage_seconds


def read(ctx):
    return stage_seconds(ctx, "lowrank", "row_norms")
