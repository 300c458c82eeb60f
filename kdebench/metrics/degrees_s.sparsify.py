"""`degrees_s.sparsify`: device seconds a traced call of the `degrees`
span (the degree sweep, the host prefix CDF and its copy to the card)."""
from kdebench.spans import stage_seconds


def read(ctx):
    return stage_seconds(ctx, "sparsify", "degrees")
