"""`sketch_rows_s.lra`: device seconds a traced call of the `sketch_rows`
span (the sketch's kernel rows, rescaled)."""
from kdebench.spans import stage_seconds


def read(ctx):
    return stage_seconds(ctx, "lowrank", "sketch_rows")
