"""`edge_scan_s.sparsify`: device seconds a traced call of the
`edges.scan` span (the edge batches' noise and program, and the read of
their counter word)."""
from kdebench.spans import stage_seconds


def read(ctx):
    return stage_seconds(ctx, "sparsify", "edges.scan")
