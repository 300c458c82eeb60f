"""`edge_copy_s.sparsify`: device seconds a traced call of the
`edges.to_host` span (the edge arrays' copy to the host)."""
from kdebench.spans import stage_seconds


def read(ctx):
    return stage_seconds(ctx, "sparsify", "edges.to_host")
