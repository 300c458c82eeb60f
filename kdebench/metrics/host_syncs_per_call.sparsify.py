"""`host_syncs_per_call.sparsify`: host syncs a traced call, counted by the
program under its `sparsify` spans."""
from kdebench.spans import syncs_per_call


def read(ctx):
    return syncs_per_call(ctx, "sparsify")
