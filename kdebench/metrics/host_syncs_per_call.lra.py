"""`host_syncs_per_call.lra`: host syncs a traced call, counted by the
program under its `lowrank` spans."""
from kdebench.spans import syncs_per_call


def read(ctx):
    return syncs_per_call(ctx, "lowrank")
