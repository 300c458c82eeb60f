"""`edges_per_s`: the edges of the window's finished sparsifiers over the
window's time, host clock."""


def read(ctx):
    if "edges" not in ctx["work"]:
        return None
    return ctx["work"]["edges"] / ctx["window_s"]
