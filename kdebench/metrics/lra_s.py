"""`lra_s`: the window's time over its finished approximations, host
clock."""


def read(ctx):
    if not ctx["finished"]:
        return None
    return ctx["window_s"] / ctx["finished"]
