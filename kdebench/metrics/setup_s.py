"""`setup_s`: process start to the window's start, host clock (imports,
the kernel library's load or build, the points, one warm call)."""


def read(ctx):
    return ctx["setup_s"]
