"""`kernel_evals_per_lra`: the kernel evaluations an approximation reports
(``LowRankResult.kernel_evals``), a call."""


def read(ctx):
    if not ctx["finished"]:
        return None
    return ctx["work"]["kernel_evals"] / ctx["finished"]
