"""Set-up: from process start to the first timed call (imports, kernels
built or loaded, vocabulary and tables, traffic pool, warm-up); host
clock."""


def read(ctx):
    return ctx.setup_s
