"""The share of the profiled stretch in which no operation ran on the
device, in percent; torch.profiler."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
