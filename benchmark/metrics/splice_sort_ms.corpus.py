"""The splice's concatenate and stable argsort (``ops/packed.py``
``splice_host_merges``): the self time of the program's
``tekken.splice.sort`` span, ms a clocked call."""

SPAN = "tekken.splice.sort"


def read(ctx):
    if not any(SPAN in t for t in ctx.stages):
        return None
    return 1e3 * sum(t.get(SPAN, 0.0) for t in ctx.stages) / len(ctx.stages)
