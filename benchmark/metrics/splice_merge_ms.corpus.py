"""The host BPE of the long misses (``ops/packed.py``
``splice_host_merges``, the ``merge_fn`` call): the self time of the
program's ``tekken.splice.merge`` span, ms a clocked call."""

SPAN = "tekken.splice.merge"


def read(ctx):
    if not any(SPAN in t for t in ctx.stages):
        return None
    return 1e3 * sum(t.get(SPAN, 0.0) for t in ctx.stages) / len(ctx.stages)
