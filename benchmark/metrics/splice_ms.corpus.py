"""The host splice and per-doc assembly (``ops/packed.py``
``splice_host_merges`` and the row cut): StageClock ``splice``, ms a
call."""

STAGES = ("splice",)


def read(ctx):
    if not ctx.stages:
        return None
    return 1e3 * sum(t.get(s, 0.0) for t in ctx.stages
                     for s in STAGES) / len(ctx.stages)
