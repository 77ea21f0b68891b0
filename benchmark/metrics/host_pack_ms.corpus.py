"""Routing and packing, upload and readback (``ops/packed.py``):
StageClock ``route_pack`` + ``upload`` + ``readback``, ms a call."""

STAGES = ("route_pack", "upload", "readback")


def read(ctx):
    if not ctx.stages:
        return None
    return 1e3 * sum(t.get(s, 0.0) for t in ctx.stages
                     for s in STAGES) / len(ctx.stages)
