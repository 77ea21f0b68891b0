"""The public API's own work in ``Tekkenizer.encode_batch`` (specials
shift, BOS/EOS, the per-doc lists): StageClock ``public_ids``, ms a
call."""

STAGES = ("public_ids",)


def read(ctx):
    if not ctx.stages:
        return None
    return 1e3 * sum(t.get(s, 0.0) for t in ctx.stages
                     for s in STAGES) / len(ctx.stages)
