"""The device stages, each closed by a synchronize: StageClock
``utf8_flags`` + ``branch`` + ``stage1`` + ``probe_emit`` + ``p23`` +
``merge``, ms a call."""

STAGES = ("utf8_flags", "branch", "stage1", "probe_emit", "p23", "merge")


def read(ctx):
    if not ctx.stages:
        return None
    return 1e3 * sum(t.get(s, 0.0) for t in ctx.stages
                     for s in STAGES) / len(ctx.stages)
