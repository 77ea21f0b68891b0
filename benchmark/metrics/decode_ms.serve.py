"""A step's ``Tekkenizer.decode_batch`` of the finished completions,
whole: the total duration of the program's ``tekken.decode_batch`` span,
ms a clocked step.  A program without the span reads None."""

SPAN = "tekken.decode_batch"


def read(ctx):
    whole = [t.get("spans", {}) for t in ctx.stages]
    if not any(SPAN in w for w in whole):
        return None
    return 1e3 * sum(w.get(SPAN, 0.0) for w in whole) / len(whole)
