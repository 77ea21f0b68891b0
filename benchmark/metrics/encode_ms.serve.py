"""A step's ``Tekkenizer.encode_batch`` of the prompts, whole: the total
duration of the program's ``tekken.encode_batch`` span, ms a clocked
step."""

SPAN = "tekken.encode_batch"


def read(ctx):
    whole = [t.get("spans", {}) for t in ctx.stages]
    if not any(SPAN in w for w in whole):
        return None
    return 1e3 * sum(w.get(SPAN, 0.0) for w in whole) / len(whole)
