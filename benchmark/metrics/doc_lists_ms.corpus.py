"""The token gather, the row cut and the per-doc lists of
``PackedEncoder._encode_buffer``: the self time of the program's
``tekken.doc_lists`` spans, ms a clocked call."""

SPAN = "tekken.doc_lists"


def read(ctx):
    if not any(SPAN in t for t in ctx.stages):
        return None
    return 1e3 * sum(t.get(SPAN, 0.0) for t in ctx.stages) / len(ctx.stages)
