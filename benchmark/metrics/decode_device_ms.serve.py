"""The device decode of a step's completions (``ops/decode.py``
``DeviceDecoder.decode_stream``: upload, the decode store kernel,
readback): the total duration of the program's ``tekken.decode.device``
span, ms a clocked step.  A program without the span reads None."""

SPAN = "tekken.decode.device"


def read(ctx):
    whole = [t.get("spans", {}) for t in ctx.stages]
    if not any(SPAN in w for w in whole):
        return None
    return 1e3 * sum(w.get(SPAN, 0.0) for w in whole) / len(whole)
