"""UTF-8 input bytes (10^6) of every encode_batch call completed in the
window, over the window's seconds; host clock."""


def read(ctx):
    w = ctx.window
    if not w.durations.get("encode") or not w.seconds:
        return None
    return w.nbytes["encode"] / 1e6 / w.seconds
