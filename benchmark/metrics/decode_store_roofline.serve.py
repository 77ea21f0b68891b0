"""``csrc/decode_store.cu``'s share of its bytes bound over the profiled
steps (one launch a step's ``decode_batch``): the benchmark's byte count
at 3.35 TB/s against the kernel's time in the device trace, in percent.

Bytes a token sent to the card, a rank (what the kernel needs, each
once): its id and its length (4 B each) read; its bytes read from the
table, 4 B a byte (``ops/decode.py``'s padded table holds a byte in an
int32 lane); its bytes written.  Not the zeros from the total to the
output's power-of-two size, nor the table rows' padding lanes.  The
specials never reach the card."""

from benchmark.core.peaks import roofline_pct

KERNEL = "decode_store_kernel"


def step_bytes(completions, token_bytes, num_special: int) -> int:
    total = 0
    for ids in completions:
        for t in ids:
            if t >= num_special:
                total += 8 + 5 * len(token_bytes[t - num_special])
    return total


def read(ctx):
    t = ctx.trace
    if t is None or ctx.reference is None:
        return None
    ref = ctx.reference
    nbytes = sum(ctx.cached(("decode_bytes", b), lambda b=b: step_bytes(
        ctx.pool[b]["completions"], ref.token_bytes, ref.num_special))
        for b in t.inputs)
    return roofline_pct(nbytes, t.kernel(KERNEL))
