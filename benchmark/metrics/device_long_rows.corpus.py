"""The misses over 8 bytes merged on the device (``ops/packed.py``, the
long, P=32, bucket of ``csrc/merge_rows.cu``) an ``encode_batch`` call
over the whole run: the program's counters ``device_long_rows`` /
``encode_calls`` (``tekken_tpu_torch.utils.timing.COUNTERS``), read from
the program the run loaded: the yardstick imports nothing of the program.
A program without the counter reads None."""

import sys

COUNTER = "device_long_rows"


def read(ctx):
    timing = sys.modules.get("tekken_tpu_torch.utils.timing")
    totals = getattr(getattr(timing, "COUNTERS", None), "totals", {})
    if COUNTER not in totals or not totals.get("encode_calls"):
        return None
    return totals[COUNTER] / totals["encode_calls"]
