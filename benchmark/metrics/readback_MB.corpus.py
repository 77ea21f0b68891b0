"""The bytes ``PackedEncoder._encode_buffer`` reads back from the device,
in 10^6 B an ``encode_batch`` call over the whole run: the program's
counters ``readback_bytes`` / ``encode_calls``
(``tekken_tpu_torch.utils.timing.COUNTERS``), read from the program the
run loaded: the yardstick imports nothing of the program."""

import sys

COUNTER = "readback_bytes"


def read(ctx):
    timing = sys.modules.get("tekken_tpu_torch.utils.timing")
    totals = getattr(getattr(timing, "COUNTERS", None), "totals", {})
    if COUNTER not in totals or not totals.get("encode_calls"):
        return None
    return totals[COUNTER] / totals["encode_calls"] / 1e6
