"""The misses merged on the host (``ops/packed.py``
``splice_host_merges``) an ``encode_batch`` call over the whole run: the
program's counters ``host_merge_spans`` / ``encode_calls``
(``tekken_tpu_torch.utils.timing.COUNTERS``), read from the program the
run loaded: the yardstick imports nothing of the program."""

import sys

COUNTER = "host_merge_spans"


def read(ctx):
    timing = sys.modules.get("tekken_tpu_torch.utils.timing")
    totals = getattr(getattr(timing, "COUNTERS", None), "totals", {})
    if COUNTER not in totals or not totals.get("encode_calls"):
        return None
    return totals[COUNTER] / totals["encode_calls"]
