"""The share of the byte planes ``PackedEncoder`` uploads that is
padding, over the whole run, in percent: 100 x (1 - ``text_bytes`` /
``plane_bytes``), the program's counters
(``tekken_tpu_torch.utils.timing.COUNTERS``), read from the program the
run loaded: the yardstick imports nothing of the program.  A program
without the counters reads None."""

import sys


def read(ctx):
    timing = sys.modules.get("tekken_tpu_torch.utils.timing")
    totals = getattr(getattr(timing, "COUNTERS", None), "totals", {})
    if not totals.get("plane_bytes") or "text_bytes" not in totals:
        return None
    return 100.0 * (1.0 - totals["text_bytes"] / totals["plane_bytes"])
