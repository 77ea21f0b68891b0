"""``csrc/stage1_compact.cu``'s share of its bytes bound over the profiled
calls: the benchmark's byte count at 3.35 TB/s against the kernel's time
in the device trace, in percent.

Bytes a doc (what these inputs need, each once): its UTF-8 bytes and its
length (4 B) read, and, for a doc with a byte >= 0x80 (route 3), one
boundary-flag byte a byte read; for each piece the Tekken pattern makes
of it, its start and length (8 B) written, and the row's piece count
(4 B).  Not the (B, R) planes the kernel fills."""

from benchmark.core.peaks import roofline_pct
from benchmark.core.reference import pretokenize

KERNEL = "stage1_compact_kernel"


def doc_bytes(doc: str) -> int:
    b = doc.encode("utf-8")
    flags = len(b) if b and max(b) >= 0x80 else 0
    return len(b) + 4 + flags + 8 * len(pretokenize(doc)) + 4


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    nbytes = sum(ctx.cached(("stage1_bytes", b), lambda b=b: sum(
        doc_bytes(d) for d in ctx.pool[b])) for b in t.inputs)
    return roofline_pct(nbytes, t.kernel(KERNEL))
