"""``csrc/merge_rows.cu``'s share of its bytes bound over the profiled
calls (the bucket merge, one launch an encode call): the benchmark's
byte count at 3.35 TB/s against the kernel's time in the device trace,
in percent.

The kernel merges the pieces of 4-8 bytes that are not tokens.  Bytes a
piece (what it needs, each once): its record (8 B) and its bytes read;
12 B (a pair of ranks and the rank it makes) for each pair lookup that
the reference's merge loop makes on it, counted by running that loop;
4 B for each token written."""

from benchmark.core.peaks import roofline_pct
from benchmark.core.reference import merge_loop, pretokenize

KERNEL = "merge_buckets_kernel"
LO, HI = 4, 8


def doc_bytes(doc: str, ranks) -> int:
    total = 0
    for p in pretokenize(doc):
        b = p.encode("utf-8")
        if LO <= len(b) <= HI and b not in ranks:
            looked = [0]

            def rank_of(x):
                looked[0] += 1
                return ranks.get(x)
            toks = merge_loop(b, rank_of)
            # the loop's final reads of each token's own rank are not
            # pair lookups
            total += 8 + len(b) + 12 * (looked[0] - len(toks)) \
                + 4 * len(toks)
    return total


def read(ctx):
    t = ctx.trace
    if t is None or ctx.reference is None:
        return None
    ranks = ctx.reference.ranks
    nbytes = sum(ctx.cached(("merge_bytes", b), lambda b=b: sum(
        doc_bytes(d, ranks) for d in ctx.pool[b])) for b in t.inputs)
    return roofline_pct(nbytes, t.kernel(KERNEL))
