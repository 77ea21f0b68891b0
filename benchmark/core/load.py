"""A description of the traffic's merge work (a frozen copy of the
port's ``tools/analyze_bench_load``, host only): how many pieces are
single bytes or whole tokens, and the bytes and length classes of the
misses that need merges."""

from __future__ import annotations

from .reference import pretokenize

CLASSES = ((2, 3, "p23"), (4, 4, "p4"), (5, 8, "p8"), (9, 1 << 30, "host"))


def describe(docs, ranks) -> dict:
    n_bytes = pieces = single = whole = miss_bytes = 0
    misses = {name: 0 for _, _, name in CLASSES}
    for d in docs:
        n_bytes += len(d.encode("utf-8"))
        for p in pretokenize(d):
            b = p.encode("utf-8")
            pieces += 1
            if len(b) == 1:
                single += 1
            elif b in ranks:
                whole += 1
            else:
                miss_bytes += len(b)
                for lo, hi, name in CLASSES:
                    if lo <= len(b) <= hi:
                        misses[name] += 1
    multi = max(1, pieces - single)
    return {"docs": len(docs), "bytes": n_bytes, "pieces": pieces,
            "single": single, "whole_hit_share": whole / multi,
            "miss_byte_share": miss_bytes / max(1, n_bytes),
            "misses_by_class": misses}
