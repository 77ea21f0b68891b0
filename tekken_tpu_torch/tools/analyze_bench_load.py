"""Measure the bench corpus's merge-work structure (host-side, no device):
the counterpart of the repo's ``tools/analyze_bench_load.py``, which it
prints line for line.

    python -m tekken_tpu_torch.tools.analyze_bench_load

Reports: piece length histogram, whole-piece hit rate (pieces that are
vocab tokens), merges needed per non-hit piece, and the implied per-round
active-row counts — the data that decides compaction/bucketing strategy.
"""

from __future__ import annotations

import base64
import random
import sys
from collections import Counter

from ..models import bench_words, build_bench_vocab, build_corpus
from ..models.bench import BENCH_SEED
from ..oracle import byte_pair_merge, pretokenize


def main(argv=None) -> int:
    rng = random.Random(BENCH_SEED)
    words = bench_words(rng)
    vocab = build_bench_vocab(words)
    ranks = {}
    for ti in vocab:
        ranks[base64.b64decode(ti.token_bytes)] = ti.rank

    docs = build_corpus(words, rng, n_docs=32, doc_len=2048)
    total_bytes = sum(len(d.encode()) for d in docs)

    plen_hist = Counter()
    merges_hist = Counter()
    n_pieces = 0
    n_single = 0
    n_whole_hit = 0
    merge_bytes = 0
    for d in docs:
        for spiece in pretokenize(d):
            piece = spiece.encode("utf-8")
            n_pieces += 1
            L = len(piece)
            plen_hist[L] += 1
            if L == 1:
                n_single += 1
                continue
            if piece in ranks:
                n_whole_hit += 1
                continue
            toks = byte_pair_merge(piece, ranks)
            merges_hist[L - len(toks)] += 1
            merge_bytes += L

    print(f"docs={len(docs)} bytes={total_bytes} pieces={n_pieces} "
          f"single={n_single} whole_hit={n_whole_hit} "
          f"active={n_pieces - n_single - n_whole_hit}")
    print(f"whole-hit rate among multi-byte pieces: "
          f"{n_whole_hit / max(1, n_pieces - n_single):.3f}")
    print(f"active rows per KB of input: "
          f"{(n_pieces - n_single - n_whole_hit) / (total_bytes / 1024):.2f}")
    print("piece length hist:", dict(sorted(plen_hist.items())))
    print("merges-needed hist (non-hit pieces):",
          dict(sorted(merges_hist.items())))
    if merges_hist:
        mx = max(merges_hist)
        tot = sum(merges_hist.values())
        # rows still active after k rounds
        acc = 0
        line = []
        for k in range(mx + 1):
            acc += merges_hist.get(k, 0)
            line.append(f"r{k}:{tot - acc}")
        print("active rows remaining after round k:", " ".join(line))
    print(f"bytes in active pieces: {merge_bytes} "
          f"({merge_bytes / total_bytes:.2%} of input)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
