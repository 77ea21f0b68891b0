"""Generator ``corpus``: ``pool_batches`` batches of documents of
``doc_bytes`` bytes, each Pareto-ranked prose (``core/traffic.py``)
with the mix's per-word replacements (``replace``) and, where the mix
has them, per-doc ones (``doc_replace``: a share ``p`` of the docs gets
``words`` of its words replaced), cut to ``doc_bytes`` on a character
boundary.  The same seed gives the same pool."""

from __future__ import annotations

import random

from benchmark.core.traffic import (clip_bytes, prose, replace_in_doc,
                                    replace_words)


def doc(mix, words, is_token, rng) -> str:
    n = mix["doc_bytes"]
    text = replace_words(prose(words, rng, n, mix)[:n], rng,
                         mix.get("replace", []), is_token)
    if mix.get("doc_replace"):
        text = replace_in_doc(text, rng, mix["doc_replace"], is_token)
    return clip_bytes(text, n)


def pool(mix, words, is_token, seed, n_docs) -> list[list[str]]:
    """``pool_batches`` batches of ``n_docs`` docs."""
    out = []
    for b in range(mix["pool_batches"]):
        rng = random.Random(f"{seed}/batch/{b}")
        out.append([doc(mix, words, is_token, rng) for _ in range(n_docs)])
    return out
