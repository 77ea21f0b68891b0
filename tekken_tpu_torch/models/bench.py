"""The bench configuration's builders (copies of the repo's ``bench.py``
builders, which import the JAX package): the seeded word list, the
130,872-rank prefix-chain vocabulary over it, and the Pareto-distributed
corpus.

``bench_tokenizer`` is the bench's tokenizer (1,000 specials, V7).
``chip_smoke.py`` builds its full-width configuration from these, and
``graft_entry.dryrun_multichip`` and the tools their bench tokenizer.
"""

from __future__ import annotations

import base64
import random

from ..config import TokenInfo, TokenizerVersion
from ..special_tokens import get_deprecated_special_tokens
from ..tekkenizer import Tekkenizer

BENCH_SEED = 1234
N_WORDS = 40_000
INNER_VOCAB = 130_872


def bench_words(rng=None) -> list[str]:
    """The corpus words: N_WORDS lowercase words of 2-11 letters, drawn
    from ``rng`` (default ``random.Random(BENCH_SEED)``)."""
    if rng is None:
        rng = random.Random(BENCH_SEED)
    return ["".join(rng.choice("abcdefghijklmnopqrstuvwxyz")
                    for _ in range(rng.randint(2, 11)))
            for _ in range(N_WORDS)]


def build_bench_vocab(words, inner_vocab: int = INNER_VOCAB
                      ) -> list[TokenInfo]:
    """Byte tokens + prefix-chain tokens for corpus words (valid BPE merge
    trees: each token splits into (prefix, last byte)); bare and
    space-prefixed chains, like real byte-level BPE vocabularies, so
    whole-piece hit rates are representative."""
    tokens: list[bytes] = [bytes([i]) for i in range(256)]
    seen = set(tokens)
    full = False
    for w in words:
        for b in (b" " + w.encode("utf-8"), w.encode("utf-8")):
            for k in range(2, len(b) + 1):
                t = b[:k]
                if t not in seen:
                    seen.add(t)
                    tokens.append(t)
                if len(tokens) >= inner_vocab:
                    full = True
                    break
            if full:
                break
        if full:
            break
    return [TokenInfo(rank=r, token_bytes=base64.b64encode(t).decode(),
                      token_str=None) for r, t in enumerate(tokens)]


def bench_tokenizer(words, device="cuda", inner_vocab: int = INNER_VOCAB
                    ) -> Tekkenizer:
    """The bench tokenizer on ``device``: ``build_bench_vocab(words,
    inner_vocab)``, the deprecated specials (1,000), pattern ``.*``, V7."""
    vocab = build_bench_vocab(words, inner_vocab)
    return Tekkenizer(
        vocab=vocab, special_tokens=get_deprecated_special_tokens(),
        pattern=".*", vocab_size=len(vocab) + 1000, num_special_tokens=1000,
        version=TokenizerVersion.V7, device=device)


def build_corpus(words, rng, n_docs: int, doc_len: int) -> list[str]:
    """``n_docs`` docs of about ``doc_len`` bytes: Pareto-ranked words, ~10%
    numbers, ~15% trailing punctuation."""
    docs = []
    for _ in range(n_docs):
        parts = []
        size = 0
        while size < doc_len - 16:
            w = words[min(int(rng.paretovariate(1.1)) - 1, len(words) - 1)]
            parts.append(w)
            size += len(w) + 1
            if rng.random() < 0.1:
                parts.append(str(rng.randint(0, 999)))
                size += 4
            if rng.random() < 0.15:
                parts[-1] += rng.choice(".,!?;:")
        docs.append(" ".join(parts)[:doc_len])
    return docs
