"""The vocabulary the benchmark makes from the seed (frozen copies of the
port's ``models/bench.py`` builders): seeded lowercase words, and byte
tokens plus bare and space-prefixed prefix chains of those words, cut at
the configuration's BPE rank count."""

from __future__ import annotations

import random

LETTERS = "abcdefghijklmnopqrstuvwxyz"


def make_words(rng: random.Random, n: int, lo: int, hi: int) -> list[str]:
    """``n`` lowercase words of ``lo``..``hi`` letters, their letters from
    ``rng``.  The length of the word of each rank is the same for every
    seed (drawn from a fixed generator): the top ranks carry most of the
    traffic, so a seed that drew them long or short would change the
    work."""
    lengths = random.Random("benchmark/word-lengths")
    return ["".join(rng.choice(LETTERS)
                    for _ in range(lengths.randint(lo, hi)))
            for _ in range(n)]


def prefix_chain_tokens(words, n_ranks: int) -> list[bytes]:
    """Rank i's bytes: the 256 single bytes, then every new prefix of at
    least two bytes of " word" and "word", word by word, until ``n_ranks``
    (each token splits into a token and its last byte, so every token is
    reachable by BPE merges)."""
    tokens = [bytes([i]) for i in range(256)]
    seen = set(tokens)
    for w in words:
        for b in (b" " + w.encode(), w.encode()):
            for k in range(2, len(b) + 1):
                t = b[:k]
                if t not in seen:
                    seen.add(t)
                    tokens.append(t)
                    if len(tokens) == n_ranks:
                        return tokens
    raise ValueError(f"{len(words)} words give fewer than {n_ranks} ranks")


def build(cfg: dict, seed: int) -> tuple[list[str], list[bytes]]:
    """(words, token bytes by rank) of a configuration from ``seed``."""
    v = cfg["vocabulary"]
    words = make_words(random.Random(f"{seed}/words"), v["words"],
                       v["min_letters"], v["max_letters"])
    n_ranks = cfg["default_vocab_size"] - cfg["default_num_special_tokens"]
    return words, prefix_chain_tokens(words, n_ranks)
