"""Scalar host reference encoder ("the oracle").

A from-scratch, pure-Python implementation of the Tekken text pipeline with
the exact observable semantics of the reference's engine
(tiktoken-style byte-level BPE; reference: src/tekkenizer.rs:122-126
constructs the engine with the hardcoded pattern below and an empty
special-token map, so special strings are never matched in user text).

This module is the correctness substrate of the PyTorch port (a copy of
the JAX package's oracle): it referees the CUDA path in chip_smoke.py and
is the exact host path for spliced fallback spans and re-encoded rows.

Semantics pinned here:
- The hardcoded regex pre-tokenizer pattern (reference: src/tekkenizer.rs:123).
  Matches tile the input; pieces are encoded independently.
- Per-piece byte-level BPE: repeatedly merge the leftmost lowest-rank adjacent
  segment pair, where a pair's rank is the vocab rank of its concatenated
  bytes; stop when no adjacent pair concatenation is in the vocab.
- Decode: rank -> bytes concatenation, lossy UTF-8 (U+FFFD) on invalid
  sequences (the engine's decode behavior observed via
  reference: src/tekkenizer.rs:548-557).
"""

from __future__ import annotations

import regex as _regex

# The hardcoded Tekken pre-tokenization pattern
# (reference: src/tekkenizer.rs:123). Note the case-insensitive contraction
# group, Unicode \p{L}/\p{N} classes, and the (?!\S) negative lookahead.
TEKKEN_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)

_COMPILED = _regex.compile(TEKKEN_PATTERN)


def pretokenize(text: str) -> list[str]:
    """Split text into pre-tokenization pieces.

    Matches of the hardcoded pattern tile the whole input (every character is
    matched by one of the alternatives), so this is a lossless segmentation.
    """
    return _COMPILED.findall(text)


def byte_pair_merge(piece: bytes, ranks: dict[bytes, int]) -> list[int]:
    """Sequential BPE merge of one piece; returns vocab ranks.

    Invariant: every live segment's byte span is itself a vocab token (byte
    tokens 0..255 are validated to exist at ranks 0..255 by
    vocab.reload_mergeable_ranks, mirroring reference: src/tekkenizer.rs:792-798),
    so segment pairs can be ranked by concatenated-bytes lookup.
    """
    whole = ranks.get(piece)
    if whole is not None:
        return [whole]
    return byte_pair_merge_no_whole(piece, ranks)


def byte_pair_merge_no_whole(piece: bytes, ranks: dict[bytes, int]) -> list[int]:
    """The greedy merge loop WITHOUT the whole-piece shortcut.

    Used (a) by ``byte_pair_merge`` after its whole-piece check and (b) by
    vocab.CuckooPieceTable.direct_map to decide whether a token is
    *greedy-stable* — whether merging its own bytes reproduces it.  A token
    that is NOT greedy-stable relies on the whole-piece probe for exactness
    and must never be evicted from the direct-mapped candidate table.
    """
    n = len(piece)
    if n == 0:
        return []
    if n == 1:
        return [ranks[piece]]

    INF = 1 << 62
    # starts[i] = byte offset of segment i; pair_rank[i] = rank of merging
    # segment i with segment i+1 (INF if not mergeable).
    starts = list(range(n)) + [n]
    pair_rank = [ranks.get(piece[i:i + 2], INF) for i in range(n - 1)] + [INF]

    while True:
        best = INF
        best_i = -1
        for i, r in enumerate(pair_rank):
            if r < best:  # strict: leftmost minimum wins
                best = r
                best_i = i
        if best == INF:
            break
        i = best_i
        # merge segments i and i+1
        del starts[i + 1]
        del pair_rank[i + 1]
        pair_rank[i] = (
            ranks.get(piece[starts[i]:starts[i + 2]], INF)
            if i + 2 < len(starts) else INF
        )
        if i > 0:
            pair_rank[i - 1] = ranks.get(piece[starts[i - 1]:starts[i + 1]], INF)

    return [ranks[piece[starts[i]:starts[i + 1]]] for i in range(len(starts) - 1)]


def encode_ranks(text: str, ranks: dict[bytes, int]) -> list[int]:
    """Encode text to engine ranks (pre-shift; the public token-id space adds
    num_special_tokens — reference: src/tekkenizer.rs:390-392)."""
    out: list[int] = []
    for piece in pretokenize(text):
        out.extend(byte_pair_merge(piece.encode("utf-8"), ranks))
    return out


def decode_bytes(token_ranks, decode_table) -> bytes:
    """Concatenate the byte spans of the given engine ranks."""
    return b"".join(decode_table.token_bytes(int(r)) for r in token_ranks)


def decode_lossy(token_ranks, decode_table) -> str:
    """Ranks -> string with U+FFFD substitution on invalid UTF-8 (the
    engine's lossy decode, observed via reference: src/tekkenizer.rs:552-556)."""
    return decode_bytes(token_ranks, decode_table).decode("utf-8", errors="replace")
