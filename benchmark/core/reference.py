"""The plain reference of the Tekken text pipeline.

A frozen copy of the oracle's semantics (tekken-rs: the hardcoded Tekken
pre-tokenization pattern, tiktoken-style byte-level BPE per piece).  It
imports nothing of the program: it builds its rank table from the token
bytes the benchmark made, and judges the program's outputs against its
own.
"""

from __future__ import annotations

import regex

# the hardcoded Tekken pattern (tekken-rs src/tekkenizer.rs:123); the
# reference ignores config.pattern
TEKKEN_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_PIECES = regex.compile(TEKKEN_PATTERN)
INF = 1 << 62


def pretokenize(text: str) -> list[str]:
    """The pieces of ``text``; they tile it."""
    return _PIECES.findall(text)


class Reference:
    """Encode over a rank table made from ``token_bytes`` (rank
    i is ``token_bytes[i]``), with ``num_special`` special ids below the
    ranks."""

    pieces = staticmethod(pretokenize)

    def __init__(self, token_bytes: list[bytes], num_special: int):
        self.token_bytes = token_bytes
        self.ranks = {t: r for r, t in enumerate(token_bytes)}
        self.num_special = num_special

    def merge(self, piece: bytes) -> list[int]:
        """Byte-level BPE of one piece: the whole piece if it is a token,
        else repeatedly merge the leftmost lowest-rank adjacent pair."""
        whole = self.ranks.get(piece)
        if whole is not None:
            return [whole]
        return merge_loop(piece, self.ranks.get)

    def encode(self, text: str, bos_id=None, eos_id=None,
               shift: bool = True) -> list[int]:
        """Public ids: ranks shifted by ``num_special``, BOS/EOS where
        given (engine ranks with ``shift`` False)."""
        ns = self.num_special if shift else 0
        out = [] if bos_id is None else [bos_id]
        for p in self.pieces(text):
            out += [r + ns for r in self.merge(p.encode("utf-8"))]
        if eos_id is not None:
            out.append(eos_id)
        return out


def merge_loop(piece: bytes, rank_of, pick=None) -> list[int]:
    """The merge loop without the whole-piece shortcut.  ``rank_of(bytes)``
    gives a rank or None.  ``pick(pair_ranks)`` chooses the pair to merge
    (None: none left); the default takes the leftmost lowest rank."""
    n = len(piece)
    if n == 1:
        return [rank_of(piece)]
    starts = list(range(n + 1))

    def pr(i):
        r = rank_of(piece[starts[i]:starts[i + 2]])
        return INF if r is None else r

    pair = [pr(i) for i in range(n - 1)]
    while pair:
        i = _lowest(pair) if pick is None else pick(pair)
        if i is None:
            break
        del starts[i + 1]
        del pair[i]
        if i < len(pair):
            pair[i] = pr(i)
        if i > 0:
            pair[i - 1] = pr(i - 1)
    return [rank_of(piece[starts[i]:starts[i + 1]])
            for i in range(len(starts) - 1)]


def _lowest(pair):
    best = min(pair)
    return None if best == INF else pair.index(best)
