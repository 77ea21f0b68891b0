"""The plain reference of the Tekken decode (tekken-rs ``decode_all`` and
``decode``, src/tekkenizer.rs:436-560).

It imports nothing of the program: it decodes with the token bytes the
benchmark made and a frozen copy of the special-token table.  The ids
are split into maximal runs of the same specialness; a run of specials
is dropped under IGNORE, replaced by the specials' strings under KEEP
and an error under RAISE; a run of ranks is its tokens' bytes joined
and decoded as lossy UTF-8, so a character cut by a special decodes to
replacement characters on both sides.
"""

from __future__ import annotations

# the legacy special-token table in rank order (tekken-rs
# src/tekkenizer.rs:827-930, the strings of src/special_tokens.rs:68-96);
# ids past it up to the special count are ``<SPECIAL_i>``
DEPRECATED_SPECIALS = (
    "<unk>", "<s>", "</s>", "[INST]", "[/INST]", "[AVAILABLE_TOOLS]",
    "[/AVAILABLE_TOOLS]", "[TOOL_RESULTS]", "[/TOOL_RESULTS]",
    "[TOOL_CALLS]", "[IMG]", "<pad>", "[IMG_BREAK]", "[IMG_END]",
    "[PREFIX]", "[MIDDLE]", "[SUFFIX]", "[SYSTEM_PROMPT]",
    "[/SYSTEM_PROMPT]", "[TOOL_CONTENT]")
POLICIES = ("IGNORE", "KEEP", "RAISE")


def special_strings(num_special: int) -> list[str]:
    """The strings of ids 0..num_special-1 under the legacy table."""
    return [DEPRECATED_SPECIALS[i] if i < len(DEPRECATED_SPECIALS)
            else f"<SPECIAL_{i}>" for i in range(num_special)]


class SpecialTokenError(ValueError):
    """A special token decoded under RAISE."""


class DecodeReference:
    """Decode over ``token_bytes`` (rank i is ``token_bytes[i]``), with the
    specials ``specials`` (strings by id) below the ranks."""

    def __init__(self, token_bytes: list[bytes], specials: list[str]):
        self.token_bytes = token_bytes
        self.specials = specials

    def runs(self, ids) -> list[tuple[bool, list[int]]]:
        """(is special, ids) of each maximal same-specialness run."""
        ns = len(self.specials)
        out: list[tuple[bool, list[int]]] = []
        for t in ids:
            sp = t < ns
            if out and out[-1][0] == sp:
                out[-1][1].append(t)
            else:
                out.append((sp, [t]))
        return out

    def decode_all(self, ids, policy: str) -> list[str]:
        """The decoded segments, one a run of ranks and, under KEEP, one a
        special."""
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}: {policy!r}")
        ns = len(self.specials)
        out: list[str] = []
        for sp, run in self.runs(ids):
            if sp:
                if policy == "RAISE":
                    raise SpecialTokenError(
                        f"special tokens {run} under RAISE")
                if policy == "KEEP":
                    out += [self.specials[t] for t in run]
                continue
            parts = []
            for t in run:
                r = t - ns
                if not 0 <= r < len(self.token_bytes):
                    raise ValueError(f"invalid token id for decode: {t}")
                parts.append(self.token_bytes[r])
            out.append(b"".join(parts).decode("utf-8", errors="replace"))
        return out

    def decode(self, ids, policy: str) -> str:
        return "".join(self.decode_all(ids, policy))
