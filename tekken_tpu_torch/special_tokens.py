"""Special-token definitions and decode policies.

Behavioral parity with the reference (reference: src/special_tokens.rs):
- ``SpecialTokens``: 25 canonical special tokens (src/special_tokens.rs:19-97)
- ``SpecialTokenPolicy``: Ignore / Keep / Raise decode policies
  (src/special_tokens.rs:129-136)
- ``SpecialTokenInfo``: {rank, token_str, is_control} record
  (src/special_tokens.rs:161-168)
- ``get_deprecated_special_tokens``: the 20-token legacy table used when a
  model file carries no ``special_tokens`` section
  (reference: src/tekkenizer.rs:827-930)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class SpecialTokens(enum.Enum):
    """Canonical special tokens (reference: src/special_tokens.rs:19-45)."""

    UNK = "<unk>"
    BOS = "<s>"
    EOS = "</s>"
    BEGIN_INST = "[INST]"
    END_INST = "[/INST]"
    BEGIN_TOOLS = "[AVAILABLE_TOOLS]"
    END_TOOLS = "[/AVAILABLE_TOOLS]"
    BEGIN_TOOL_RESULTS = "[TOOL_RESULTS]"
    END_TOOL_RESULTS = "[/TOOL_RESULTS]"
    TOOL_CALLS = "[TOOL_CALLS]"
    IMG = "[IMG]"
    PAD = "<pad>"
    IMG_BREAK = "[IMG_BREAK]"
    IMG_END = "[IMG_END]"
    PREFIX = "[PREFIX]"
    MIDDLE = "[MIDDLE]"
    SUFFIX = "[SUFFIX]"
    BEGIN_SYSTEM = "[SYSTEM_PROMPT]"
    END_SYSTEM = "[/SYSTEM_PROMPT]"
    BEGIN_TOOL_CONTENT = "[TOOL_CONTENT]"
    AUDIO = "[AUDIO]"
    BEGIN_AUDIO = "[BEGIN_AUDIO]"
    TRANSCRIBE = "[TRANSCRIBE]"
    ARGS = "[ARGS]"
    CALL_ID = "[CALL_ID]"

    def as_str(self) -> str:
        """String form used in the vocabulary (reference: src/special_tokens.rs:68-96)."""
        return self.value


class SpecialTokenPolicy(enum.Enum):
    """How special tokens are handled during decode
    (reference: src/special_tokens.rs:129-136)."""

    IGNORE = "ignore"  # skip special tokens in output
    KEEP = "keep"      # include their string form
    RAISE = "raise"    # error if any special token is present


@dataclass(frozen=True)
class SpecialTokenInfo:
    """Metadata for one special token (reference: src/special_tokens.rs:161-168)."""

    rank: int
    token_str: str
    is_control: bool

    @classmethod
    def from_dict(cls, d: dict) -> "SpecialTokenInfo":
        return cls(rank=int(d["rank"]), token_str=str(d["token_str"]),
                   is_control=bool(d["is_control"]))

    def to_dict(self) -> dict:
        return {"rank": self.rank, "token_str": self.token_str,
                "is_control": self.is_control}


# Rank order of the legacy 20-token table (reference: src/tekkenizer.rs:827-930).
_DEPRECATED_ORDER = (
    SpecialTokens.UNK,
    SpecialTokens.BOS,
    SpecialTokens.EOS,
    SpecialTokens.BEGIN_INST,
    SpecialTokens.END_INST,
    SpecialTokens.BEGIN_TOOLS,
    SpecialTokens.END_TOOLS,
    SpecialTokens.BEGIN_TOOL_RESULTS,
    SpecialTokens.END_TOOL_RESULTS,
    SpecialTokens.TOOL_CALLS,
    SpecialTokens.IMG,
    SpecialTokens.PAD,
    SpecialTokens.IMG_BREAK,
    SpecialTokens.IMG_END,
    SpecialTokens.PREFIX,
    SpecialTokens.MIDDLE,
    SpecialTokens.SUFFIX,
    SpecialTokens.BEGIN_SYSTEM,
    SpecialTokens.END_SYSTEM,
    SpecialTokens.BEGIN_TOOL_CONTENT,
)


def get_deprecated_special_tokens() -> list[SpecialTokenInfo]:
    """Legacy special-token table for model files lacking a ``special_tokens``
    section (reference: src/tekkenizer.rs:827-930; all entries is_control)."""
    return [
        SpecialTokenInfo(rank=i, token_str=tok.as_str(), is_control=True)
        for i, tok in enumerate(_DEPRECATED_ORDER)
    ]
