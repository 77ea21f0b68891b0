"""Model-file schema and version handling.

Parity with the reference config layer (reference: src/config.rs):
- ``TokenInfo``          {rank, token_bytes(base64), token_str?}   (src/config.rs:16-23)
- ``TekkenConfig``       {pattern, num_vocab_tokens, default_vocab_size,
                          default_num_special_tokens, version}      (src/config.rs:38-49)
- ``ImageConfig``        placeholder                                (src/config.rs:56-59)
- ``ModelData``          tekken.json root                           (src/config.rs:73-82)
- ``TokenizerVersion``   V3/V7/V11/V13 enum                         (src/config.rs:97-157)

The audio config types live in :mod:`tekken_tpu_torch.audio`.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Optional

from .errors import InvalidConfigError, IoError, JsonError
from .special_tokens import SpecialTokenInfo


@dataclass(frozen=True)
class TokenInfo:
    """One vocabulary entry (reference: src/config.rs:16-23)."""

    rank: int
    token_bytes: str  # base64-encoded bytes
    token_str: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "TokenInfo":
        return cls(rank=int(d["rank"]), token_bytes=d["token_bytes"],
                   token_str=d.get("token_str"))

    def to_dict(self) -> dict:
        return {"rank": self.rank, "token_bytes": self.token_bytes,
                "token_str": self.token_str}


@dataclass(frozen=True)
class TekkenConfig:
    """Core tokenizer configuration (reference: src/config.rs:38-49).

    Note: like the reference, the ``pattern`` field is carried but the
    tokenizer always uses the hardcoded Tekken pattern
    (reference: src/tekkenizer.rs:74,123).
    """

    pattern: str
    num_vocab_tokens: int
    default_vocab_size: int
    default_num_special_tokens: int
    version: str

    @classmethod
    def from_dict(cls, d: dict) -> "TekkenConfig":
        try:
            return cls(
                pattern=d["pattern"],
                num_vocab_tokens=int(d["num_vocab_tokens"]),
                default_vocab_size=int(d["default_vocab_size"]),
                default_num_special_tokens=int(d["default_num_special_tokens"]),
                version=d["version"],
            )
        except KeyError as e:  # missing required field
            raise JsonError(f"Missing config field: {e}") from e

    def to_dict(self) -> dict:
        return {
            "pattern": self.pattern,
            "num_vocab_tokens": self.num_vocab_tokens,
            "default_vocab_size": self.default_vocab_size,
            "default_num_special_tokens": self.default_num_special_tokens,
            "version": self.version,
        }


@dataclass(frozen=True)
class ImageConfig:
    """Placeholder for image processing config (reference: src/config.rs:56-59)."""


class TokenizerVersion(enum.Enum):
    """Supported tokenizer versions (reference: src/config.rs:97-157)."""

    V3 = "v3"
    V7 = "v7"
    V11 = "v11"
    V13 = "v13"

    @classmethod
    def from_string(cls, s: str) -> Optional["TokenizerVersion"]:
        """Parse a version string; None for unknown
        (reference: src/config.rs:124-132)."""
        try:
            return cls(s)
        except ValueError:
            return None

    def as_str(self) -> str:
        return self.value


@dataclass
class ModelData:
    """Root of a ``tekken.json`` model file (reference: src/config.rs:73-82)."""

    vocab: list  # list[TokenInfo]
    config: TekkenConfig
    special_tokens: Optional[list] = None  # list[SpecialTokenInfo] | None
    audio: Optional[object] = None  # AudioConfig | None
    vocab_raw: Optional[list] = field(default=None, repr=False)  # raw dicts, for fast paths

    @classmethod
    def from_json(cls, content: str) -> "ModelData":
        from .audio import AudioConfig  # local import to avoid cycle

        try:
            raw = json.loads(content)
        except json.JSONDecodeError as e:
            raise JsonError(str(e)) from e

        try:
            vocab_raw = raw["vocab"]
            vocab = [TokenInfo.from_dict(t) for t in vocab_raw]
            config = TekkenConfig.from_dict(raw["config"])
        except (KeyError, TypeError) as e:
            raise JsonError(f"Malformed model data: {e}") from e

        special = raw.get("special_tokens")
        special_tokens = (
            [SpecialTokenInfo.from_dict(t) for t in special]
            if special is not None else None
        )
        audio_raw = raw.get("audio")
        audio = AudioConfig.from_dict(audio_raw) if audio_raw is not None else None
        return cls(vocab=vocab, config=config, special_tokens=special_tokens,
                   audio=audio, vocab_raw=vocab_raw)

    @classmethod
    def from_file(cls, path) -> "ModelData":
        try:
            with open(path, "r", encoding="utf-8") as f:
                content = f.read()
        except OSError as e:
            raise IoError(str(e)) from e
        return cls.from_json(content)

    def to_json(self) -> str:
        out = {
            "vocab": [t.to_dict() for t in self.vocab],
            "config": self.config.to_dict(),
        }
        if self.special_tokens is not None:
            out["special_tokens"] = [t.to_dict() for t in self.special_tokens]
        if self.audio is not None:
            out["audio"] = self.audio.to_dict()
        return json.dumps(out)


def parse_version(version_str: str) -> TokenizerVersion:
    """Strict version parse; raises like the reference loader does on unknown
    versions (reference: src/tekkenizer.rs:226-232)."""
    v = TokenizerVersion.from_string(version_str)
    if v is None:
        raise InvalidConfigError(f"Unknown version: {version_str}")
    return v
