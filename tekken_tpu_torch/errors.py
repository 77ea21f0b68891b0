"""Error taxonomy of the tekken-tpu framework (PyTorch port: a copy of the
JAX package's module, kept so the port imports nothing of it).

Mirrors the reference's error surface (reference: src/errors.rs:22-59), which is
a flat enum of nine variants.  Here each variant is an exception class rooted at
``TokenizerError`` so callers can catch the whole family or a single condition.
"""

from __future__ import annotations


class TokenizerError(Exception):
    """Base class for all tokenizer errors (reference: src/errors.rs:22)."""


class IoError(TokenizerError):
    """I/O operation failed (reference: src/errors.rs:25-26)."""


class JsonError(TokenizerError):
    """JSON parsing or serialization failed (reference: src/errors.rs:29-30)."""


class Base64Error(TokenizerError):
    """Base64 decoding failed (reference: src/errors.rs:33-34)."""


class TokenizersError(TokenizerError):
    """Error in the underlying tokenization engine (reference: src/errors.rs:37-38)."""


class AudioError(TokenizerError):
    """Audio processing operation failed (reference: src/errors.rs:41-42)."""


class InvalidConfigError(TokenizerError):
    """Configuration parameters are invalid or inconsistent (reference: src/errors.rs:45-46)."""


class TokenNotFoundError(TokenizerError):
    """Required (special) token missing from vocabulary (reference: src/errors.rs:49-50)."""


class SpecialTokenPolicyError(TokenizerError):
    """Operation violated the specified special-token policy (reference: src/errors.rs:53-54)."""


class UnsupportedFormatError(TokenizerError):
    """File/data format is not supported (reference: src/errors.rs:57-58)."""
