"""tekken_tpu_torch: the Tekken tokenizer on PyTorch and CUDA (NVIDIA H100).

The port of the JAX package ``tekken_tpu``, which stays beside it as the
reference.  This package imports torch and never jax, and nothing of the
JAX package.  Its batched encode and decode run on the GPU with kernels
written by hand for Hopper (``csrc/``, built with nvcc at first use); on
CPU tensors the same functions run their plain PyTorch versions.  The
data-parallel layer (``parallel/``) shards document rows over the ranks
of a ``torch.distributed`` process group.  The host engine (``native/``)
is the JAX package's C++ engine, built with g++ at first use;
``models/`` builds synthetic model files and ``python -m
tekken_tpu_torch`` is the command line.
"""

from .audio import (
    Audio,
    AudioConfig,
    AudioEncoder,
    AudioEncoding,
    AudioSpectrogramConfig,
    hertz_to_mel,
    mel_filter_bank,
    mel_to_hertz,
)
from .config import (
    ImageConfig,
    ModelData,
    TekkenConfig,
    TokenInfo,
    TokenizerVersion,
)
from .errors import (
    AudioError,
    Base64Error,
    InvalidConfigError,
    IoError,
    JsonError,
    SpecialTokenPolicyError,
    TokenizerError,
    TokenizersError,
    TokenNotFoundError,
    UnsupportedFormatError,
)
from .oracle import TEKKEN_PATTERN
from .special_tokens import (
    SpecialTokenInfo,
    SpecialTokenPolicy,
    SpecialTokens,
    get_deprecated_special_tokens,
)
from .tekkenizer import Tekkenizer

__version__ = "0.1.0"

__all__ = [
    "Audio", "AudioConfig", "AudioEncoder", "AudioEncoding",
    "AudioSpectrogramConfig", "hertz_to_mel", "mel_filter_bank",
    "mel_to_hertz",
    "AudioError", "Base64Error", "ImageConfig", "InvalidConfigError",
    "IoError", "JsonError", "ModelData", "SpecialTokenInfo",
    "SpecialTokenPolicy", "SpecialTokenPolicyError", "SpecialTokens",
    "TEKKEN_PATTERN", "TekkenConfig", "Tekkenizer", "TokenInfo",
    "TokenNotFoundError", "TokenizerError", "TokenizerVersion",
    "TokenizersError", "UnsupportedFormatError",
    "get_deprecated_special_tokens",
]
