"""The native C++ host engine of the port (ctypes).

A copy of the JAX package's engine: the Tekken pre-tokenizer and BPE merge
in C++, for the host side of the pipeline (single-string encode, the host
merge of the packed encode's miss spans, the overflow-row re-encode, and
``encode_batch`` over threads).  g++ builds it into
``tekken_tpu_torch/_build/`` the first time a ``NativeEncoder`` is made
(``python -m tekken_tpu_torch.native.build`` builds it ahead); a failed
build raises with g++'s output.
"""

from .engine import NativeEncoder

__all__ = ["NativeEncoder"]
