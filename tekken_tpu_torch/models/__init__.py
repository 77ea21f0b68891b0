"""Model-file builders: synthetic vocabularies and BPE training (copies of
the JAX package's).

The reference ships a 131k-entry V7 ``tekken.json`` test asset (stripped from
this checkout — reference: .MISSING_LARGE_BLOBS) plus a synthetic small-vocab
fixture (reference: tests/test_small_vocab.rs:7-95, examples/basic_usage.rs:56-147).
This package recreates both: byte-level base vocabs, BPE-trained merge vocabs,
and audio-enabled synthetic models, all emitting the exact ``tekken.json``
schema (reference: src/config.rs:73-82).  ``bench`` holds the bench
configuration's word list, vocabulary and corpus builders.
"""

from .bench import (bench_tokenizer, bench_words, build_bench_vocab,
                    build_corpus)
from .synthetic import (
    build_synthetic_model_data,
    build_synthetic_tokenizer,
    train_bpe_vocab,
)

__all__ = [
    "bench_tokenizer",
    "bench_words",
    "build_bench_vocab",
    "build_corpus",
    "build_synthetic_model_data",
    "build_synthetic_tokenizer",
    "train_bpe_vocab",
]
