"""Synthetic model builders and a minimal BPE trainer (a copy of the JAX
package's models/synthetic.py: the same arguments give the same
``tekken.json``, tests/test_torch_synthetic.py).

Used as the test substrate: the reference's real V7 asset is stripped from its
checkout, so conformance here is pinned by differential testing over synthetic
vocabularies that obey the Tekken model-file invariants
(byte tokens at ranks 0..255, contiguous ranks — reference:
src/tekkenizer.rs:792-813).

``train_bpe_vocab`` trains real merge rules (greedy most-frequent-pair, the
standard BPE procedure) so the merge kernels are exercised with deep merge
trees, not just byte passthrough.
"""

from __future__ import annotations

import base64
from collections import Counter
from typing import Optional

from ..audio import AudioConfig, AudioSpectrogramConfig
from ..config import ModelData, TekkenConfig, TokenInfo, parse_version
from ..oracle import pretokenize
from ..special_tokens import SpecialTokenInfo, SpecialTokens
from ..tekkenizer import Tekkenizer


def _byte_token_infos() -> list[TokenInfo]:
    return [
        TokenInfo(rank=i,
                  token_bytes=base64.b64encode(bytes([i])).decode("ascii"),
                  token_str=None)
        for i in range(256)
    ]


def train_bpe_vocab(texts: list[str], num_merges: int) -> list[TokenInfo]:
    """Train ``num_merges`` BPE merges over ``texts``; returns a vocab of
    256 + num_merges entries in rank order (byte tokens first)."""
    # piece frequency table over the Tekken pre-tokenization
    word_counts: Counter = Counter()
    for text in texts:
        for piece in pretokenize(text):
            word_counts[piece.encode("utf-8")] += 1

    # each word as a list of current token byte-strings
    words = [([bytes([b]) for b in w], c) for w, c in word_counts.items()]
    vocab: list[bytes] = [bytes([i]) for i in range(256)]

    for _ in range(num_merges):
        pair_counts: Counter = Counter()
        for segs, c in words:
            for a, b in zip(segs, segs[1:]):
                pair_counts[(a, b)] += c
        if not pair_counts:
            break
        # deterministic: highest count, then lexicographically smallest pair
        best = min(pair_counts.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        merged = best[0] + best[1]
        if merged in set(vocab):
            # already a token (possible when corpora repeat); skip this pair
            # by removing it from contention via a no-op merge application
            pass
        else:
            vocab.append(merged)
        new_words = []
        for segs, c in words:
            out = []
            i = 0
            while i < len(segs):
                if i + 1 < len(segs) and segs[i] == best[0] and segs[i + 1] == best[1]:
                    out.append(merged)
                    i += 2
                else:
                    out.append(segs[i])
                    i += 1
            new_words.append((out, c))
        words = new_words

    return [
        TokenInfo(rank=r, token_bytes=base64.b64encode(b).decode("ascii"),
                  token_str=None)
        for r, b in enumerate(vocab)
    ]


DEFAULT_TRAINING_TEXT = [
    "hello world hello there world peace hello hello world",
    "the quick brown fox jumps over the lazy dog. the the the and and",
    "tokenizer tokenization encoding decoding testing tester tested",
    "  whitespace   handling   with   spaces  and\nnewlines\r\n mixed",
    "numbers 123 456 789 0123456789 and symbols !@#$%^&*() 'tis 'twas",
    "it's don't you're we've I'm they'll she'd o'clock",
    "Intern international internet interface integer introduction",
    "aaaa aaaaaaaa aaaaaaaaaaaaaaaa bbbb cccc abab cdcd",
]


def build_synthetic_model_data(
    num_merges: int = 300,
    num_special_tokens: int = 20,
    texts: Optional[list[str]] = None,
    with_audio: bool = False,
    sampling_rate: int = 16000,
    frame_rate: float = 12.5,
    num_mel_bins: int = 80,
    hop_length: int = 160,
    window_size: int = 400,
    chunk_length_s: Optional[float] = None,
    version: str = "v7",
) -> ModelData:
    """Build a full synthetic ``ModelData`` (tekken.json equivalent).

    Shape mirrors the reference's synthetic fixtures
    (reference: tests/test_small_vocab.rs:7-95 — 256 byte tokens + merges +
    named specials; examples/basic_usage.rs:56-147 for the audio-enabled
    variant).
    """
    vocab = (train_bpe_vocab(texts if texts is not None else DEFAULT_TRAINING_TEXT,
                             num_merges)
             if num_merges > 0 else _byte_token_infos())

    special = [
        SpecialTokenInfo(rank=0, token_str=SpecialTokens.UNK.as_str(), is_control=True),
        SpecialTokenInfo(rank=1, token_str=SpecialTokens.BOS.as_str(), is_control=True),
        SpecialTokenInfo(rank=2, token_str=SpecialTokens.EOS.as_str(), is_control=True),
        SpecialTokenInfo(rank=3, token_str=SpecialTokens.BEGIN_INST.as_str(), is_control=True),
        SpecialTokenInfo(rank=4, token_str=SpecialTokens.END_INST.as_str(), is_control=True),
        SpecialTokenInfo(rank=5, token_str=SpecialTokens.PAD.as_str(), is_control=True),
    ]
    if with_audio:
        special.append(SpecialTokenInfo(
            rank=6, token_str=SpecialTokens.AUDIO.as_str(), is_control=True))
        special.append(SpecialTokenInfo(
            rank=7, token_str=SpecialTokens.BEGIN_AUDIO.as_str(), is_control=True))
        special.append(SpecialTokenInfo(
            rank=8, token_str=SpecialTokens.TRANSCRIBE.as_str(), is_control=True))

    vocab_size = len(vocab) + num_special_tokens

    audio = None
    if with_audio:
        audio = AudioConfig(
            sampling_rate=sampling_rate,
            frame_rate=frame_rate,
            audio_encoding_config=AudioSpectrogramConfig(
                num_mel_bins=num_mel_bins,
                hop_length=hop_length,
                window_size=window_size,
            ),
            chunk_length_s=chunk_length_s,
        )

    config = TekkenConfig(
        pattern=".*",  # carried but ignored, like the reference (src/tekkenizer.rs:74)
        num_vocab_tokens=len(vocab),
        default_vocab_size=vocab_size,
        default_num_special_tokens=num_special_tokens,
        version=version,
    )
    return ModelData(vocab=vocab, config=config, special_tokens=special, audio=audio)


def build_synthetic_tokenizer(device="cuda", **kwargs) -> Tekkenizer:
    """Convenience: synthetic ModelData -> Tekkenizer on ``device`` (the
    other arguments are build_synthetic_model_data's)."""
    md = build_synthetic_model_data(**kwargs)
    return Tekkenizer(
        vocab=md.vocab,
        special_tokens=md.special_tokens,
        pattern=md.config.pattern,
        vocab_size=md.config.default_vocab_size,
        num_special_tokens=md.config.default_num_special_tokens,
        version=parse_version(md.config.version),
        audio_config=md.audio,
        device=device,
    )
