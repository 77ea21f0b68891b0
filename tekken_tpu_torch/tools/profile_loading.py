"""Stepwise model-loading profile.

Mirrors the reference's profiling tests (reference:
tests/test_profile_loading.rs, tests/test_detailed_profile.rs): times each
stage of tokenizer construction — file read, JSON parse, base64 vocab
decode + validation, pair-table builds, the upload of the device tables —
at full 131k-vocab scale.

    python -m tekken_tpu_torch.tools.profile_loading [path/to/tekken.json] [--device cpu]

Without a model file it first writes the bench vocabulary (130,872 ranks,
1,000 specials) to a ``tekken.json`` in a temporary directory.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from ..config import ModelData, TekkenConfig, parse_version
from ..models import bench_words, build_bench_vocab
from ..special_tokens import get_deprecated_special_tokens
from ..tekkenizer import Tekkenizer
from ..utils.timing import StageTimer
from ..vocab import PairTable


def _bench_model_file(path: str) -> None:
    vocab = build_bench_vocab(bench_words())
    md = ModelData(
        vocab=vocab,
        config=TekkenConfig(pattern=".*", num_vocab_tokens=len(vocab),
                            default_vocab_size=len(vocab) + 1000,
                            default_num_special_tokens=1000, version="v7"),
        special_tokens=get_deprecated_special_tokens(),
    )
    with open(path, "w") as f:
        f.write(md.to_json())


def profile(path: str, device="cuda") -> StageTimer:
    """The stages of loading ``path`` and readying it for the device."""
    timer = StageTimer()
    with timer.stage("file read"):
        with open(path) as f:
            content = f.read()
    print(f"model file: {len(content)/1e6:.1f} MB")

    with timer.stage("JSON parse + schema"):
        md = ModelData.from_json(content)

    with timer.stage("Tekkenizer construction"):
        tok = Tekkenizer(
            vocab=md.vocab,
            special_tokens=(md.special_tokens
                            or get_deprecated_special_tokens()),
            pattern=md.config.pattern,
            vocab_size=md.config.default_vocab_size,
            num_special_tokens=md.config.default_num_special_tokens,
            version=parse_version(md.config.version),
            audio_config=md.audio,
            device=device,
        )

    with timer.stage("pair table (linear probe)"):
        PairTable.build(tok.ranks)

    with timer.stage("pair table (cuckoo)"):
        tok.cuckoo_table()

    with timer.stage("word map"):
        tok.word_map()

    # the copy of the encode tables to the device
    with timer.stage("device tables upload"):
        tok.device_tables(device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    with timer.stage("first encode (host engine)"):
        tok.encode("The quick brown fox jumps over the lazy dog.", True, True)
    return timer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tekken_tpu_torch.tools.profile_loading",
        description=__doc__.split("\n\n")[0])
    p.add_argument("model", nargs="?", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        path = args.model
        if path is None or not os.path.exists(path):
            print("no model file given — synthesizing 131k-scale tekken.json")
            path = os.path.join(tmp, "tekken.json")
            _bench_model_file(path)
        timer = profile(path, args.device)
    print()
    print(timer.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
