"""Full demo: text + audio tokenization end to end (the counterpart of
the repo's ``examples/basic_usage.py``; reference:
examples/basic_usage.rs:56-147).  Loads ``tekken.json`` if present,
otherwise builds a synthetic audio-enabled tokenizer, then demonstrates
encode/decode with all policies and audio tokenization.

    python -m tekken_tpu_torch.examples.basic_usage [tekken.json] [--device cpu]
"""

import os
import sys

import numpy as np

from .. import Audio, SpecialTokenPolicy, Tekkenizer
from ..models import build_synthetic_tokenizer
from . import parse


def get_tokenizer(path: str, device) -> Tekkenizer:
    if os.path.exists(path):
        print(f"loading {path}")
        return Tekkenizer.from_file(path, device=device)
    print("no tekken.json found — building a synthetic audio-enabled "
          "tokenizer (24kHz, 12.5 fps, 128 mels, 1s chunks)")
    return build_synthetic_tokenizer(
        device=device, num_merges=300, num_special_tokens=20,
        with_audio=True, sampling_rate=24000, frame_rate=12.5,
        num_mel_bins=128, hop_length=160, window_size=400,
        chunk_length_s=1.0)


def main(argv=None) -> int:
    args = parse(__doc__, "basic_usage", argv)
    tok = get_tokenizer(args.path, args.device)
    print(f"vocab_size={tok.vocab_size()} specials={tok.num_special_tokens()}"
          f" version={tok.version().as_str()} audio={tok.has_audio_support()}")

    text = "Hello, world! This is the Tekken tokenizer."
    ids = tok.encode(text, True, True)
    print(f"\nencode({text!r}) -> {len(ids)} tokens")
    print(" ids:", ids)
    print(" keep:  ", repr(tok.decode(ids, SpecialTokenPolicy.KEEP)))
    print(" ignore:", repr(tok.decode(ids, SpecialTokenPolicy.IGNORE)))

    print("\nper-token pieces:")
    for t in ids[:12]:
        print(f"  {t:6d} -> {tok.id_to_piece(t)!r}"
              f"  special={tok.is_special_token(t)} byte={tok.is_byte(t)}")

    if tok.has_audio_support():
        sr = tok.audio_config().sampling_rate
        t = np.arange(int(sr * 2.5)) / sr
        wave = (0.4 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
        enc = tok.encode_audio(Audio.new(wave, sr))
        print(f"\naudio: 2.5s sine -> {len(enc.tokens)} tokens "
              f"(first={tok.id_to_piece(enc.tokens[0])!r}, padded to "
              f"{len(enc.audio.audio_array)} samples)")
        mixed = (tok.encode("Listen: ", True, False) + enc.tokens
                 + tok.encode(" transcribed.", False, True))
        print("mixed text+audio stream:",
              repr(tok.decode(mixed, SpecialTokenPolicy.KEEP))[:120], "...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
