"""Audio tokenization demo with a JSON result dump (the counterpart of
the repo's ``examples/audio_tokenization_test.py``; reference:
examples/audio_tokenization_test.rs).  Writes
``audio_tokenization_results.json`` in the working directory.

    python -m tekken_tpu_torch.examples.audio_tokenization_test [audio.wav] [--device cpu]
"""

import json
import os
import sys

import numpy as np

from .. import Audio, SpecialTokenPolicy
from ..models import build_synthetic_tokenizer
from . import parse


def main(argv=None) -> int:
    args = parse(__doc__, "audio_tokenization_test", argv, path=None,
                 path_help="a WAV file (default: a synthetic tone)")
    tok = build_synthetic_tokenizer(
        device=args.device, num_merges=200, num_special_tokens=20,
        with_audio=True, chunk_length_s=1.0)

    if args.path and os.path.exists(args.path):
        audio = Audio.from_file(args.path)
        name = args.path
    else:
        sr = tok.audio_config().sampling_rate
        t = np.arange(int(sr * 3.2)) / sr
        audio = Audio.new(0.3 * np.sin(2 * np.pi * 220.0 * t), sr)
        name = "synthetic 3.2s 220Hz tone"

    print(f"audio: {name}: {len(audio.audio_array)} samples @ "
          f"{audio.sampling_rate} Hz ({audio.duration():.2f}s)")

    enc = tok.encode_audio(audio)
    print(f"-> {len(enc.tokens)} tokens "
          f"(1 x BEGIN_AUDIO + {len(enc.tokens)-1} x AUDIO)")

    text_ids = tok.encode("Transcribe this: ", True, False)
    mixed = text_ids + enc.tokens
    print("mixed stream (KEEP):",
          repr(tok.decode(mixed, SpecialTokenPolicy.KEEP))[:100], "...")

    results = {
        "audio": {"samples": len(enc.audio.audio_array),
                  "sampling_rate": enc.audio.sampling_rate,
                  "duration_s": enc.audio.duration()},
        "tokens": {"count": len(enc.tokens),
                   "begin_audio_id": enc.tokens[0],
                   "audio_token_id": enc.tokens[1] if len(enc.tokens) > 1
                   else None},
    }
    out = "audio_tokenization_results.json"
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print("results written to", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
