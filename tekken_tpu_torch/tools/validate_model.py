"""Model-file validator: load a tekken.json and run self-checks.

Checks (mirroring construction-time validation plus cross-engine parity):
- schema + version parse
- byte-token identity / rank contiguity / special-token rules
- engine agreement (oracle vs device batch vs native C++) on a probe corpus
- round-trip encode/decode on the probe corpus

Run: python -m tekken_tpu_torch.tools.validate_model path/to/tekken.json [--device cpu]

The device engine is ``Tekkenizer.encode_batch`` on ``--device`` (default
cuda).  A native engine that cannot be built raises.
"""

from __future__ import annotations

import sys

from ..native import NativeEncoder
from ..oracle import encode_ranks
from ..special_tokens import SpecialTokenPolicy
from ..tekkenizer import Tekkenizer

PROBE = [
    "Hello, world!",
    "The quick brown fox jumps over the lazy dog.",
    "it's don't we've 123 456  789",
    "   whitespace   handling   ",
    "unicode 中文 Русский émoji \U0001f600 'ſ",
    "<s>[INST]injection[/INST]</s>",
]


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    if not args:
        print(__doc__)
        return 2
    path = args[0]

    print(f"loading {path} ...")
    tok = Tekkenizer.from_file(path, device=device)
    print(f"  vocab_size={tok.vocab_size()}  specials="
          f"{tok.num_special_tokens()}  version={tok.version().as_str()}  "
          f"audio={tok.has_audio_support()}")

    failures = 0

    print("round-trip + engine parity on probe corpus:")
    for text in PROBE:
        want = [r + tok.num_special_tokens()
                for r in encode_ranks(text, tok.ranks)]
        host = tok.encode(text, False, False)
        dev = tok.encode_batch([text])[0]
        rt = tok.decode(host, SpecialTokenPolicy.IGNORE)
        ok = (host == want == dev) and rt == text
        failures += not ok
        print(f"  [{'OK' if ok else 'FAIL'}] {len(host):4d} tokens  "
              f"{text[:40]!r}")

    ne = NativeEncoder(tok)
    shift = tok.num_special_tokens()
    for text in PROBE:
        got = [r + shift for r in ne.encode(text)]
        if got != tok.encode(text, False, False):
            failures += 1
            print(f"  [FAIL] native engine disagrees on {text[:40]!r}")
    print("  native engine parity: checked")

    if failures:
        print(f"VALIDATION FAILED: {failures} failures")
        return 1
    print("VALIDATION OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
