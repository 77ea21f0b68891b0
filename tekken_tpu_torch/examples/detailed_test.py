"""Encode/decode matrix over varied cases + token inspection + byte
census (the counterpart of the repo's ``examples/detailed_test.py``;
reference: examples/detailed_test.rs).

    python -m tekken_tpu_torch.examples.detailed_test [tekken.json] [--device cpu]
"""

import os
import sys

from .. import SpecialTokenPolicy, Tekkenizer
from ..models import build_synthetic_tokenizer
from . import parse

CASES = [
    "Hello, world!",
    "The quick brown fox jumps over the lazy dog.",
    "123 456 789",
    "   spaces   everywhere   ",
    "unicode: 中文 émoji \U0001f600",
    "it's don't can't",
    "line1\nline2\r\nline3",
    "",
]


def main(argv=None) -> int:
    args = parse(__doc__, "detailed_test", argv)
    tok = (Tekkenizer.from_file(args.path, device=args.device)
           if os.path.exists(args.path)
           else build_synthetic_tokenizer(device=args.device, num_merges=300))

    for text in CASES:
        ids = tok.encode(text, False, False)
        rt = tok.decode(ids, SpecialTokenPolicy.IGNORE)
        status = "OK " if rt == text else "FAIL"
        print(f"[{status}] {len(ids):3d} tokens  {text!r}")
        if rt != text:
            print("   round-trip mismatch:", repr(rt))

    # byte-token census (reference: detailed_test.rs byte-token section)
    ns = tok.num_special_tokens()
    byte_ids = [i for i in range(tok.vocab_size()) if tok.is_byte(i)]
    print(f"\nbyte tokens: {len(byte_ids)} "
          f"(ids {ns}..{ns + 255})")
    sample = tok.encode("abc", False, False)
    print("'abc' pieces:", [tok.id_to_byte_piece(t, SpecialTokenPolicy.KEEP)
                            for t in sample])
    return 0


if __name__ == "__main__":
    sys.exit(main())
