"""Minimal load/encode/decode example (the counterpart of the repo's
``examples/basic_tokenizer_test.py``; reference:
examples/basic_tokenizer_test.rs).

    python -m tekken_tpu_torch.examples.basic_tokenizer_test [tekken.json] [--device cpu]
"""

import os
import sys

from .. import SpecialTokenPolicy, Tekkenizer
from ..models import build_synthetic_tokenizer
from . import parse


def main(argv=None) -> int:
    args = parse(__doc__, "basic_tokenizer_test", argv)
    tok = (Tekkenizer.from_file(args.path, device=args.device)
           if os.path.exists(args.path)
           else build_synthetic_tokenizer(device=args.device))

    text = "Hello world!"
    ids = tok.encode(text, True, True)
    print("tokens:", ids)
    print("decoded:", tok.decode(ids, SpecialTokenPolicy.IGNORE))
    if tok.decode(ids, SpecialTokenPolicy.IGNORE) != text:
        raise AssertionError(f"{text!r} does not round-trip")
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
