"""Cross-engine differential fuzz: oracle vs packed vs flat vs native.

    python -m tekken_tpu_torch.tools.fuzz_all_engines [n_batches] [--seed S] [--device cpu]

A synthetic vocabulary of 400 merges and 20 specials; ``n_batches``
(default 20) batches of up to 32 docs of up to 500 chars, each doc from
one of six alphabets; every doc through ``PackedEncoder`` and
``FlatEncoder`` (32 x 1024, on the device) and the native engine, held
against the oracle.  One seed draws the same texts as the JAX package's
``tools/fuzz_all_engines.py``.
"""

from __future__ import annotations

import argparse
import random
import string
import sys

from ..models import build_synthetic_tokenizer
from ..native import NativeEncoder
from ..ops.flat import FlatEncoder
from ..ops.packed import PackedEncoder
from ..oracle import encode_ranks
from . import first_difference, mismatch_line

N_MERGES = 400

ALPHABETS = [
    string.ascii_letters + string.digits + " .,!?'\n\r\t",
    "the quick hello world tokenizer aaaa  123 don't ",
    "éü中文ру ſ'sß \U0001f600",
    "'sStT'rReE'vVlLdDmM \t\n",
    "1234567890 .,;:!?",
    "\u3000\u2028\u2029\xa0 a1!'",
]


def draw_batch(rng: random.Random, b: int) -> list[str]:
    """Batch ``b``: 1..32 docs of 0..500 chars, doc i from alphabet
    (b + i) mod 6, in the JAX tool's order of draws."""
    texts = []
    for i in range(rng.randint(1, 32)):
        a = ALPHABETS[(b + i) % len(ALPHABETS)]
        texts.append("".join(rng.choice(a)
                             for _ in range(rng.randint(0, 500))))
    return texts


def main(n_batches: int = 20, seed: int = 0, device="cuda") -> int:
    rng = random.Random(seed)
    tok = build_synthetic_tokenizer(num_merges=N_MERGES,
                                    num_special_tokens=20, device=device)
    enc = PackedEncoder(tok, rows=32, row_len=1024, device=device)
    flat = FlatEncoder(tok, rows=32, row_len=1024, device=device)
    native = NativeEncoder(tok)

    bad = 0
    checked = 0
    for b in range(n_batches):
        texts = draw_batch(rng, b)
        dev = enc.encode_batch(texts)
        flt = flat.encode_batch(texts)
        nat = native.encode_batch(texts)
        for t, d, f, n in zip(texts, dev, flt, nat):
            want = encode_ranks(t, tok.ranks)
            checked += 1
            diffs = {"packed": first_difference(d, want),
                     "flat": first_difference(f, want),
                     "native": first_difference(n, want)}
            if any(i is not None for i in diffs.values()):
                bad += 1
                print(mismatch_line(N_MERGES, seed, t, diffs))
    print(f"checked {checked} docs across {n_batches} batches; bad {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    p = argparse.ArgumentParser(
        prog="python -m tekken_tpu_torch.tools.fuzz_all_engines",
        description=__doc__.split("\n\n")[0])
    p.add_argument("n_batches", nargs="?", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    sys.exit(main(a.n_batches, a.seed, a.device))
