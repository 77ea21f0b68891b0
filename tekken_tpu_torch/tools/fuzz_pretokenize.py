"""Differential fuzz: vectorized pretokenizer vs the regex-module oracle.

    python -m tekken_tpu_torch.tools.fuzz_pretokenize [--smoke] [--seed S] [--device cpu]

The hand cases and ``n_random`` (4,000; 400 with ``--smoke``) random
texts of 0..48 chars through ``ops.pretokenize.pretokenize_vec`` on the
device, each held against ``oracle.pretokenize``.  One seed draws the
same texts as the JAX package's ``tools/fuzz_pretokenize.py``.
"""

from __future__ import annotations

import argparse
import random
import string
import sys

from ..ops.pretokenize import pretokenize_vec
from ..oracle import pretokenize
from . import first_difference

HAND_CASES = [
    "Hello, world!", "  word", "   whitespace   handling   ", "it's", "you're",
    "1234", "a\n\nb", "x!word", "x!!word", " !word", "'s", "'step", "'rx",
    "don'tre", "IT'S", "'ſ", "a ' b", "!!\n!!", "a\r\nb", "\n\n   word",
    "x\t's", " 's", "tab\there", "a \n b", "1's", "'ll", "'llow", "'l", "'",
    "", "x", " ", "\n", "é中1a!", "!\n\n \nx", "a  12", "  123,456",
    "\xa0\u2028x", "　　ｗ", "ßs'ß", "'K", "ſ'ſ",
]

ALPHAS = [
    string.ascii_letters + string.digits + " .,!?'\n\r\t",
    "ab 12 !? '\n",
    " \t\n\r'sStTrReEvVlLdDmM",
    "éü中文руſ 'sKKß",
    "".join(chr(c) for c in range(0x20, 0x7f)),
    "\xa0\u2000\u2028\u2029\u3000 a1!'",
]


def draw_cases(n_random: int, seed: int) -> list[str]:
    """The hand cases, then ``n_random`` texts of 0..48 chars, text i from
    alphabet i mod 6."""
    rng = random.Random(seed)
    cases = list(HAND_CASES)
    for i in range(n_random):
        a = ALPHAS[i % len(ALPHAS)]
        cases.append("".join(rng.choice(a) for _ in range(rng.randint(0, 48))))
    return cases


def main(n_random: int = 4000, seed: int = 0, device="cuda") -> int:
    """The count of mismatching cases (0 when all agree)."""
    cases = draw_cases(n_random, seed)
    bad = 0
    for t in cases:
        want = pretokenize(t)
        got = pretokenize_vec(t, device=device)
        if want != got:
            bad += 1
            print(f"MISMATCH seed={seed} doc={t!r} first differing piece: "
                  f"pretokenize_vec {first_difference(got, want)}")
            print("  want", want)
            print("  got ", got)
    print("checked", len(cases), "bad", bad)
    return bad


if __name__ == "__main__":
    p = argparse.ArgumentParser(
        prog="python -m tekken_tpu_torch.tools.fuzz_pretokenize",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    sys.exit(1 if main(400 if a.smoke else 4000, a.seed, a.device) else 0)
