"""Deep differential soak: all engines, varied vocabs, varied corpora.

    python -m tekken_tpu_torch.tools.soak [seconds] [--seed S] [--device cpu]

Round after round until ``seconds`` (default 480) have passed: a
synthetic vocabulary of 0, 50, 200, 600 or 1,200 merges (so the cuckoo
pair table and the word map change in size and seeds), a
``PackedEncoder(rows=16, row_len=4096)`` on the device and the native
engine built for it, and 4 batches of up to 16 docs of up to 600 chars
drawn from alphabets holding NBSP, the ideographic space, 'ſ', 'ß', CJK
and emoji.  Every doc's ids from the device and the native engine equal
the oracle's, and the oracle's ids decode back to the doc under RAISE.
One seed draws the same vocabularies and texts as the JAX package's
``tools/soak.py`` (whose seed is fixed at ``SEED``).
"""

from __future__ import annotations

import argparse
import random
import string
import sys
import time

from ..models import build_synthetic_tokenizer
from ..native import NativeEncoder
from ..ops.packed import PackedEncoder
from ..oracle import encode_ranks
from ..special_tokens import SpecialTokenPolicy
from . import first_difference, mismatch_line

SEED = 20260817
MERGE_CHOICES = (0, 50, 200, 600, 1200)

ALPHAS = [
    string.ascii_letters + string.digits + " .,!?'\n\r\t",
    "the quick hello world tokenizer aaaa  123 don't I'm we've ",
    "éü中文русский ſ'sß \U0001f600\U0001f680",
    "'sStT'rReE'vVlLdDmM \t\n\r",
    "".join(chr(c) for c in range(0x20, 0x7F)),
    "\u3000\u2028\u2029\xa0 a1!'",
]

TRAIN_TEXTS = [
    "the quick brown fox jumps over the lazy dog again and again",
    "it's don't you're we've I'm they'll she'd o'clock 'tis",
    "hello world peace tokenizer encoding decoding testing",
    "  whitespace   handling \n newlines \r\n mixed 123 456 789",
    "международный 中文分词 tokenización",
    "aaaa aaaaaaaa abab cdcd xyxy zzzz",
]


def draw_texts(rng: random.Random, max_docs: int = 16,
               max_chars: int = 600) -> list[str]:
    """One batch: 1..max_docs docs of 0..max_chars chars, each from one
    alphabet, in the JAX tool's order of draws."""
    texts = []
    for _ in range(rng.randint(1, max_docs)):
        a = ALPHAS[rng.randrange(len(ALPHAS))]
        texts.append("".join(rng.choice(a)
                             for _ in range(rng.randint(0, max_chars))))
    return texts


def soak_vocab(n_merges: int, rng: random.Random, seed: int, device="cuda",
               n_batches: int = 4, rows: int = 16, row_len: int = 4096,
               max_chars: int = 600):
    """One vocabulary round: a tokenizer of ``n_merges`` BPE merges
    trained on TRAIN_TEXTS and 20 specials, its engines and ``n_batches``
    batches drawn from ``rng``.  Every doc's ids from ``enc`` (a
    PackedEncoder on ``device``) and the native engine are held against
    the oracle's, and the oracle's ids decoded under RAISE against the
    doc.  Returns (tok, enc, batches, mismatch lines)."""
    tok = build_synthetic_tokenizer(num_merges=n_merges,
                                    num_special_tokens=20,
                                    texts=TRAIN_TEXTS, device=device)
    enc = PackedEncoder(tok, rows=rows, row_len=row_len, device=device)
    native = NativeEncoder(tok)
    shift = tok.num_special_tokens()
    batches, bad = [], []
    for _ in range(n_batches):
        texts = draw_texts(rng, rows, max_chars)
        batches.append(texts)
        for t, d, n in zip(texts, enc.encode_batch(texts),
                           native.encode_batch(texts)):
            want = encode_ranks(t, tok.ranks)
            back = tok.decode([r + shift for r in want],
                              SpecialTokenPolicy.RAISE)
            diffs = {"device": first_difference(d, want),
                     "native": first_difference(n, want),
                     "decode": first_difference(back, t)}
            if any(i is not None for i in diffs.values()):
                bad.append(mismatch_line(n_merges, seed, t, diffs))
    return tok, enc, batches, bad


def main(seconds: float = 480.0, seed: int = SEED, device="cuda") -> int:
    deadline = time.time() + seconds
    rng = random.Random(seed)
    rounds = 0
    docs_checked = 0

    while time.time() < deadline:
        n_merges = rng.choice(MERGE_CHOICES)
        _, _, batches, bad = soak_vocab(n_merges, rng, seed, device)
        if bad:
            print("\n".join(bad))
            print(f"SOAK FAILED: {len(bad)} mismatches in vocab round "
                  f"{rounds + 1} (merges={n_merges}, seed={seed})")
            return 1
        docs_checked += sum(len(b) for b in batches)
        rounds += 1
        print(f"[soak] vocab={256 + n_merges} rounds={rounds} "
              f"docs={docs_checked}", flush=True)

    print(f"SOAK OK: {docs_checked} docs across {rounds} vocab rounds")
    return 0


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="python -m tekken_tpu_torch.tools.soak",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("seconds", nargs="?", type=float, default=480.0)
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    sys.exit(main(a.seconds, a.seed, a.device))
