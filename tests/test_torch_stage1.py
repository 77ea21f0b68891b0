"""PyTorch port: the boundary rules and the plain version of the stage-1
kernel equal the JAX package's functions exactly (the JAX Pallas kernel
runs in interpret mode on the CPU)."""

import random
import string

import numpy as np
import pytest
import torch

from tekken_tpu_torch.ops import pretokenize as tpre
from tekken_tpu_torch.ops.stage1 import stage1_compact, stage1_compact_reference

SIMPLE_CASES = [
    "hello world", "it's a test 123", "don't we've I'm you'll",
    "a1b2c3", "x!word", " !word", "123 456 789", "a\nb\nc", "w,x.y!z?",
    "'s 't 'll 'd", "end.", "a b c d", "Hello, World! 99 bottles",
    "tab\there", "semi;colon:colon", "9.99 price", "(paren) [brack]",
]

UTF8_CASES = [
    "unicode: café naïve 中文 \U0001f600", "Русский текст и עברית",
    "mixed ascii and 日本語 words", "emoji runs \U0001f600\U0001f601",
    "it'ſ don'T we'RE", "a\x1c\x1cb", "   whitespace   handling   ",
    "12345 6", "a\n\n  b", "\n\t\r  spaces 　", "ü", "",
    "tricky   runs  12345 et café", "x'ſy 'ſ's", "٣٤٥٦ ١٢",
]


def _rows(texts, R):
    buf = np.zeros((len(texts), R), np.uint8)
    lens = np.zeros(len(texts), np.int32)
    for i, t in enumerate(texts):
        d = t.encode("utf-8")[:R]
        buf[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return buf, lens


def _adversarial_ascii(seed, n_rows, L):
    """Runs of whitespace, digits, letters, contractions, punctuation and
    newlines (tests/test_pallas_stage1.py's generator)."""
    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(n_rows):
        n = int(rng.integers(0, L - 8))
        chars: list[int] = []
        while len(chars) < n:
            kind = rng.integers(0, 6)
            rl = int(rng.integers(1, 6))
            if kind == 0:
                chars += [int(rng.choice([9, 10, 13, 32]))] * rl
            elif kind == 1:
                chars += [int(x) for x in rng.integers(48, 58, rl)]
            elif kind == 2:
                chars += [int(x) for x in rng.integers(97, 123, rl)]
            elif kind == 3:
                chars += [39] + [int(rng.choice(
                    [ord(c) for c in "strelvmdSTRELVMD"])) for _ in range(rl)]
            elif kind == 4:
                chars += [int(rng.choice([33, 44, 46, 59, 10, 13]))
                          for _ in range(rl)]
            else:
                chars += [int(x) for x in rng.integers(32, 127, rl)]
        texts.append(bytes(chars[:n]).decode("ascii"))
    return texts


def _simple_texts(rng, n, max_len):
    alpha = string.ascii_letters
    out = []
    for _ in range(n):
        parts = []
        for _ in range(rng.randint(0, max_len // 5)):
            w = "".join(rng.choice(alpha) for _ in range(rng.randint(1, 9)))
            if rng.random() < 0.2:
                w += str(rng.randint(0, 999))
            if rng.random() < 0.2:
                w += rng.choice(".,!?;:'")
            parts.append(w)
        out.append(" ".join(parts)[:max_len])
    return out


def _utf8_texts(rng, n, max_chars):
    alpha = (string.ascii_letters + string.digits + " .,!?'\n\r\t"
             + "中文日本語éüſ\U0001f600٣")
    return ["".join(rng.choice(alpha) for _ in range(rng.randint(0, max_chars)))
            for _ in range(n)]


def test_ascii_classes_match_jax():
    from tekken_tpu.ops.pretokenize import ascii_classes_arith

    b = np.arange(256, dtype=np.uint8)
    want = np.asarray(ascii_classes_arith(b, out_dtype=np.int32))
    got = tpre.ascii_classes_arith(torch.from_numpy(b)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[:128], tpre.unicode_packed_table()[:128])


@pytest.mark.parametrize("rules", ["simple", "general"])
def test_ascii_rules_match_jax(rules):
    import jax
    import jax.numpy as jnp

    from tekken_tpu.ops.pretokenize import (_char_boundaries_general,
                                            _char_boundaries_simple,
                                            ascii_classes_arith)

    R = 256
    rng = random.Random(41)
    if rules == "simple":
        alpha = string.ascii_letters + "019.,!?';:()" + " \t\n"
        texts = SIMPLE_CASES + ["".join(rng.choice(alpha) for _ in range(
            rng.randint(1, 80))) for _ in range(40)]
        fn = _char_boundaries_simple
    else:
        texts = SIMPLE_CASES + _adversarial_ascii(123, 60, R)
        fn = _char_boundaries_general
    buf, lens = _rows(texts, R)
    jb = jnp.asarray(buf.astype(np.int32))
    valid = jnp.arange(R)[None, :] < jnp.asarray(lens)[:, None]
    want = np.asarray(jax.jit(fn)(jb, valid, ascii_classes_arith(
        jb, out_dtype=jnp.int32)))
    got = tpre.ascii_boundaries(torch.from_numpy(buf), torch.from_numpy(lens),
                                rules).numpy()
    assert np.array_equal(got, want), np.argwhere(got != want)[:5]


def test_general_rules_refuse_long_rows():
    with pytest.raises(ValueError, match="8192"):
        tpre.ascii_boundaries(torch.zeros((1, 16384), dtype=torch.uint8),
                              torch.zeros(1, dtype=torch.int32), "general")


def test_byte_boundaries_match_jax():
    import jax
    import jax.numpy as jnp

    from tekken_tpu.ops.pretokenize import byte_boundaries

    R = 256
    texts = UTF8_CASES + _utf8_texts(random.Random(9), 40, 90)
    buf, lens = _rows(texts, R)
    want = np.asarray(jax.jit(jax.vmap(byte_boundaries))(
        jnp.asarray(buf), jnp.asarray(lens)))
    got = tpre.byte_boundaries(torch.from_numpy(buf),
                               torch.from_numpy(lens)).numpy()
    assert np.array_equal(got, want), np.argwhere(got != want)[:5]


def _stage1_inputs(rules, B=8, R=128):
    rng = random.Random({"simple": 5, "general": 6, "external": 7}[rules])
    if rules == "simple":
        texts = _simple_texts(rng, B, R - 8)
    elif rules == "general":
        texts = _adversarial_ascii(77, B - 2, R) + ["a1" * 60, ""]
    else:
        texts = _utf8_texts(rng, B - 2, 35) + ["x" * R, "é"]
    return _rows(texts, R)


@pytest.mark.parametrize("n_words", [0, 3, 6])
@pytest.mark.parametrize("rules", ["simple", "general", "external"])
def test_stage1_reference_matches_pallas(rules, n_words):
    import jax
    import jax.numpy as jnp

    from tekken_tpu.ops.pallas_stage1 import stage1_compact as jax_stage1
    from tekken_tpu.ops.pretokenize import byte_boundaries

    buf, lens = _stage1_inputs(rules)
    wsize, wseed = (1 << 14, 77) if n_words else (1, 0)
    jb, jl = jnp.asarray(buf), jnp.asarray(lens)
    tb, tl = torch.from_numpy(buf), torch.from_numpy(lens)
    kw, tkw = {}, {}
    if rules == "external":
        kw["boundary"] = jax.vmap(byte_boundaries)(jb, jl)
        tkw["boundary"] = tpre.byte_boundaries(tb, tl)
    want = [np.asarray(x) for x in jax_stage1(
        jb, jl, n_words, wsize, wseed, rules=rules, **kw)]
    got = stage1_compact_reference(tb, tl, n_words, wsize, wseed,
                                   rules=rules, **tkw)
    assert len(got) == len(want) == 4 + max(n_words, 1)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w), (k, np.argwhere(g.numpy() != w)[:5])
    # the wrapper takes the plain version for CPU tensors
    wrapped = stage1_compact(tb, tl, n_words, wsize, wseed, rules=rules, **tkw)
    for g, w in zip(wrapped, got):
        assert torch.equal(g, w)


def test_stage1_long_pieces_and_dense_rows():
    """One piece spanning a whole row, rows of single-byte pieces, and rows
    ending mid-piece: piece lengths equal the oracle's pieces, and every
    lane past the count is -1."""
    from tekken_tpu_torch.oracle import pretokenize

    R = 64
    texts = ["a" * 64, "a1" * 32, "ab cd", "", " " * 5, "x  \n\n  y"]
    buf, lens = _rows(texts, R)
    st, pl, sl, w0, cnt = stage1_compact_reference(
        torch.from_numpy(buf), torch.from_numpy(lens), 0, 1, 0,
        rules="general")
    for r, t in enumerate(texts):
        want = [len(p.encode()) for p in pretokenize(t)]
        k = len(want)
        assert cnt[r] == k
        assert pl[r, :k].tolist() == want
        assert st[r, :k].tolist() == np.cumsum([0] + want[:-1]).tolist()[:k]
        for a in (st, pl, sl, w0):
            assert (a[r, k:] == -1).all()
    assert w0[2, 0] == int.from_bytes(b"ab", "little")
