"""PyTorch port: the differential boundary formulations of
ops/pretokenize.py — ``pretokenize_vec``, ``byte_boundaries_via_chars``,
``_char_boundaries``, ``ascii_packed_lookup`` and the two ASCII row
functions — against the oracle, the JAX package's and the port's own
formulations.  Flags and strings: the tolerance is exact equality."""

import random
import string

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tekken_tpu.ops.pretokenize as jpre
from tekken_tpu.oracle import pretokenize
from tekken_tpu_torch.ops.pretokenize import (
    _char_boundaries, _char_boundaries_general, ascii_classes_arith,
    ascii_packed_lookup, byte_boundaries, byte_boundaries_ascii,
    byte_boundaries_ascii_simple, byte_boundaries_via_chars, pretokenize_vec)
from test_device_path import PRETOK_CASES


@pytest.mark.parametrize("text", PRETOK_CASES)
def test_pretokenize_vec_matches_oracle_and_jax(text):
    got = pretokenize_vec(text, device="cpu")
    assert got == pretokenize(text)
    assert got == jpre.pretokenize_vec(text)


@pytest.mark.parametrize("chunk", range(4))
def test_pretokenize_vec_fuzz(chunk):
    """200 seeded strings, 50 a chunk."""
    rng = random.Random(99 + chunk)
    alpha = string.ascii_letters + string.digits + " .,!?'\n\r\t" + "é中ſ　😀"
    for _ in range(50):
        t = "".join(rng.choice(alpha) for _ in range(rng.randint(0, 60)))
        got = pretokenize_vec(t, device="cpu")
        assert got == pretokenize(t), repr(t)
        assert got == jpre.pretokenize_vec(t), repr(t)


def _rows(texts, L):
    buf = np.zeros((len(texts), L), np.uint8)
    lens = np.zeros(len(texts), np.int32)
    for i, t in enumerate(texts):
        d = t.encode("utf-8")[:L]
        buf[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return buf, lens


def test_byte_boundaries_via_chars():
    """The pool of the JAX package's direct-vs-chars test: the port's char
    compaction equals its byte-level rules and the JAX package's
    compaction, row for row."""
    rng = random.Random(42)
    pool = ("abc DEF 123 45678  \t\n\r 中文漢字 ñé ſ ' 's 're 'll !?.,;:"
            "     \U0001F600 ٠١٢٣ ")
    cases = ["", "it's a test", "'ſ fold", "a'ſ b", "it'ſ x",
             "don't we've it'll they're", "٠١٢٣٤٥٦٧ nums",
             "a b", "  \n\n  x", "\r\n\r\n", "   "]
    for _ in range(60):
        cases.append("".join(rng.choice(pool)
                             for _ in range(rng.randint(1, 30))))
    buf, lens = _rows(cases, 128)
    b, ln = torch.from_numpy(buf), torch.from_numpy(lens)
    got = byte_boundaries_via_chars(b, ln)
    assert torch.equal(got, byte_boundaries(b, ln))
    want = jax.jit(jax.vmap(jpre.byte_boundaries_via_chars))(
        jnp.asarray(buf), jnp.asarray(lens))
    assert np.array_equal(got.numpy(), np.asarray(want))


def _ascii_rows(rng, n, L, simple):
    """Random ASCII rows; ``simple`` keeps whitespace runs to 1 char and
    digit runs to 3."""
    out = []
    for _ in range(n):
        s = []
        while len(s) < rng.randint(0, L):
            if simple:
                s.append(rng.choice(["word", "It's", "ok", "x", "'ll", "!?",
                                     "12", "987", ",", "'", "a1b"]))
                s.append(rng.choice([" ", "\t", "\n"]))
            else:
                s.append(rng.choice(["word", "It's", "  ", "\t\t ", "\n\n",
                                     "1234567", "12", "!! ", " 'Re", "\r\n",
                                     "'ll", "ab", "   x"]))
        out.append("".join(s)[:L])
    return out


def test_ascii_packed_lookup_matches_jax():
    byts = np.arange(256, dtype=np.uint8).reshape(2, 128)
    got = ascii_packed_lookup(torch.from_numpy(byts))
    assert got.dtype == torch.uint8
    want = np.asarray(jpre.ascii_packed_lookup(jnp.asarray(byts)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got[0].numpy(), ascii_classes_arith(
        torch.from_numpy(byts[0])).numpy().astype(np.uint8))


@pytest.mark.parametrize("simple", [False, True])
def test_ascii_row_boundaries_match_jax(simple):
    """byte_boundaries_ascii (full rules) and, on simple rows,
    byte_boundaries_ascii_simple equal the JAX package's row functions."""
    rng = random.Random(5 + simple)
    buf, lens = _rows(_ascii_rows(rng, 48, 96, simple), 96)
    b, ln = torch.from_numpy(buf), torch.from_numpy(lens)
    pk = ascii_packed_lookup(b)
    jpk = jpre.ascii_packed_lookup(jnp.asarray(buf))
    got = byte_boundaries_ascii(b, ln, pk)
    want = jax.jit(jax.vmap(jpre.byte_boundaries_ascii))(
        jnp.asarray(buf), jnp.asarray(lens), jpk)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, byte_boundaries(b, ln))
    if simple:
        got_s = byte_boundaries_ascii_simple(b, ln, pk)
        want_s = jax.jit(jax.vmap(jpre.byte_boundaries_ascii_simple))(
            jnp.asarray(buf), jnp.asarray(lens), jpk)
        assert np.array_equal(got_s.numpy(), np.asarray(want_s))
        assert torch.equal(got_s, got)


def test_char_boundaries_matches_general_rules_and_jax():
    """On general-ASCII rows (whitespace and digit runs of any length) the
    cummax formulation equals the port's general rules; on codepoint rows
    with non-ASCII chars it equals the JAX package's _char_boundaries."""
    rng = random.Random(8)
    buf, lens = _rows(_ascii_rows(rng, 64, 200, False), 200)
    cp = torch.from_numpy(buf).to(torch.int64)
    valid = torch.arange(200)[None, :] < torch.from_numpy(lens)[:, None]
    got = _char_boundaries(cp, valid)
    assert torch.equal(got, _char_boundaries_general(
        cp, valid, ascii_classes_arith(cp)))
    assert got.any(dim=1).sum() > 40

    alpha = [ord(c) for c in "ab Z9 \n\r\t'sSt!é中ſ٣　"] + [0x1F600, 0x2028]
    cps = np.array([[rng.choice(alpha) for _ in range(64)] for _ in range(32)],
                   np.int32)
    n = np.array([rng.randint(0, 64) for _ in range(32)], np.int32)
    v = np.arange(64)[None, :] < n[:, None]
    got = _char_boundaries(torch.from_numpy(cps), torch.from_numpy(v))
    want = jax.jit(jax.vmap(jpre._char_boundaries))(jnp.asarray(cps),
                                                    jnp.asarray(v))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        pretokenize_vec("hello world")
