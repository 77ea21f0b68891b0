"""PyTorch port: the flat differential engine (ops/flat.py ``FlatEncoder``
and its segmented scans) against the JAX package's and the oracle.
Integer outputs: the tolerance is exact equality."""

import base64
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tekken_tpu_torch as tt
import tekken_tpu_torch.vocab as tvocab
from tekken_tpu import Tekkenizer as JTekkenizer
from tekken_tpu import TokenizerVersion as JVersion
from tekken_tpu.config import TokenInfo as JTokenInfo
from tekken_tpu.models import build_synthetic_tokenizer
from tekken_tpu.ops.flat import FlatEncoder as JFlatEncoder
from tekken_tpu.ops.flat import _seg_lexmin_suffix as j_lexmin
from tekken_tpu.ops.flat import _seg_polyhash as j_polyhash
from tekken_tpu.oracle import encode_ranks
from tekken_tpu_torch.ops.flat import (FlatEncoder, _seg_lexmin_suffix,
                                       _seg_polyhash)

TEXTS = [
    "hello world", "it's a test 123", "", "   whitespace   ",
    "don't we've", "中文 mixed", "a b c d e f", "!!!\n\nnewlines",
]
ROWS, ROW_LEN = 8, 256


def _port(tok):
    md = tt.ModelData.from_json(tok.to_model_data().to_json())
    return tt.Tekkenizer.from_model_data(md, device="cpu")


@pytest.fixture(scope="module")
def toks():
    tok = build_synthetic_tokenizer(num_merges=300, num_special_tokens=20)
    port = _port(tok)
    return (tok, FlatEncoder(port, rows=ROWS, row_len=ROW_LEN, device="cpu"),
            JFlatEncoder(tok, rows=ROWS, row_len=ROW_LEN))


def _check(toks, texts):
    tok, enc, jenc = toks
    got = enc.encode_batch(texts)
    assert got == jenc.encode_batch(texts)
    for t, g in zip(texts, got):
        assert g == encode_ranks(t, tok.ranks), repr(t)


def test_flat_encoder_matches_jax(toks):
    _check(toks, TEXTS)


def _fuzz_text(rng):
    """Whitespace runs, 4-7-digit runs, accents, CJK, emoji, contractions
    and words."""
    parts = []
    for _ in range(rng.randint(1, 14)):
        k = rng.random()
        if k < 0.15:
            parts.append(rng.choice([" ", "  ", "   ", "\t", "\n", " \n ",
                                     "\r\n", "　"]))
        elif k < 0.3:
            parts.append(str(rng.randint(1000, 9999999)))
        elif k < 0.4:
            parts.append(rng.choice(["café", "naïve", "über", "ſtuff",
                                     "Ελληνικά"]))
        elif k < 0.5:
            parts.append(rng.choice(["中文", "日本語", "한국어", "😀", "🚀🎉"]))
        elif k < 0.6:
            parts.append(rng.choice(["it's", "we've", "they're", "I'll",
                                     "don't", "IT'S", "'d"]))
        else:
            parts.append("".join(rng.choice("abcdehlnorstuw!?.,")
                                 for _ in range(rng.randint(1, 12))))
        parts.append(rng.choice(["", " "]))
    return "".join(parts)[:ROW_LEN // 4]


@pytest.mark.parametrize("chunk", range(4))
def test_flat_encoder_fuzz(toks, chunk):
    """100 seeded strings, 25 a chunk, in batches of 8 docs."""
    rng = random.Random(1000 + chunk)
    texts = [_fuzz_text(rng) for _ in range(25)]
    for lo in range(0, len(texts), ROWS):
        _check(toks, texts[lo:lo + ROWS])


def test_flat_encoder_unreachable_token():
    """A vocab whose b"xyz" has no in-vocab split: only the whole-piece
    fast path reaches it."""
    def vocab(info):
        toks = [bytes([i]) for i in range(256)] + [b"xyz"]
        return [info(rank=r, token_bytes=base64.b64encode(t).decode(),
                     token_str=None) for r, t in enumerate(toks)]

    port = tt.Tekkenizer(vocab=vocab(tt.TokenInfo), special_tokens=[],
                         pattern=".*", vocab_size=267, num_special_tokens=10,
                         version=tt.TokenizerVersion.V7, device="cpu")
    jtok = JTekkenizer(vocab=vocab(JTokenInfo), special_tokens=[],
                       pattern=".*", vocab_size=267, num_special_tokens=10,
                       version=JVersion.V7)
    texts = ["xyz", "wxyz", "xyz xyzxyz", "axyz!"]
    got = FlatEncoder(port, rows=4, row_len=64, device="cpu").encode_batch(
        texts)
    assert got[:2] == [[256], [ord("w"), ord("x"), ord("y"), ord("z")]]
    assert got == JFlatEncoder(jtok, rows=4, row_len=64).encode_batch(texts)
    assert got == [encode_ranks(t, jtok.ranks) for t in texts]


@pytest.mark.parametrize("k", tvocab.CuckooPieceTable._K_CANDIDATES)
def test_seg_polyhash_is_poly_sig(k):
    """At every piece's last byte the segmented hash is poly_sig of the
    piece, pieces long enough to wrap 2^32 many times included; for the
    first multiplier every position equals the JAX package's scan."""
    rng = np.random.default_rng(k & 0xFFFF)
    lens = [1, 2, 5, 300, 3, 1, 64, 1000, 17]
    data = rng.integers(0, 256, sum(lens), dtype=np.uint8)
    data[:2] = 255
    boundary = np.zeros(len(data), bool)
    boundary[np.cumsum([0] + lens[:-1])] = True
    h = _seg_polyhash(torch.from_numpy(data), torch.from_numpy(boundary), k)
    ends = np.cumsum(lens) - 1
    for s, e in zip(np.cumsum([0] + lens[:-1]), ends):
        assert int(h[e]) == tvocab.poly_sig(data[s:e + 1].tobytes(), k)
    if k == tvocab.CuckooPieceTable._K_CANDIDATES[0]:
        want = jax.jit(j_polyhash, static_argnums=2)(
            jnp.asarray(data), jnp.asarray(boundary), k)
        assert np.array_equal(h.numpy(), np.asarray(want).astype(np.int64))


def _lexmin_loop(values, idx, end_mark):
    """Sequential suffix (value, idx) min within segments ending at
    end_mark."""
    n = len(values)
    v = np.empty(n, np.int64)
    i = np.empty(n, np.int64)
    for p in range(n - 1, -1, -1):
        if end_mark[p] or p == n - 1:
            v[p], i[p] = values[p], idx[p]
        elif (values[p], idx[p]) <= (v[p + 1], i[p + 1]):
            v[p], i[p] = values[p], idx[p]
        else:
            v[p], i[p] = v[p + 1], i[p + 1]
    return v, i


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_seg_lexmin_suffix_matches_loop(n):
    """Many tied values (0..3 and INF) in random segments: the sequential
    loop agrees with the port's scan, and at n = 1000 the JAX scan too."""
    rng = np.random.default_rng(n)
    values = rng.choice([0, 1, 2, 3, 2**31 - 1], n).astype(np.int64)
    idx = rng.permutation(n).astype(np.int64) if n % 2 else np.arange(n)
    end_mark = rng.random(n) < 0.2
    v, i = _seg_lexmin_suffix(torch.from_numpy(values), torch.from_numpy(idx),
                              torch.from_numpy(end_mark))
    wv, wi = _lexmin_loop(values, idx, end_mark)
    assert np.array_equal(v.numpy(), wv) and np.array_equal(i.numpy(), wi)
    if n != 1000:
        return
    jv, ji = jax.jit(j_lexmin)(jnp.asarray(values.astype(np.int32)),
                               jnp.asarray(idx.astype(np.int32)),
                               jnp.asarray(end_mark))
    assert np.array_equal(np.asarray(jv), wv)
    assert np.array_equal(np.asarray(ji), wi)


def test_pack_refuses(toks):
    _, enc, _ = toks
    with pytest.raises(ValueError, match="9 docs exceed 8 rows"):
        enc.pack(["a"] * 9)
    with pytest.raises(ValueError, match="doc of 257 bytes exceeds row 256"):
        enc.pack(["a" * 257])


def test_cuda_without_a_card_raises(merged_tokenizer):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        FlatEncoder(_port(merged_tokenizer), rows=4, row_len=64)
