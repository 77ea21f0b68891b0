"""PyTorch port: the unrouted flat path (``packed_encode(route=None)``) and
its fused stage 1 equal the JAX package's ``packed_encode_impl`` with
``route=None`` and ``stage1_fused`` exactly, on CPU tensors (the kernels'
plain versions; the JAX Pallas kernels run in interpret mode)."""

import random
import string

import numpy as np
import pytest
import torch

import tekken_tpu_torch as tt
import tekken_tpu_torch.ops.packed as tpacked
from tekken_tpu.oracle import encode_ranks
from tekken_tpu_torch.ops.packed import packed_encode, splice_host_merges
from tekken_tpu_torch.ops.stage1 import stage1_fused, stage1_fused_reference

B8, R256, NP256 = 8, 256, 256


@pytest.fixture(scope="module")
def toks(merged_tokenizer):
    md = tt.ModelData.from_json(merged_tokenizer.to_model_data().to_json())
    return merged_tokenizer, tt.Tekkenizer.from_model_data(md, device="cpu")


def _word(rng, lo, hi):
    return "".join(rng.choice(string.ascii_lowercase)
                   for _ in range(rng.randint(lo, hi)))


def _prose(rng, n_words, long_share=0.05):
    """Lowercase prose with misses of every length class."""
    parts = []
    for _ in range(n_words):
        w = _word(rng, 9, 14) if rng.random() < long_share \
            else _word(rng, 1, 8)
        if rng.random() < 0.1:
            w += rng.choice(".,!?;:'")
        parts.append(w)
    return " ".join(parts)


# one buffer per branch of the flat path's chain
BRANCH_TEXTS = {
    "simple": lambda rng: [_prose(rng, rng.randint(0, 40))[:250]
                           for _ in range(5)]
    + ["", "it's fine. x1 y22 z333", "a" * 256],
    "general": lambda rng: [(_prose(rng, 12).replace(" ", "  ", 3)
                             + " 123456")[:250] for _ in range(4)]
    + ["tabs\tand\nnewlines\r\n  mixed   up", "  leading ws  ", "", "x"],
    "utf8": lambda rng: [(_prose(rng, 12) + " café 中文 \U0001f600 naïve")[:240]
                         for _ in range(4)]
    + ["Русский текст и עברית", "it'ſ 12345", "", "ü"],
}


def _pack(texts, B, R):
    buf = np.zeros((B, R), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, t in enumerate(texts):
        d = t.encode("utf-8")[:R]
        buf[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return buf, lens


def _simple_rows(seed, B=B8, R=R256):
    rng = random.Random(seed)
    texts = [_prose(rng, rng.randint(0, 50))[:R - 3] for _ in range(B - 3)]
    return _pack(texts + ["", "a" * R, "b" * (R - 7)], B, R)


@pytest.mark.parametrize("n_words", [0, 3, 6])
def test_stage1_fused_reference_matches_pallas(n_words):
    """Every plane at every (B, R) lane, including non-start and padding
    lanes."""
    import jax.numpy as jnp

    from tekken_tpu.ops.pallas_stage1 import stage1_fused as jax_fused

    buf, lens = _simple_rows(n_words)
    wsize, wseed = (1 << 12, 0x5EED) if n_words else (1, 0)
    want = [np.asarray(x) for x in jax_fused(
        jnp.asarray(buf), jnp.asarray(lens), n_words, wsize, wseed)]
    tb, tl = torch.from_numpy(buf), torch.from_numpy(lens)
    got = stage1_fused_reference(tb, tl, n_words, wsize, wseed)
    assert len(got) == len(want) == (2 + n_words if n_words else 1)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w), (k, np.argwhere(g.numpy() != w)[:5])
    assert int(got[0][B8 - 2, 0]) == R256          # a row that is one piece
    # the wrapper takes the plain version for CPU tensors
    for g, w in zip(stage1_fused(tb, tl, n_words, wsize, wseed), got):
        assert torch.equal(g, w)


def _run_jax(tok, buf, lens, np_cap):
    import jax.numpy as jnp

    from tekken_tpu.ops.packed import PackedEncoder, packed_encode_fn

    B, R = buf.shape
    enc = PackedEncoder(tok, rows=B, row_len=R, np_cap=np_cap)
    fn = packed_encode_fn(enc._seed1, enc._seed2, enc._np_cap, enc._wseed,
                          False, None)
    out = fn(jnp.asarray(buf), jnp.asarray(lens), enc._packed, enc._dense,
             enc._word_rows)
    return [np.asarray(x) for x in out]


def _run_port(port, buf, lens, np_cap, **kw):
    tok, n_out, fb_start, fb_len, overflow, row_bad = packed_encode(
        torch.from_numpy(buf), torch.from_numpy(lens),
        port.device_tables("cpu"), None, np_cap, **kw)
    return (tok.numpy(), int(n_out), fb_start.numpy(), fb_len.numpy(),
            overflow, row_bad.numpy())


def _assert_same(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(np.asarray(g), np.asarray(w)), k


@pytest.mark.parametrize("branch", ["simple", "general", "utf8"])
def test_flat_path_matches_jax(toks, monkeypatch, branch):
    """All six outputs, exactly; the simple branch (and only it) runs the
    fused stage 1."""
    tok, port = toks
    calls = []
    real = tpacked.stage1_fused

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tpacked, "stage1_fused", spy)
    buf, lens = _pack(BRANCH_TEXTS[branch](random.Random(len(branch))),
                      B8, R256)
    got = _run_port(port, buf, lens, NP256)
    _assert_same(got, _run_jax(tok, buf, lens, NP256))
    assert bool(calls) == (branch == "simple")
    assert got[4] == 0 and (got[2] >= 0).any()       # fb spans exist


@pytest.mark.parametrize("texts", [
    ["qx " * 80, "hello hello", " hello hello", ""],
    ["zqkv wxjq " * 25, "wxjq zqkv " * 25, "the cat", "ab"],
], ids=["p4-overflow", "p8-overflow"])
def test_flat_overflow_matches_jax(toks, texts):
    """A small np_cap overflows a bucket: the rows holding dropped pieces
    are flagged, the clean rows are not."""
    tok, port = toks
    buf, lens = _pack(texts, B8, R256)
    got = _run_port(port, buf, lens, 64)
    _assert_same(got, _run_jax(tok, buf, lens, 64))
    assert got[4] == 1 and got[5][:2].sum() >= 1 and got[5][2:].sum() == 0


def test_flat_long_bucket_matches_oracle(toks, monkeypatch):
    """With the device-merge limit raised to 32, misses of 9-32 bytes merge
    in the P=32 bucket and longer ones are spliced on the host."""
    tok, port = toks
    seen = []
    real = tpacked.merge_buckets

    def spy(tok, w, byte_rank, plen, buckets, *a, **kw):
        seen.extend(P for _, _, P, _ in buckets)
        return real(tok, w, byte_rank, plen, buckets, *a, **kw)

    monkeypatch.setattr(tpacked, "merge_buckets", spy)
    rng = random.Random(6)
    texts = [" ".join(_word(rng, 33, 40) for _ in range(6)) for _ in range(3)]
    texts += [" ".join(_word(rng, 9, 31) for _ in range(12))
              for _ in range(5)]
    buf, lens = _pack(texts, 8, 512)
    R = buf.shape[1]
    out, _, fb_start, fb_len, overflow, _ = _run_port(
        port, buf, lens, 1024, fb_len_limit=32)
    assert overflow == 0 and (fb_start >= 0).sum() == 18 and 32 in seen
    pos = np.flatnonzero(out >= 0).astype(np.int64)
    toks_, pos = splice_host_merges(out[pos], pos, buf.reshape(-1), fb_start,
                                    fb_len, tpacked.oracle_merge_fn(tok.ranks))
    cut = np.searchsorted(pos // R, np.arange(len(texts) + 1))
    for i, t in enumerate(texts):
        assert toks_[cut[i]:cut[i + 1]].tolist() == \
            encode_ranks(t, tok.ranks), i


def test_flat_general_long_rows_match_oracle(toks):
    """General-ASCII rows longer than the general rules' 8192-byte bound
    take the byte-level rules, as the JAX flat path takes rows of any
    length."""
    tok, port = toks
    rng = random.Random(8)
    texts = [(_prose(rng, 2200) + "  x\n\n  12345678")[-9000:]
             for _ in range(2)] + ["tab\t\tdeep  end", ""]
    penc = tpacked.PackedEncoder(port, rows=4, row_len=16384, device="cpu")
    buf, lens = penc.pack(texts)
    assert max(lens) > 8192
    got = tpacked.split_ids(*penc._encode_buffer(buf, lens, len(texts),
                                                 None))
    assert got == [encode_ranks(t, tok.ranks) for t in texts]


def test_encode_buffer_unrouted_matches_jax(toks):
    """PackedEncoder._encode_buffer(route=None), as the JAX package's
    passes it through: the docs' tokens equal the JAX result and the
    oracle."""
    from tekken_tpu.ops.packed import PackedEncoder as JEncoder

    tok, port = toks
    texts = (BRANCH_TEXTS["simple"](random.Random(1))[:5]
             + ["don't stop", "x  y", "naïve"])
    penc = tpacked.PackedEncoder(port, rows=B8, row_len=R256, device="cpu")
    jenc = JEncoder(tok, rows=B8, row_len=R256)
    buf, lens = penc.pack(texts)
    got = tpacked.split_ids(*penc._encode_buffer(buf, lens, len(texts),
                                                 None))
    assert got == jenc._encode_buffer(buf, lens, len(texts), None)
    assert got == [encode_ranks(t, tok.ranks) for t in texts]
