"""PyTorch port: the packed pipeline (routes 1-3) and Tekkenizer.encode_batch
equal the JAX package's packed_encode_impl / encode_batch and the oracle,
on CPU tensors (the kernels' plain versions)."""

import random
import string

import numpy as np
import pytest
import torch

import tekken_tpu_torch as tt
import tekken_tpu_torch.ops.packed as tpacked
from tekken_tpu.oracle import encode_ranks, pretokenize
from tekken_tpu_torch.ops.packed import packed_encode, splice_host_merges
from tekken_tpu_torch.utils.timing import StageClock


@pytest.fixture(scope="module")
def toks(merged_tokenizer):
    md = tt.ModelData.from_json(merged_tokenizer.to_model_data().to_json())
    return merged_tokenizer, tt.Tekkenizer.from_model_data(md, device="cpu")


def _word(rng, lo, hi):
    return "".join(rng.choice(string.ascii_lowercase)
                   for _ in range(rng.randint(lo, hi)))


def _prose(rng, n_words, long_share=0.05):
    """Lowercase prose: misses of every length class (2-3, 4, 5-8, > 8)."""
    parts = []
    for _ in range(n_words):
        w = _word(rng, 9, 14) if rng.random() < long_share \
            else _word(rng, 1, 8)
        if rng.random() < 0.1:
            w += rng.choice(".,!?;:'")
        parts.append(w)
    return " ".join(parts)


# (8, 256) buffers with np_cap 256: the shape and capacity that the
# encode_batch test's 8-doc route groups take, so the JAX package compiles
# each route once for the whole module
B8, R256, NP256 = 8, 256, 256

ROUTE_TEXTS = {
    1: lambda rng: [_prose(rng, rng.randint(0, 40))[:250] for _ in range(5)]
    + ["", "it's fine.", "a1 b22 c333"],
    2: lambda rng: [(_prose(rng, 12).replace(" ", "  ", 3) + " 123456")[:250]
                    for _ in range(4)]
    + ["tabs\tand\nnewlines\r\n  mixed   up", "  leading ws  ", "", "x"],
    3: lambda rng: [(_prose(rng, 12) + " café 中文 \U0001f600 naïve")[:240]
                    for _ in range(4)]
    + ["Русский текст и עברית", "it'ſ 12345", "", "ü"],
}


def _pack(texts, B, R):
    buf = np.zeros((B, R), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, t in enumerate(texts):
        d = t.encode("utf-8")
        buf[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return buf, lens


def _run_jax(tok, buf, lens, route, np_cap):
    import jax.numpy as jnp

    from tekken_tpu.ops.packed import PackedEncoder, packed_encode_fn

    B, R = buf.shape
    enc = PackedEncoder(tok, rows=B, row_len=R, np_cap=np_cap)
    fn = packed_encode_fn(enc._seed1, enc._seed2, enc._np_cap, enc._wseed,
                          False, route)
    out = fn(jnp.asarray(buf), jnp.asarray(lens), enc._packed, enc._dense,
             enc._word_rows)
    return [np.asarray(x) for x in out]


def _run_port(port, buf, lens, route, np_cap, **kw):
    tok, n_out, fb_start, fb_len, overflow, row_bad = packed_encode(
        torch.from_numpy(buf), torch.from_numpy(lens),
        port.device_tables("cpu"), route, np_cap, **kw)
    return (tok.numpy(), int(n_out), fb_start.numpy(), fb_len.numpy(),
            overflow, row_bad.numpy())


def _spans(fb_start, fb_len):
    live = fb_start >= 0
    return set(zip(fb_start[live].tolist(), fb_len[live].tolist()))


def _assert_same(got, want):
    tok, n_out, fb_start, fb_len, overflow, row_bad = got
    assert np.array_equal(tok, want[0])
    assert n_out == int(want[1])
    assert overflow == int(want[4])
    assert np.array_equal(row_bad, want[5])
    assert _spans(fb_start, fb_len) == _spans(want[2], want[3])


@pytest.mark.parametrize("route", [1, 2, 3])
def test_pipeline_matches_jax(toks, route):
    from tekken_tpu.ops.packed import host_route

    tok, port = toks
    texts = ROUTE_TEXTS[route](random.Random(route))
    buf, lens = _pack(texts, B8, R256)
    assert host_route(buf) == route
    got = _run_port(port, buf, lens, route, NP256)
    _assert_same(got, _run_jax(tok, buf, lens, route, NP256))
    assert got[4] == 0 and _spans(got[2], got[3])      # fb spans exist


@pytest.mark.parametrize("texts", [
    ["qx " * 80, "hello hello", " hello hello", ""],
    ["zqkv wxjq " * 25, "wxjq zqkv " * 25, "the cat", "ab"],
], ids=["p23-overflow", "p8-overflow"])
def test_pipeline_overflow_matches_jax(toks, texts):
    """A tiny np_cap overflows a bucket: the rows holding dropped pieces
    are flagged, the clean rows are not."""
    tok, port = toks
    buf, lens = _pack(texts, B8, R256)
    got = _run_port(port, buf, lens, 1, 64)
    _assert_same(got, _run_jax(tok, buf, lens, 1, 64))
    assert got[4] == 1 and got[5][:2].sum() >= 1 and got[5][2:].sum() == 0


def test_encode_batch_matches_jax_and_oracle(toks):
    tok, port = toks
    rng = random.Random(23)
    # 16 docs of < 256 bytes: three route groups of <= 8 rows each
    texts = ([_prose(rng, rng.randint(0, 40))[:250] for _ in range(5)]
             + ["", "Hello, World! It's 99 bottles.", "double  spaces",
                "1234567 digits", "tabs\t\tdeep", "   ", "\n\n\n",
                "unicode: café naïve 中文 \U0001f600", "ü", "emoji 😀 ok",
                "Ελληνικά 123"])
    assert len(texts) == 16
    got = port.encode_batch(texts, add_beginning_of_sequence=True,
                            add_end_of_sequence=True)
    want = tok.encode_batch(texts, add_beginning_of_sequence=True,
                            add_end_of_sequence=True)
    assert got == want
    for t, g in zip(texts, got):
        assert g == tok.encode(t, True, True), repr(t)
    assert port.encode_batch([]) == tok.encode_batch([]) == []


def _spy_buckets(monkeypatch):
    """The P of every merge bucket tier run, in order."""
    seen = []
    real = tpacked.merge_buckets

    def spy(tok, w, byte_rank, plen, buckets, *a, **kw):
        seen.extend(P for _, _, P, _ in buckets)
        return real(tok, w, byte_rank, plen, buckets, *a, **kw)

    monkeypatch.setattr(tpacked, "merge_buckets", spy)
    return seen


def _misses(texts, ranks, lo, hi):
    """The pieces of ``texts`` of lo..hi bytes that are not tokens."""
    return sum(lo <= len(b) <= hi and b not in ranks
               for t in texts for b in (p.encode() for p in pretokenize(t)))


def test_encode_batch_runs_merge_buckets_and_splice(toks, monkeypatch):
    """4-8-byte misses reach the P=4 and P=8 merge buckets and 9-32-byte
    misses the P=32 bucket; misses over 32 bytes are merged and spliced on
    the host."""
    tok, port = toks
    seen = _spy_buckets(monkeypatch)
    rng = random.Random(31)
    texts = [_prose(rng, 50, long_share=0.1) + " " + _word(rng, 33, 40)
             for _ in range(9)]
    got = port.encode_batch(texts)
    for t, g in zip(texts, got):
        assert g == [r + 20 for r in encode_ranks(t, tok.ranks)], repr(t)
    assert {4, 8, 32} <= set(seen)
    assert port.last_batch_stats["fb_spans"] == 9
    assert port.last_batch_stats["overflow_rows"] == 0


def _utf8_word(rng, lo, hi):
    """A lowercase word of lo..hi UTF-8 bytes, a third of its letters
    two bytes long."""
    n, w = rng.randint(lo, hi), ""
    while len(w.encode()) < n:
        two = rng.random() < 0.33 and len(w.encode()) + 2 <= n
        w += rng.choice("éüñçøåß" if two else string.ascii_lowercase)
    return w


# the texts of encode calls whose vocab misses are all 9-32 bytes: one
# route group (route 1 or 3), or three; single bytes (the double space,
# the digits) are no misses.  The encoders' (8, 256) shape holds 64 long
# misses a call (``default_np_cap`` / 8): "overflow" has 72.
LONG_MISS_TEXTS = {
    "route1": lambda rng: [" ".join(_word(rng, 9, 31) for _ in range(10))
                           for _ in range(6)],
    "route3": lambda rng: [" ".join(_utf8_word(rng, 9, 31)
                                    for _ in range(10)) for _ in range(6)],
    "routes123": lambda rng: [
        " ".join(_word(rng, 9, 31) for _ in range(8)),
        _word(rng, 9, 31) + "  " + _word(rng, 9, 31) + " 1234",
        " ".join(_utf8_word(rng, 9, 31) for _ in range(8))],
    "overflow": lambda rng: [" ".join(_word(rng, 9, 31) for _ in range(12))
                             for _ in range(6)],
}


@pytest.mark.parametrize("kind", sorted(LONG_MISS_TEXTS))
def test_default_encoder_merges_long_misses_on_the_device(toks, monkeypatch,
                                                          kind):
    """Through the default PackedEncoder, misses of 9-32 bytes merge in the
    P=32 bucket: no span reaches the host (the splice opens no span),
    ``device_long_rows`` counts every one the bucket holds, and the ids
    are the oracle's.  Past the bucket's 64 rows the rows holding the
    dropped misses are re-encoded on the host, still with no span."""
    tok, port = toks
    seen = _spy_buckets(monkeypatch)
    texts = LONG_MISS_TEXTS[kind](random.Random(len(kind)))
    n_long = _misses(texts, tok.ranks, 9, 32)
    assert n_long > 10 and _misses(texts, tok.ranks, 2, 8) == \
        _misses(texts, tok.ranks, 33, 1 << 20) == 0
    clock = StageClock()
    got = port.encode_batch(texts, clock=clock)
    for t, g in zip(texts, got):
        assert g == [r + 20 for r in encode_ranks(t, tok.ranks)], repr(t)
    assert seen and set(seen) == {32}
    stats = port.last_batch_stats
    assert stats["fb_spans"] == 0
    assert stats["device_long_rows"] == min(n_long, 64)
    assert (stats["overflow_rows"] > 0) == (n_long > 64) == (kind ==
                                                             "overflow")
    names = {r.name for r in clock.spans}
    assert "tekken.splice.merge" not in names
    assert "tekken.splice.sort" not in names
    assert ("tekken.overflow_rows" in names) == (kind == "overflow")


def test_default_encoder_splices_only_misses_over_32_bytes(toks, monkeypatch):
    """A mixed batch: every miss of 9-32 bytes merges on the device, and
    only those over 32 bytes are merged and spliced on the host (both
    share the long bucket's 64 rows at this shape)."""
    tok, port = toks
    rng = random.Random(17)
    texts = [" ".join(_word(rng, 9, 31) if rng.random() < 0.7
                      else _word(rng, 33, 45) for _ in range(8))
             for _ in range(7)] + ["café " + _word(rng, 40, 50)]
    spliced = []
    real = tpacked.splice_host_merges

    def spy(out, out_pos, flat, fb_start, fb_len, *a, **kw):
        spliced.extend(fb_len[fb_start >= 0].tolist())
        return real(out, out_pos, flat, fb_start, fb_len, *a, **kw)

    monkeypatch.setattr(tpacked, "splice_host_merges", spy)
    got = port.encode_batch(texts)
    for t, g in zip(texts, got):
        assert g == [r + 20 for r in encode_ranks(t, tok.ranks)], repr(t)
    n_long = _misses(texts, tok.ranks, 9, 32)
    n_host = _misses(texts, tok.ranks, 33, 1 << 20)
    assert n_long > 20 and n_host > 10 and n_long + n_host <= 64
    assert min(spliced) > 32 and len(spliced) == n_host
    assert port.last_batch_stats == {"overflow_rows": 0, "fb_spans": n_host,
                                     "device_long_rows": n_long}


def test_long_bucket_device_merge(toks, monkeypatch):
    """With the device-merge limit raised to 32, misses of 9-32 bytes merge
    in the P=32 bucket.  Its tier covers every row the bucket fills, so a
    mergeable piece behind more than 64 fallback pieces still merges
    (the reference's tier counts only mergeable pieces)."""
    tok, port = toks
    rng = random.Random(5)
    seen = _spy_buckets(monkeypatch)
    texts = [" ".join(_word(rng, 33, 40) for _ in range(14)) for _ in range(5)]
    texts += [" ".join(_word(rng, 9, 31) for _ in range(20))
              for _ in range(3)]
    buf, lens = _pack(texts, 8, 1024)
    R = buf.shape[1]
    out, n_out, fb_start, fb_len, overflow, row_bad = _run_port(
        port, buf, lens, 1, 2048, fb_len_limit=32)
    assert overflow == 0 and 32 in seen
    # 70 fallback pieces (> 32 bytes) precede the mergeable 9-32-byte ones
    n_fb = sum(len(p.encode()) > 32 for t in texts for p in pretokenize(t))
    assert n_fb == 70 and (fb_start >= 0).sum() == n_fb
    pos = np.flatnonzero(out >= 0).astype(np.int64)
    toks_, pos = splice_host_merges(out[pos], pos, buf.reshape(-1), fb_start,
                                    fb_len, tpacked.oracle_merge_fn(tok.ranks))
    cut = np.searchsorted(pos // R, np.arange(len(texts) + 1))
    for i, t in enumerate(texts):
        assert toks_[cut[i]:cut[i + 1]].tolist() == \
            encode_ranks(t, tok.ranks), i


def test_pipeline_refuses_unrouted(toks):
    """A route outside None (the unrouted flat path, tests/test_torch_flat.py)
    and 1-3 is refused."""
    _, port = toks
    buf, lens = _pack(["abc"], 8, 256)
    for route in (0, 4):
        with pytest.raises(ValueError, match="route"):
            packed_encode(torch.from_numpy(buf), torch.from_numpy(lens),
                          port.device_tables("cpu"), route)
