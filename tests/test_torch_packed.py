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
                                     "device_long_rows": n_long,
                                     "flat_id_docs": len(texts),
                                     "route_scan_docs": len(texts) - 1}


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


@pytest.mark.parametrize("kind", ["mixed", "overflow", "empty"])
def test_packed_encoder_lists_split_the_flat_result(toks, monkeypatch, kind):
    """``PackedEncoder.encode_batch`` is a split of ``_encode_flat``: the
    oracle's rank lists of Python ints, in input order, whether the docs
    ran in one buffer, in route groups joined by one gather, or with
    overflow rows spliced in from the host."""
    tok, port = toks
    rng = random.Random(3)
    texts = {"mixed": ["Hello world", "", "two  spaces 1234",
                       "café " + _prose(rng, 20), _prose(rng, 30)],
             "overflow": [_prose(rng, 60, long_share=0.3) for _ in range(5)]
             + ["naïve " + _prose(rng, 40, long_share=0.3)],
             "empty": []}[kind]
    if kind == "overflow":
        monkeypatch.setattr(tpacked, "default_np_cap", lambda n: 4)
    enc = tpacked.PackedEncoder(port, rows=8, row_len=1024, device="cpu")
    flat, cuts = enc._encode_flat(texts)
    assert flat.dtype == np.int32 and cuts.dtype == np.int64
    assert cuts.size == len(texts) + 1 and cuts[-1] == flat.size
    got = enc.encode_batch(texts)
    assert (enc.stats["overflow_rows"] > 0) == (kind == "overflow")
    assert got == tpacked.split_ids(flat, cuts)
    assert got == [encode_ranks(t, tok.ranks) for t in texts]
    assert all(type(r) is int for d in got for r in d)


def test_take_segments_matches_a_loop():
    """``take_segments`` gathers the segments back to back, empty ones
    included, as a loop of slices does."""
    rng = np.random.default_rng(9)
    flat = rng.integers(0, 1000, 200).astype(np.int32)
    starts = rng.integers(0, 150, 40)
    counts = rng.integers(0, 50, 40)
    counts[::7] = 0
    got, cuts = tpacked.take_segments(flat, starts, counts)
    want = [flat[s:s + c] for s, c in zip(starts, counts)]
    assert got.dtype == flat.dtype
    assert got.tolist() == np.concatenate(want).tolist()
    assert np.diff(cuts).tolist() == counts.tolist() and cuts[0] == 0
    assert tpacked.split_ids(got, cuts) == [w.tolist() for w in want]
    empty, cuts = tpacked.take_segments(flat, [], [])
    assert empty.size == 0 and cuts.tolist() == [0]


def test_assemble_rows_on_a_hand_made_readback():
    """``assemble_rows`` on a read-back of 4 rows of 8 bytes, 3 of them
    docs: row 0 device tokens only, row 1 a device token and a span merged
    and spliced at its place, row 2 a bad row whose device token gives way
    to the host's re-encode, row 3 padding past ``n_docs`` (bad too, and
    never re-encoded)."""
    buf, lens = tpacked.pack_rows(["abc", "xyzw", "qq", "p"], 4, 8)
    tok = np.full(32, -1, np.int32)
    tok[[0, 2, 8, 16, 24]] = [10, 11, 20, 40, 60]
    merged, encoded = [], []

    def merge_fn(flat, starts, lens_):
        merged.append((flat[starts[0]:starts[0] + lens_[0]].tobytes(),
                       starts.tolist(), lens_.tolist()))
        return np.array([30, 31], np.int32), np.array([2], np.int32)

    def host_ranks(text):
        encoded.append(text)
        return [50, 51, 52]

    clock = StageClock()
    flat, cuts = tpacked.assemble_rows(
        tok, np.array([9, -1], np.int32), np.array([3, 0], np.int32),
        np.array([2, 3]), buf, lens, 3, merge_fn, host_ranks, clock)
    assert flat.dtype == np.int32 and cuts.dtype == np.int64
    assert tpacked.split_ids(flat, cuts) == [[10, 11], [20, 30, 31],
                                             [50, 51, 52]]
    assert merged == [(b"yzw", [9], [3])] and encoded == ["qq"]
    assert {"tekken.doc_lists", "tekken.splice.merge",
            "tekken.overflow_rows"} <= {r.name for r in clock.spans}
    assert "splice" in clock.times


@pytest.mark.parametrize("lo,hi,n", [(8, 64, 61), (2, 8, 8), (4, 4, 3)])
def test_route_groups_cover_each_doc_once_and_join_in_order(lo, hi, n):
    """``route_groups`` puts every doc in exactly one group of its route,
    each group's rows the power-of-two multiple of ``lo`` that holds the
    route's docs, at most ``hi``; ``encode_route_groups`` joins the
    groups' results back in input order."""
    routes = np.random.default_rng(n).choice([1, 2, 3], n, p=[.7, .2, .1])
    groups = list(tpacked.route_groups(routes, lo, hi))
    seen = np.concatenate([sel for _, sel, _ in groups])
    assert sorted(seen.tolist()) == list(range(n))
    for r, sel, Bg in groups:
        assert (routes[sel] == r).all() and 0 < sel.size <= Bg
        want = lo
        while want < (routes == r).sum() and want < hi:
            want *= 2
        assert Bg == want and lo <= Bg <= hi and Bg & (Bg - 1) == 0

    # doc i is i % 3 bytes of value i; each group packs its own buffer
    docs = [bytes([i]) * (i % 3) for i in range(n)]
    calls = []

    def encode_buffer(sub_buf, sub_len, n_docs, route, clock):
        calls.append((route, sub_buf.shape[0], n_docs))
        assert not sub_len[n_docs:].any() and not sub_buf[n_docs:].any()
        return (np.repeat(sub_buf[:n_docs, 0], sub_len[:n_docs]).astype(
            np.int32), np.concatenate([[0], np.cumsum(sub_len[:n_docs])]))

    flat, cuts = tpacked.encode_route_groups(
        docs, routes, lo, hi, lambda d, rows: tpacked.pack_rows(d, rows, 4),
        encode_buffer)
    assert tpacked.split_ids(flat, cuts) == [[i] * (i % 3) for i in range(n)]
    assert calls == [(r, Bg, sel.size) for r, sel, Bg in groups]


_WS6 = "\t\n\x0b\x0c\r "
# one-doc batches: (name, text)
ROUTE_HAND = {"empty": "", "tab": "\t", "two_spaces": "  ",
              "digits3": "a 123 b", "digits4": "a 1234 b", "nul": "a\x00b",
              "nul_pair": "\x00\x00", "e_acute": "café", "han": "中文",
              "emoji": "\U0001f600", "digits_split": "12a34",
              **{f"ws_{ord(a):02x}_{ord(b):02x}": f"x{a}{b}y"
                 for a in _WS6 for b in _WS6}}


def _random_docs(seed, n=300):
    """Short docs over whitespace, digits, NUL, letters, é, 中 and 😀,
    most of them ASCII."""
    rng = random.Random(seed)
    ascii_ = _WS6 + "0123456789\x00ab"
    docs = []
    for _ in range(n):
        alpha = ascii_ + ("é中\U0001f600" if rng.random() < 0.3 else "")
        docs.append("".join(rng.choice(alpha)
                            for _ in range(rng.randint(0, 12))))
    return docs


@pytest.mark.parametrize(
    "texts", [[t] for t in ROUTE_HAND.values()]
    + [_random_docs(s) for s in (1, 2, 3)],
    ids=list(ROUTE_HAND) + ["random1", "random2", "random3"])
def test_doc_routes_from_texts_match_the_plane(texts):
    """The routes taken from the texts (``str.isascii``, then the general
    rules' predicates on the ASCII ones) equal the JAX package's
    ``doc_routes`` on the texts' packed plane, row for row, and their
    largest is ``host_route`` of the plane; only the ASCII docs count
    toward ``route_scan_docs``."""
    from tekken_tpu.ops.packed import doc_routes as jax_doc_routes
    from tekken_tpu.ops.packed import host_route as jax_host_route

    from tekken_tpu_torch.utils.timing import COUNTERS

    before = COUNTERS.totals["route_scan_docs"]
    routes = tpacked.doc_routes(texts)
    scanned = COUNTERS.totals["route_scan_docs"] - before
    R = max(8, max(len(t.encode()) for t in texts))
    buf, _ = tpacked.pack_rows(texts, len(texts) + 1, R)
    assert routes.dtype == np.int8 and routes.shape == (len(texts),)
    assert routes.tolist() == jax_doc_routes(buf)[:len(texts)].tolist()
    assert int(routes.max()) == tpacked.host_route(buf) == \
        jax_host_route(buf)
    assert scanned == sum(t.isascii() for t in texts)


def test_route_groups_packed_from_bytes_equal_cut_from_the_plane(
        toks, monkeypatch):
    """A batch of routes 1, 2 and 3 through ``PackedEncoder``: each route
    group packed straight from the docs' bytes gives the same flat ranks
    and cuts as the group's rows cut out of the whole batch's plane (the
    reference below), and the oracle's ranks; the encoder packs one
    buffer a group and never the whole plane."""
    tok, port = toks
    rng = random.Random(23)
    texts = [t for r in (1, 2, 3) for t in ROUTE_TEXTS[r](rng)[:5]]
    rng.shuffle(texts)
    enc = port._get_packed_encoder(texts)
    datas = [t.encode() for t in texts]
    packs = []
    real = enc.pack
    monkeypatch.setattr(enc, "pack", lambda docs, rows=None: packs.append(
        (rows, len(docs))) or real(docs, rows))
    flat, cuts = enc._encode_flat(texts, datas=datas)

    routes = tpacked.doc_routes(texts)
    groups = list(tpacked.route_groups(routes, 8, enc._B))
    assert sorted({r for r, _, _ in groups}) == [1, 2, 3]
    assert packs == [(Bg, sel.size) for _, sel, Bg in groups]
    buf, lens = tpacked.pack_rows(texts, enc._B, enc._R)
    flats, starts, counts, base = [], {}, {}, 0
    for r, sel, Bg in groups:
        sub_buf = np.zeros((Bg, enc._R), np.uint8)
        sub_buf[:sel.size] = buf[sel]
        sub_len = np.zeros(Bg, np.int32)
        sub_len[:sel.size] = lens[sel]
        f, c = enc._encode_buffer(sub_buf, sub_len, sel.size, r)
        for j, i in enumerate(sel.tolist()):
            starts[i], counts[i] = base + c[j], c[j + 1] - c[j]
        flats.append(f)
        base += f.size
    want, want_cuts = tpacked.take_segments(
        np.concatenate(flats), [starts[i] for i in range(len(texts))],
        [counts[i] for i in range(len(texts))])
    assert np.array_equal(flat, want) and np.array_equal(cuts, want_cuts)
    assert tpacked.split_ids(flat, cuts) == [encode_ranks(t, tok.ranks)
                                             for t in texts]
    # texts in place of their bytes: the same result
    flat2, cuts2 = enc._encode_flat(texts)
    assert np.array_equal(flat2, flat) and np.array_equal(cuts2, cuts)
