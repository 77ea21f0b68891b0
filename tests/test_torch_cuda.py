"""PyTorch port on the GPU: each CUDA kernel equals its plain PyTorch version
bit for bit on adversarial inputs, and encode_batch on the card equals the
oracle and the native engine.  Marked ``cuda``: every test skips where
torch sees no GPU.

This file imports neither jax nor the JAX package (its tokenizers come
from the port's own builders), so it also runs on a machine without
them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import base64
import random
import string

import numpy as np
import pytest
import torch

import tekken_tpu_torch as tt
from tekken_tpu_torch import _build
from tekken_tpu_torch.models import build_synthetic_tokenizer
from tekken_tpu_torch.oracle import encode_ranks
from tekken_tpu_torch.ops.bpe import INF, merge_rows_compact
from tekken_tpu_torch.ops.decode import (DeviceDecoder, decode_bytes_compact,
                                         decode_bytes_compact_reference)
from tekken_tpu_torch.ops.merge import (merge_buckets,
                                        merge_buckets_reference,
                                        merge_rows_compact_fused)
from tekken_tpu_torch.ops.packed import _bucket_tiers
from tekken_tpu_torch.ops.pretokenize import byte_boundaries
from tekken_tpu_torch.ops.stage1 import (stage1_compact,
                                         stage1_compact_reference,
                                         stage1_fused, stage1_fused_reference)
from tekken_tpu_torch.special_tokens import SpecialTokenPolicy
from test_torch_merge_buckets import CAPS, bucket_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tok():
    """Byte tokens + prefix chains of 3000 random words (bench.py's vocab
    construction at a small size)."""
    rng = random.Random(7)
    words = ["".join(rng.choice(string.ascii_lowercase)
                     for _ in range(rng.randint(2, 11))) for _ in range(3000)]
    tokens = [bytes([i]) for i in range(256)]
    seen = set(tokens)
    for w in words:
        for b in (b" " + w.encode(), w.encode()):
            for k in range(2, len(b) + 1):
                if b[:k] not in seen:
                    seen.add(b[:k])
                    tokens.append(b[:k])
    vocab = [tt.TokenInfo(rank=r, token_bytes=base64.b64encode(t).decode())
             for r, t in enumerate(tokens)]
    return tt.Tekkenizer(vocab, [], "", len(vocab) + 100, 100,
                         tt.TokenizerVersion.V7, device="cuda"), words


@pytest.fixture(scope="module")
def synth():
    """The port's synthetic BPE tokenizer (200 trained merges)."""
    return build_synthetic_tokenizer(num_merges=200, num_special_tokens=20,
                                     device="cuda")


def _texts(rng, kind, n, max_len):
    alphas = {
        "simple": string.ascii_letters + "019.,!?';: ",
        "general": string.ascii_letters + string.digits + " .,!?'\n\r\t",
        "utf8": string.ascii_letters + " .,'\n" + "中文éüſ\U0001f600٣ Ω",
    }
    a = alphas[kind]
    return ["".join(rng.choice(a) for _ in range(rng.randint(0, max_len)))
            for _ in range(n)]


def _rows(texts, R):
    buf = np.zeros((len(texts), R), np.uint8)
    lens = np.zeros(len(texts), np.int32)
    for i, t in enumerate(texts):
        d = t.encode()[:R]
        buf[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return buf, lens


@pytest.mark.parametrize("n_words", [0, 3, 6])
@pytest.mark.parametrize("rules,R", [("simple", 300), ("simple", 5000),
                                     ("general", 300), ("general", 8192),
                                     ("external", 300), ("external", 5000)])
def test_stage1_kernel_matches_plain(dev, rules, R, n_words):
    rng = random.Random(R + n_words)
    kind = {"simple": "simple", "general": "general", "external": "utf8"}[rules]
    texts = _texts(rng, kind, 60, R) + ["", "a" * R, "a1" * (R // 2),
                                        " " * R, "x'll 's" * 3]
    buf, lens = _rows(texts, R)
    b = torch.from_numpy(buf).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    kw = {"boundary": byte_boundaries(b, ln)} if rules == "external" else {}
    wsize, wseed = (1 << 12, 0x9E3779B9) if n_words else (1, 0)
    want = stage1_compact_reference(b, ln, n_words, wsize, wseed, rules, **kw)
    before = _build.LAUNCHES["stage1_compact"]
    got = stage1_compact(b, ln, n_words, wsize, wseed, rules, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["stage1_compact"] == before + 1
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (k, torch.nonzero(g != w)[:5].tolist())


# lanes a tile of the stage-1 kernels walks (kTile in csrc/stage1_tile.cuh)
TILE = 2048


def _tile_edge_texts(rng, kind, R):
    """Rows whose lengths fall at and around the tile edges, a row that is
    one piece, a row of single-byte pieces and rows of contractions that
    straddle the first tile edge."""
    src = " ".join(_texts(rng, kind, 8, R))
    while len(src) < R:
        src += " " + src
    texts = [src[:n] for n in (TILE - 1, TILE, TILE + 1, 2 * TILE + 1, R,
                               R - 1, 1, 0) if n <= R]
    texts += ["a" * R, "a " * (R // 2)]
    texts += ["q" * (TILE + d) + "'ll x've y'd z're 's" * 4
              for d in range(-6, 2)]
    return texts


@pytest.mark.parametrize("rules", ["simple", "general", "external"])
@pytest.mark.parametrize("R", [TILE - 1, TILE, TILE + 1, 2 * TILE + 16],
                         ids=["tile-1", "tile", "tile+1", "2tile+16"])
def test_stage1_kernel_tile_edges(dev, rules, R):
    """Every plane at every lane at the tile edges: widths that are no
    multiple of 16 take the kernel's byte-load path."""
    kind = {"simple": "simple", "general": "general", "external": "utf8"}[rules]
    buf, lens = _rows(_tile_edge_texts(random.Random(R), kind, R), R)
    b = torch.from_numpy(buf).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    kw = {"boundary": byte_boundaries(b, ln)} if rules == "external" else {}
    want = stage1_compact_reference(b, ln, 3, 1 << 12, 0x9E3779B9, rules,
                                    **kw)
    got = stage1_compact(b, ln, 3, 1 << 12, 0x9E3779B9, rules, **kw)
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (k, torch.nonzero(g != w)[:5].tolist())


@pytest.mark.parametrize("n_words", [0, 3, 6])
@pytest.mark.parametrize("R", [300, 5000, 1 << 16])
def test_stage1_fused_kernel_matches_plain(dev, R, n_words):
    """Every plane at every lane, on simple-ASCII rows: empty rows, a row
    that is one piece, lengths that are no multiple of the tile."""
    rng = random.Random(R + n_words)
    n = 40 if R < 1 << 16 else 4
    texts = _texts(rng, "simple", n, R) + ["", "a" * R, "b" * (R - 1),
                                           "x'll 's" * 3]
    buf, lens = _rows(texts, R)
    b = torch.from_numpy(buf).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    wsize, wseed = (1 << 12, 0x9E3779B9) if n_words else (1, 0)
    want = stage1_fused_reference(b, ln, n_words, wsize, wseed)
    before = _build.LAUNCHES["stage1_fused"]
    got = stage1_fused(b, ln, n_words, wsize, wseed)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["stage1_fused"] == before + 1
    assert len(got) == len(want) == (2 + n_words if n_words else 1)
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (k, torch.nonzero(g != w)[:5].tolist())
    assert int(got[0][len(texts) - 3, 0]) == R          # the one-piece row


@pytest.mark.parametrize("n_words", [0, 3, 6])
@pytest.mark.parametrize("R", [TILE - 1, TILE, TILE + 1, 2 * TILE + 16],
                         ids=["tile-1", "tile", "tile+1", "2tile+16"])
def test_stage1_fused_kernel_tile_edges(dev, R, n_words):
    """Every plane at every lane at the tile edges: rows whose letter runs
    are longer than a tile (the piece pending across tiles), widths no
    multiple of 16, and the same rows again one byte into their buffer
    (unaligned row starts: the byte-load path)."""
    texts = _tile_edge_texts(random.Random(R), "simple", R)
    buf, lens = _rows(texts, R)
    B = buf.shape[0]
    wsize, wseed = (1 << 12, 0x9E3779B9) if n_words else (1, 0)
    flat = np.zeros(B * R + 16, np.uint8)
    flat[1:1 + B * R] = buf.reshape(-1)
    shifted = torch.from_numpy(flat).to(dev)[1:1 + B * R].view(B, R)
    ln = torch.from_numpy(lens).to(dev)
    for b in (torch.from_numpy(buf).to(dev), shifted):
        want = stage1_fused_reference(b, ln, n_words, wsize, wseed)
        got = stage1_fused(b, ln, n_words, wsize, wseed)
        torch.cuda.synchronize()
        for k, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), (k, torch.nonzero(g != w)[:5].tolist())
    assert shifted.data_ptr() % 16
    assert int(got[0][texts.index("a" * R), 0]) == R    # the one-piece row


@pytest.mark.parametrize("n_tokens", [65536, 65535, 1, 0])
def test_decode_kernel_matches_plain(dev, tok, n_tokens):
    """All out_cap bytes, random ranks over the whole vocabulary."""
    dec = DeviceDecoder(tok[0], device=dev)
    rng = np.random.default_rng(n_tokens)
    ranks = rng.integers(0, dec._n_ranks, 65536, dtype=np.int32)
    t = torch.from_numpy(ranks).to(dev)
    out_cap = dec.out_cap_for(ranks[:n_tokens])
    want, wt = decode_bytes_compact_reference(t, n_tokens, dec._bytes32,
                                              dec._lentab, out_cap)
    before = _build.LAUNCHES["decode_store"]
    got, gt = decode_bytes_compact(t, n_tokens, dec._bytes32, dec._lentab,
                                   out_cap)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_store"] == before + 1
    assert gt.dtype == wt.dtype == torch.int32
    assert int(gt) == int(wt)
    assert torch.equal(got, want), torch.nonzero(got != want)[:5].tolist()


# tokens a CTA of the decode store kernel takes
DECODE_TILE = 1024


@pytest.mark.parametrize("T,n,sw4,cap", [
    (4096, 1023, 8, "4x"), (4096, 1024, 8, "4x"), (4096, 1025, 8, "4x"),
    (3000, 3000, 8, "4x"), (3000, 2500, 16, "4x"), (2053, 2000, 2, "4x"),
    (5000, 5000, 32, "4x"), (1024, 0, 8, "4x"), (3000, 3000, 8, "half"),
], ids=["tile-1", "tile", "tile+1", "ragged-T", "mid-tile", "sw4-2",
        "sw4-32", "no-tokens", "cap-short"])
def test_decode_kernel_tile_edges(dev, T, n, sw4, cap):
    """A synthetic table with lengths 0..sw4: n_tokens on both sides of a
    tile edge, T no multiple of the tile, out_cap at least 4x the total
    (or short of it), and three calls in a row that reuse the kernel's
    scan state with new epochs."""
    g = np.random.default_rng(T + n + sw4)
    n_ranks = 300
    lentab = torch.from_numpy(
        g.integers(0, sw4 + 1, n_ranks).astype(np.int32)).to(dev)
    bytes32 = torch.from_numpy(
        g.integers(0, 256, (n_ranks, sw4)).astype(np.int32)).to(dev)
    for call in range(3):
        t = torch.from_numpy(
            g.integers(-5, n_ranks + 5, T).astype(np.int32)).to(dev)
        total = int(lentab[t[:n].clamp(0, n_ranks - 1)].sum())
        out_cap = 4 * total + 13 if cap == "4x" else total // 2
        want, wt = decode_bytes_compact_reference(t, n, bytes32, lentab,
                                                  out_cap)
        before = _build.LAUNCHES["decode_store"]
        got, gt = decode_bytes_compact(t, n, bytes32, lentab, out_cap)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["decode_store"] == before + 1
        assert gt.dtype == wt.dtype == torch.int32 and gt.shape == wt.shape
        assert int(gt) == int(wt) == total, call
        assert torch.equal(got, want), (
            call, torch.nonzero(got != want)[:5].tolist())


def test_empty_inputs_launch_nothing(dev, tok):
    """Empty inputs launch no kernel and count no launch; the outputs equal
    the plain versions' (a zero-width row holds no piece)."""
    b = torch.zeros((4, 0), dtype=torch.uint8, device=dev)
    ln = torch.zeros(4, dtype=torch.int32, device=dev)
    wsize, wseed = 1 << 12, 0x9E3779B9
    dec = DeviceDecoder(tok[0], device=dev)
    t = torch.zeros(256, dtype=torch.int32, device=dev)
    e = torch.zeros((0, 4), dtype=torch.int32, device=dev)
    n = torch.zeros(0, dtype=torch.int32, device=dev)
    tabs = tok[0].device_tables(dev)
    _build.reset_launches()
    pairs = [
        (stage1_compact(b, ln, 3, wsize, wseed),
         stage1_compact_reference(b, ln, 3, wsize, wseed)),
        (stage1_fused(b, ln, 3, wsize, wseed),
         stage1_fused_reference(b, ln, 3, wsize, wseed)),
        (decode_bytes_compact(t, 0, dec._bytes32, dec._lentab, 0),
         decode_bytes_compact_reference(t, 0, dec._bytes32, dec._lentab, 0)),
        (merge_rows_compact_fused(e, e, n, tabs.packed, tabs.seed1,
                                  tabs.seed2),
         merge_rows_compact(e, e, n, tabs.packed, tabs.seed1, tabs.seed2)),
    ]
    # a bucket merge with no tier, and one whose tier has no row
    inp = bucket_inputs(1, "flat", which="none", B=2, R=64)
    args = [torch.from_numpy(inp[k]).to(dev)
            for k in ("tok", "w", "byte_rank", "plen")]
    for tiers in ([], [(0, 0, 4, 3)]):
        pairs.append(((merge_buckets(args[0].clone(), *args[1:], tiers,
                                     tabs),),
                      (merge_buckets_reference(args[0].clone(), *args[1:],
                                               tiers, tabs),)))
    torch.cuda.synchronize()
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES
    for got, want in pairs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_decode_batch_on_the_card(dev, tok):
    t, words = tok
    rng = random.Random(4)
    texts = [" ".join(rng.choice(words) for _ in range(rng.randint(0, 300)))
             for _ in range(40)] + ["café 中文 \U0001f600", ""]
    ids = [[1] + t.encode(x, False, False) + [2] for x in texts]
    _build.reset_launches()
    got = t.decode_batch(ids, SpecialTokenPolicy.IGNORE)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_store"] >= 1
    assert got == texts
    assert t.decode_batch(ids[:5], SpecialTokenPolicy.KEEP) == [
        t.decode(x, SpecialTokenPolicy.KEEP) for x in ids[:5]]


@pytest.mark.parametrize("kind", ["simple", "general", "utf8"])
def test_flat_encode_on_the_card(dev, tok, kind):
    """The unrouted flat path on the card equals the oracle; the simple
    branch launches the fused stage-1 kernel."""
    t, words = tok
    rng = random.Random(9)
    texts = []
    for i in range(64):
        ws = [rng.choice(words) if rng.random() < 0.9 else "".join(
            rng.choice(string.ascii_lowercase)
            for _ in range(rng.randint(4, 14))) for _ in range(60)]
        doc = " ".join(ws)
        if kind == "general" and i % 8 == 1:
            doc += "  double  12345"
        if kind == "utf8" and i % 8 == 2:
            doc += " café 中文 \U0001f600"
        texts.append(doc)
    enc = t._get_packed_encoder(texts)
    buf, lens = enc.pack(texts)
    _build.reset_launches()
    got = enc._encode_buffer(buf, lens, len(texts), None)
    torch.cuda.synchronize()
    assert (_build.LAUNCHES["stage1_fused"] >= 1) == (kind == "simple")
    assert _build.LAUNCHES["stage1_compact"] == 0
    assert _build.LAUNCHES["merge_rows"] >= 1
    for s_, g in zip(texts, got):
        assert g == encode_ranks(s_, t.ranks), s_


@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("P", [4, 8, 16, 32, 64])
def test_merge_kernel_matches_plain(dev, tok, P, fixed):
    tabs = tok[0].device_tables(dev)
    rng = np.random.default_rng(P)
    B2 = 4096
    n0 = rng.integers(0, P + 1, B2).astype(np.int32)
    rank = rng.choice(np.frombuffer(b"etaoinshrdlucmwfgypb ", np.uint8),
                      size=(B2, P)).astype(np.int32)
    rank[np.arange(P)[None, :] >= n0[:, None]] = -1
    r = torch.from_numpy(rank).to(dev)
    right = torch.cat([r[:, 1:], torch.full_like(r[:, :1], -1)], 1)
    lanes = torch.arange(P, device=dev)[None, :]
    n = torch.from_numpy(n0).to(dev)
    q_ok = (lanes + 1 < n[:, None]) & (r >= 0) & (right >= 0)
    pr = torch.where(q_ok, tabs.dense[torch.where(q_ok, r * 256 + right, 0)],
                     INF).to(torch.int32)
    rounds = P - 1 if fixed else None
    want_r, want_n = merge_rows_compact(r, pr, n, tabs.packed, tabs.seed1,
                                        tabs.seed2, fixed_rounds=rounds)
    got_r, got_n = merge_rows_compact_fused(r, pr, n, tabs.packed, tabs.seed1,
                                            tabs.seed2, fixed_rounds=rounds)
    torch.cuda.synchronize()
    assert bool((want_n < n).any())
    assert torch.equal(got_n, want_n)
    assert torch.equal(got_r, want_r)


@pytest.mark.parametrize("limit", [8, 32])
@pytest.mark.parametrize("which", ["all", "none", "tiny", "short", "long",
                                   "tiny+long"])
@pytest.mark.parametrize("layout", ["routed", "flat"])
def test_merge_buckets_kernel_matches_plain(dev, tok, layout, which, limit):
    """The bucket entry against merge_buckets_reference on every token
    slot: routed and flat words, each bucket empty or not, fallback rows
    mixed in, the P=32 bucket under limit 32, and pieces of control bytes
    whose merges end before their fixed rounds do.  One launch a call with
    a tier, none without."""
    tabs = tok[0].device_tables(dev)
    inp = bucket_inputs(len(which) + limit, layout, limit, which, B=32,
                        R=1024)
    tiers = _bucket_tiers(inp["counts"], CAPS)
    assert bool(tiers) == (which != "none" and
                           (which != "long" or limit > 8))
    args = [torch.from_numpy(inp[k]).to(dev)
            for k in ("w", "byte_rank", "plen")]
    start = inp["start"]
    start = None if start is None else torch.from_numpy(start).to(dev)
    base = torch.from_numpy(inp["tok"]).to(dev)
    want = merge_buckets_reference(base.clone(), *args, tiers, tabs, start)
    before = _build.LAUNCHES["merge_rows"]
    got = merge_buckets(base.clone(), *args, tiers, tabs, start)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["merge_rows"] == before + bool(tiers)
    N = base.shape[0] - 1
    assert torch.equal(got[:N], want[:N]), \
        torch.nonzero(got[:N] != want[:N])[:5].tolist()
    assert bool(tiers) == (not torch.equal(want[:N], base[:N]))


def test_encode_batch_on_the_card(dev, tok):
    t, words = tok
    rng = random.Random(3)
    texts = []
    for i in range(64):
        ws = [rng.choice(words) if rng.random() < 0.9 else "".join(
            rng.choice(string.ascii_lowercase)
            for _ in range(rng.randint(4, 14))) for _ in range(80)]
        doc = " ".join(ws)
        if i % 8 == 1:
            doc += "  double  12345"
        if i % 8 == 2:
            doc += " café 中文 \U0001f600"
        texts.append(doc)
    texts += ["", "ü", "x"]
    _build.reset_launches()
    got = t.encode_batch(texts)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["stage1_compact"] >= 3       # one per route group
    assert _build.LAUNCHES["merge_rows"] >= 1
    for s, g in zip(texts, got):
        assert g == [r + 100 for r in encode_ranks(s, t.ranks)], s


MULTILINGUAL = ("café naïve über 中文 日本語 \U0001f600 Ελληνικά Русский "
                "mañana 한국어 \U0001f680\U0001f389").split()


def test_encode_batch_merges_long_misses_on_the_card(dev, tok, monkeypatch):
    """A batch like the benchmark's multilingual corpus (vocabulary words,
    2.5% OOV words of 3-14 letters, 10% words of other scripts): every
    miss of 9-32 bytes merges in the P=32 bucket on the card, one merge
    launch a packed encode call; none is spliced on the host; every doc
    equals the oracle."""
    from tekken_tpu_torch.ops import packed
    from tekken_tpu_torch.oracle import pretokenize

    t, words = tok
    rng = random.Random(29)

    def word():
        u = rng.random()
        if u < 0.1:
            return rng.choice(MULTILINGUAL)
        if u < 0.125:
            return "".join(rng.choice(string.ascii_lowercase) for _ in range(
                rng.randint(3, 8) if u < 0.12 else rng.randint(9, 14)))
        return rng.choice(words)
    texts = [" ".join(word() for _ in range(250)) for _ in range(64)]
    calls = []
    real = packed.packed_encode

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(packed, "packed_encode", spy)
    _build.reset_launches()
    got = t.encode_batch(texts)
    torch.cuda.synchronize()
    stats = t.last_batch_stats
    assert calls and _build.LAUNCHES["merge_rows"] == len(calls)
    assert stats["fb_spans"] == 0 and stats["overflow_rows"] == 0
    # a vocab token the word map misses counts too
    n_long = sum(9 <= len(b) <= 32 and b not in t.ranks for s in texts
                 for b in (p.encode() for p in pretokenize(s)))
    assert stats["device_long_rows"] >= n_long > 500
    for s, g in zip(texts, got):
        assert g == [r + 100 for r in encode_ranks(s, t.ranks)], s


def test_host_merge_and_world1_encode_on_the_card(dev, tok):
    """Host-merge mode launches stage 1 and no merge; a world-of-one
    DistributedEncoder on the card; both equal the oracle."""
    from tekken_tpu_torch.ops.packed import PackedEncoder
    from tekken_tpu_torch.parallel.encode import DistributedEncoder
    from tekken_tpu_torch.parallel.mesh import make_dp_mesh

    t, words = tok
    rng = random.Random(12)
    texts = [" ".join(rng.choice(words) if rng.random() < 0.9 else "".join(
        rng.choice(string.ascii_lowercase) for _ in range(rng.randint(4, 14)))
        for _ in range(60)) for _ in range(30)] + ["café 中文 \U0001f600", ""]
    want = [encode_ranks(s, t.ranks) for s in texts]
    enc = PackedEncoder(t, rows=32, row_len=1024, device="cuda",
                        merge="host")
    _build.reset_launches()
    assert enc.encode_batch(texts) == want
    torch.cuda.synchronize()
    assert _build.LAUNCHES["stage1_compact"] >= 2
    assert _build.LAUNCHES["merge_rows"] == 0
    for merge in ("device", "host"):
        denc = DistributedEncoder(t, mesh=make_dp_mesh(), rows=32,
                                  row_len=1024, merge=merge)
        assert denc.mesh.device == torch.device("cuda", 0)
        docs, n_bytes, n_tokens = denc.encode_batch(texts)
        assert docs == want
        assert n_bytes == sum(len(s.encode()) for s in texts)
        assert n_tokens == sum(len(d) for d in want)


def test_mel_on_the_card_matches_cpu(dev):
    """cuFFT and the card's float32 matmul (TF32 off) against the CPU
    versions: rtol 1e-4 on the power (plus 1e-6 of its peak), atol 1e-4
    on the log-mel."""
    from tekken_tpu_torch.ops.mel import mel_spectrogram, stft_power

    g = np.random.default_rng(9)
    x = (g.standard_normal((4, 48000)) * 0.2).astype(np.float32)
    got = stft_power(x, 400, 160, device=dev).cpu().numpy()
    want = stft_power(x, 400, 160, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * float(want.max()))
    cfg = tt.AudioSpectrogramConfig(80, 160, 400)
    got = mel_spectrogram(x, cfg, 16000, device=dev)
    assert got.device.type == "cuda"
    want = mel_spectrogram(x, cfg, 16000, device="cpu")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("orig", [44100, 8000, 24000])
def test_resample_on_the_card_matches_cpu(dev, orig):
    from tekken_tpu_torch.ops.resample import resample_poly_batched

    g = np.random.default_rng(10)
    x = (g.standard_normal((3, orig)) * 0.3).astype(np.float32)
    got = resample_poly_batched(x, orig, 16000, device=dev)
    want = resample_poly_batched(x, orig, 16000, device="cpu")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=2e-5)


def test_synthetic_tokenizer_encode_on_the_card(dev, synth):
    """The port's synthetic tokenizer at the toy step's shape (B=8,
    R=128): encode_batch on the card equals the oracle and encode."""
    texts = ["Hello, world! it's a test 123", "the quick brown fox jumps",
             "  whitespace   handling  \n", "tokenizer encoding decoding",
             "café 中文 \U0001f600", "", "numbers 1234567 and more", "x"]
    _build.reset_launches()
    got = synth.encode_batch(texts, True, True)
    torch.cuda.synchronize()
    assert synth.engine_used == "packed-device"
    assert _build.LAUNCHES["stage1_compact"] >= 1
    for t, g in zip(texts, got):
        assert g == synth.encode(t, True, True), t
        assert g[1:-1] == [r + 20 for r in encode_ranks(t, synth.ranks)], t
    assert synth.engine_used == "native-host"


def test_host_merge_with_the_native_engine_on_the_card(dev, tok):
    """Host-mode encode_batch on the card merges every miss with the
    native engine's merge_spans and equals NativeEncoder.encode."""
    from tekken_tpu_torch.native import NativeEncoder
    from tekken_tpu_torch.ops.packed import PackedEncoder

    t, words = tok
    native = NativeEncoder(t)
    rng = random.Random(13)
    texts = [" ".join(rng.choice(words) if rng.random() < 0.8 else "".join(
        rng.choice(string.ascii_lowercase) for _ in range(rng.randint(4, 14)))
        for _ in range(80)) for _ in range(60)] + ["café 中文 \U0001f600", ""]
    enc = PackedEncoder(t, rows=64, row_len=1024, device="cuda", merge="host")
    assert enc._merge_fn.__qualname__ == "NativeEncoder.merge_spans"
    _build.reset_launches()
    got = enc.encode_batch(texts)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["merge_rows"] == 0
    assert enc.stats["fb_spans"] > 100
    assert got == native.encode_batch(texts)
