"""PyTorch port: the differential engines' tables and merge pieces —
``PairTable``, ``CuckooPieceTable`` (with ``direct_map``), the decode
table's padded rows and packed words, ``probe_pairs`` and
``merge_bucket_fn`` — against the JAX package's, array for array.
Integer outputs: the tolerance is exact equality."""

import base64
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tekken_tpu.vocab as jvocab
import tekken_tpu_torch as tt
import tekken_tpu_torch.vocab as tvocab
from tekken_tpu.ops.bpe import merge_bucket_fn as j_merge_bucket_fn
from tekken_tpu.ops.bpe import probe_pairs as j_probe_pairs
from tekken_tpu.oracle import byte_pair_merge, byte_pair_merge_no_whole
from tekken_tpu_torch.ops.bpe import INF, merge_bucket_fn, probe_pairs
from tekken_tpu_torch.ops.hashing import mul32, pair_hash_slot


def _port(tok):
    md = tt.ModelData.from_json(tok.to_model_data().to_json())
    return tt.Tekkenizer.from_model_data(md, device="cpu")


@pytest.fixture(scope="module")
def ports(small_tokenizer, merged_tokenizer):
    return {"small": (small_tokenizer, _port(small_tokenizer)),
            "merged": (merged_tokenizer, _port(merged_tokenizer))}


@pytest.fixture(params=["small", "merged"])
def pair(request, ports):
    return ports[request.param]


def _info(rank, data, cls):
    return cls(rank=rank, token_bytes=base64.b64encode(data).decode(),
               token_str=None)


def test_pair_table_equal(pair):
    tok, port = pair
    a, b = tok.pair_table(), port.pair_table()
    for k in ("key_left", "key_right", "values"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert (a.size, a.max_probes, a.num_pairs) == \
        (b.size, b.max_probes, b.num_pairs)


def test_piece_table_and_direct_map_equal(pair):
    tok, port = pair
    a, b = tok.piece_table(), port.piece_table()
    assert np.array_equal(a.packed, b.packed)
    assert (a.size, a.k, a.seed1, a.seed2) == (b.size, b.k, b.seed1, b.seed2)
    dma, sa = a.direct_map(tok.ranks)
    dmb, sb = b.direct_map(port.ranks)
    assert sa == sb and np.array_equal(dma, dmb)
    for piece in list(port.ranks)[::7] + [b"not a token", b"qx"]:
        assert b.lookup_host(piece, port.decode_table) == \
            a.lookup_host(piece, tok.decode_table)


@pytest.mark.parametrize("row_len", [None, 8])
def test_padded_rows_and_word_packed_equal(pair, row_len):
    tok, port = pair
    da, db = tok.decode_table, port.decode_table
    assert np.array_equal(da.padded_rows(row_len), db.padded_rows(row_len))
    max_len = 32 if row_len is None else 16
    assert np.array_equal(da.word_packed(max_len), db.word_packed(max_len))


def test_direct_map_forced_collisions():
    """A 64-slot table for 257 entries: the greedy-unstable b"xyz" (no
    in-vocab split) keeps its slot, in both packages alike."""
    ranks = {}
    for cls, mod in ((tt.TokenInfo, tvocab), (jvocab.TokenInfo, jvocab)):
        vocab = [_info(i, bytes([i]), cls) for i in range(256)]
        vocab.append(_info(256, b"xyz", cls))
        ranks[mod] = mod.reload_mergeable_ranks(vocab, 512)
    got, seed = tvocab.CuckooPieceTable.build(ranks[tvocab]).direct_map(
        ranks[tvocab], _min_log2=6, slots_per_entry=0)
    want, wseed = jvocab.CuckooPieceTable.build(ranks[jvocab]).direct_map(
        ranks[jvocab], _min_log2=6, slots_per_entry=0)
    assert got.shape[0] == 64 and seed == wseed
    assert np.array_equal(got, want)
    pt = tvocab.CuckooPieceTable.build(ranks[tvocab])
    sig = tvocab.poly_sig31(b"xyz", pt.k)
    s = int(tvocab.cuckoo_hash(sig, 3, seed, 64))
    assert tuple(got[s, :3]) == (sig, 3, 256)


def test_probe_pairs_matches_host_and_jax(merged_tokenizer, ports):
    _, port = ports["merged"]
    table = port.pair_table()
    rng = random.Random(7)
    n_ranks = len(port.ranks)
    live = np.flatnonzero(table.key_left >= 0)
    lefts, rights = [], []
    for k in range(2000):
        if k % 2:
            s = int(live[rng.randrange(len(live))])
            lefts.append(int(table.key_left[s]))
            rights.append(int(table.key_right[s]))
        else:
            lefts.append(rng.randrange(-2, n_ranks))
            rights.append(rng.randrange(-2, n_ranks))
    lefts = np.asarray(lefts, np.int32)
    rights = np.asarray(rights, np.int32)
    args = [torch.from_numpy(a) for a in (table.key_left, table.key_right,
                                          table.values)]
    got = probe_pairs(torch.from_numpy(lefts), torch.from_numpy(rights),
                      *args, table.max_probes)
    assert got.dtype == torch.int32
    got = got.numpy()
    jt = merged_tokenizer.pair_table()
    want = np.asarray(j_probe_pairs(
        jnp.asarray(lefts), jnp.asarray(rights), jnp.asarray(jt.key_left),
        jnp.asarray(jt.key_right), jnp.asarray(jt.values), jt.max_probes))
    assert np.array_equal(got, want)
    for l, r, g in zip(lefts, rights, got):
        w = table.lookup_host(int(l), int(r)) if l >= 0 and r >= 0 else -1
        assert g == (w if w >= 0 else INF)
    assert (got < INF).sum() >= 1000


def test_hash_pieces_match_numpy():
    """The linear-probe slot is vocab.pair_hash; mul32 of two uint32
    tensors is the uint32 product."""
    g = np.random.default_rng(3)
    left = g.integers(-5, 1 << 24, 5000)
    right = g.integers(-5, 1 << 24, 5000)
    got = pair_hash_slot(torch.from_numpy(left), torch.from_numpy(right),
                         1 << 20)
    assert np.array_equal(got.numpy(), jvocab.pair_hash(left, right, 1 << 20))
    a = g.integers(0, 1 << 32, 5000, dtype=np.uint64)
    b = g.integers(0, 1 << 32, 5000, dtype=np.uint64)
    a[:3] = b[:3] = 0xFFFFFFFF
    want = a.astype(np.uint32) * b.astype(np.uint32)
    got = mul32(torch.from_numpy(a.astype(np.int64)),
                torch.from_numpy(b.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def _merge(port_table, pieces, P):
    ranks0 = np.zeros((len(pieces), P), np.int32)
    lens = np.zeros(len(pieces), np.int32)
    for i, p in enumerate(pieces):
        ranks0[i, :len(p)] = np.frombuffer(p, np.uint8)
        lens[i] = len(p)
    t = port_table
    out, n = merge_bucket_fn(P, t.max_probes)(
        torch.from_numpy(ranks0), torch.from_numpy(lens),
        torch.from_numpy(t.key_left), torch.from_numpy(t.key_right),
        torch.from_numpy(t.values))
    return ranks0, lens, out.numpy(), n.numpy()


def test_merge_order_counterexample():
    """vocab {"cd": 256, "bcd": 257, "ab": 258}: "abcd" merges cd, then
    b+cd, to [a, bcd] (lowest rank first), not [ab, cd]."""
    vocab = [_info(i, bytes([i]), tt.TokenInfo) for i in range(256)]
    vocab += [_info(256, b"cd", tt.TokenInfo), _info(257, b"bcd", tt.TokenInfo),
              _info(258, b"ab", tt.TokenInfo)]
    ranks = tvocab.reload_mergeable_ranks(vocab, 512)
    _, _, out, n = _merge(tvocab.PairTable.build(ranks), [b"abcd"], 16)
    assert out[0, :n[0]].tolist() == [ord("a"), 257]
    assert (out[0, n[0]:] == -1).all()


def test_merge_ties_break_left():
    """Equal pair ranks in a row merge leftmost first: "aaa" with "aa" is
    [aa, a], and "aaaaa" [aa, aa, a]."""
    vocab = [_info(i, bytes([i]), tt.TokenInfo) for i in range(256)]
    vocab.append(_info(256, b"aa", tt.TokenInfo))
    ranks = tvocab.reload_mergeable_ranks(vocab, 512)
    _, _, out, n = _merge(tvocab.PairTable.build(ranks),
                          [b"aaa", b"aaaaa", b"baaab"], 8)
    assert [out[i, :n[i]].tolist() for i in range(3)] == [
        [256, 97], [256, 256, 97], [98, 256, 97, 98]]
    assert torch.argmin(torch.tensor([[5, 2, 2, 2]]), dim=1).item() == 1


def test_merge_bucket_matches_jax(merged_tokenizer, ports):
    """200 random pieces of 0-16 bytes at P = 16 (from the merged vocab's
    alphabet, so most merge deeply) against the JAX bucket merge and the
    oracle."""
    _, port = ports["merged"]
    rng = random.Random(11)
    alphabet = b"etaoinshrdlu ,."
    pieces = [bytes(rng.choice(alphabet) for _ in range(rng.randint(0, 16)))
              for _ in range(200)]
    ranks0, lens, out, n = _merge(port.pair_table(), pieces, 16)
    jt = merged_tokenizer.pair_table()
    jout, jn = j_merge_bucket_fn(16, jt.max_probes)(
        jnp.asarray(ranks0), jnp.asarray(lens), jnp.asarray(jt.key_left),
        jnp.asarray(jt.key_right), jnp.asarray(jt.values))
    assert np.array_equal(out, np.asarray(jout))
    assert np.array_equal(n, np.asarray(jn))
    for i, p in enumerate(pieces):
        assert out[i, :n[i]].tolist() == byte_pair_merge_no_whole(
            p, merged_tokenizer.ranks), p
        if p and p not in merged_tokenizer.ranks:
            assert out[i, :n[i]].tolist() == byte_pair_merge(
                p, merged_tokenizer.ranks)


def test_tables_are_cached(ports):
    _, port = ports["merged"]
    assert port.pair_table() is port.pair_table()
    assert port.piece_table() is port.piece_table()
