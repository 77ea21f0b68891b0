"""PyTorch port: the table builders, the device tables and the hashes are
identical to the JAX package's, array for array and bit for bit."""

import numpy as np
import pytest
import torch

import tekken_tpu.vocab as jvocab
import tekken_tpu_torch as tt
import tekken_tpu_torch.vocab as tvocab
from tekken_tpu.ops.packed import probe2 as jax_probe2
from tekken_tpu_torch.ops.hashing import pair_slot, u32, word_slot
from tekken_tpu_torch.ops.packed import probe2
from tekken_tpu_torch.tables import tables_from_numpy


def _port(tok):
    md = tt.ModelData.from_json(tok.to_model_data().to_json())
    return tt.Tekkenizer.from_model_data(md, device="cpu")


@pytest.fixture(params=["small", "merged"])
def pair(request, small_tokenizer, merged_tokenizer):
    tok = small_tokenizer if request.param == "small" else merged_tokenizer
    return tok, _port(tok)


def test_cuckoo_and_dense_tables_equal(pair):
    tok, port = pair
    a, b = tok.cuckoo_table(), port.cuckoo_table()
    assert np.array_equal(a.packed, b.packed)
    assert (a.size, a.seed1, a.seed2, a.num_pairs) == \
        (b.size, b.seed1, b.seed2, b.num_pairs)
    assert np.array_equal(a.byte_pair_dense(), b.byte_pair_dense())


def test_word_map_and_decode_table_equal(pair):
    tok, port = pair
    a, b = tok.word_map(), port.word_map()
    assert np.array_equal(a.rows, b.rows)
    assert (a.size, a.seed, a.max_len, a.n_words) == \
        (b.size, b.seed, b.max_len, b.n_words)
    da, db = tok.decode_table, port.decode_table
    assert np.array_equal(da.flat, db.flat)
    assert np.array_equal(da.offsets, db.offsets)
    assert da.max_token_len == db.max_token_len


def test_wide_word_map_equal(merged_tokenizer):
    ranks = merged_tokenizer.ranks
    a = jvocab.WordDirectMap.build(ranks, wide=True)
    b = tvocab.WordDirectMap.build(ranks, wide=True)
    assert np.array_equal(a.rows, b.rows)
    assert (a.size, a.seed, a.n_words) == (b.size, b.seed, b.n_words)


def test_tables_from_numpy_round_trip(merged_tokenizer):
    port = _port(merged_tokenizer)
    table, wm = port.cuckoo_table(), port.word_map()
    tabs = tables_from_numpy(table.packed, table.byte_pair_dense(), wm.rows,
                             table.seed1, table.seed2, wm.seed, "cpu")
    assert np.array_equal(tabs.packed.numpy(), table.packed)
    assert np.array_equal(tabs.dense.numpy(), table.byte_pair_dense())
    assert np.array_equal(tabs.word_rows.numpy(), wm.rows)
    assert (tabs.seed1, tabs.seed2, tabs.wseed) == \
        (table.seed1, table.seed2, wm.seed)
    assert tabs.n_words == wm.n_words
    assert tabs.max_word_len == wm.max_len
    # the tokenizer's own device tables are the same arrays
    own = port.device_tables("cpu")
    assert torch.equal(own.packed, tabs.packed)
    assert torch.equal(own.word_rows, tabs.word_rows)


def test_tables_from_numpy_rejects_wide_ranks():
    packed = np.zeros((64, 4), np.int32)
    packed[3] = [1, 2, 1 << 24, 0]
    with pytest.raises(ValueError, match="2\\^24"):
        tables_from_numpy(packed, np.zeros(65536, np.int32),
                          np.zeros((64, 4), np.int32), 1, 2, 3, "cpu")


def test_pair_and_word_hash_match_numpy():
    rng = np.random.default_rng(3)
    keys = rng.integers(-(1 << 31), 1 << 31, size=(4, 4096), dtype=np.int64)
    keys[:, :8] = [-1, 0, 1, -2, (1 << 31) - 1, -(1 << 31), 255, 65535]
    l, r, c, ln = (k.astype(np.int32) for k in keys)
    for seed in (1, 0x7FFFFFFF, 0x9E3779B9):
        for size in (64, 1 << 20):
            want = jvocab.cuckoo_hash(l, r, seed, size)
            got = pair_slot(torch.from_numpy(l), torch.from_numpy(r), seed,
                            size)
            assert np.array_equal(got.numpy(), want)
            want_w = jvocab.word_hash(l.view(np.uint32), r.view(np.uint32),
                                      c.view(np.uint32), ln & 31, seed, size)
            got_w = word_slot(u32(torch.from_numpy(l)),
                              u32(torch.from_numpy(r)),
                              u32(torch.from_numpy(c)),
                              torch.from_numpy(ln & 31), seed, size)
            assert np.array_equal(got_w.numpy(), want_w)


def test_probe2_matches_jax(merged_tokenizer):
    import jax.numpy as jnp

    table = merged_tokenizer.cuckoo_table()
    rng = np.random.default_rng(11)
    pairs = jvocab._enumerate_pairs(merged_tokenizer.ranks)
    hits = np.asarray(pairs[:200], np.int32)[:, :2]
    rand = rng.integers(-5, 700, size=(2000, 2)).astype(np.int32)
    q = np.concatenate([hits, rand])
    want = np.asarray(jax_probe2(jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]),
                                 jnp.asarray(table.packed), table.seed1,
                                 table.seed2))
    got = probe2(torch.from_numpy(q[:, 0]), torch.from_numpy(q[:, 1]),
                 torch.from_numpy(table.packed), table.seed1, table.seed2)
    assert np.array_equal(got.numpy(), want)
    assert (want[:200] < np.iinfo(np.int32).max).all()   # real hits seen
