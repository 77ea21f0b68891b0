"""PyTorch port: the plain merge (ops/bpe.py) and the merge wrapper on CPU
tensors equal the JAX package's merge_rows_compact and its fused Pallas
kernel (interpret mode), for P = 4, 8 and 32, fixed and looped."""

import random

import numpy as np
import pytest
import torch

from tekken_tpu_torch.ops.bpe import INF, lane_bits_for, merge_rows_compact
from tekken_tpu_torch.ops.merge import merge_rows_compact_fused


def _random_rows(table, rng, B2, P):
    """Random byte-segment rows + initial pair ranks, as the merge tiers
    build them (tests/test_pallas_merge.py)."""
    dense = table.byte_pair_dense()
    rank = np.full((B2, P), -1, np.int32)
    n0 = np.zeros(B2, np.int32)
    for i in range(B2):
        n = rng.randint(0, P)
        n0[i] = n
        for j in range(n):
            # bytes from the trained vocab's alphabet merge deeply
            rank[i, j] = rng.choice(b"etaoinshrdlu ") if rng.random() < 0.8 \
                else rng.randint(0, 255)
    right = np.concatenate([rank[:, 1:], np.full((B2, 1), -1, np.int32)],
                           axis=1)
    lanes = np.arange(P)[None, :]
    q_ok = (lanes + 1 < n0[:, None]) & (rank >= 0) & (right >= 0)
    pr0 = np.where(q_ok, dense[np.where(q_ok, rank * 256 + right, 0)],
                   INF).astype(np.int32)
    return rank, pr0, n0


@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("P", [4, 8, 32])
def test_merge_matches_jax(merged_tokenizer, P, fixed):
    import jax
    import jax.numpy as jnp

    from tekken_tpu.ops.bpe import merge_rows_compact as jax_merge
    from tekken_tpu.ops.pallas_merge import merge_rows_compact_fused as jax_fused

    table = merged_tokenizer.cuckoo_table()
    s1, s2 = int(table.seed1), int(table.seed2)
    rounds = P - 1 if fixed else None
    rank, pr0, n0 = _random_rows(table, random.Random(1000 + P), 64, P)

    args = tuple(map(jnp.asarray, (rank, pr0, n0, table.packed)))
    want_r, want_n = map(np.asarray, jax.jit(
        lambda a, b, c, t: jax_merge(a, b, c, t, s1, s2,
                                     fixed_rounds=rounds))(*args))
    fused_r, fused_n = map(np.asarray, jax.jit(
        lambda a, b, c, t: jax_fused(a, b, c, t, s1, s2,
                                     fixed_rounds=rounds))(*args))

    targs = tuple(map(torch.from_numpy, (rank, pr0, n0, table.packed)))
    got_r, got_n = merge_rows_compact(*targs, s1, s2, fixed_rounds=rounds)
    wr_r, wr_n = merge_rows_compact_fused(*targs, s1, s2,
                                          fixed_rounds=rounds)
    assert (want_n < n0).any()                 # merges really happened
    for r, n in ((got_r, got_n), (wr_r, wr_n)):
        assert r.dtype == torch.int32 and n.dtype == torch.int32
        assert np.array_equal(n.numpy(), want_n)
        assert np.array_equal(n.numpy(), fused_n)
        assert np.array_equal(r.numpy(), want_r)
        for i in range(64):
            k = want_n[i]
            assert np.array_equal(r.numpy()[i, :k], fused_r[i, :k]), i


def test_merge_guards():
    # 25 + lane_bits must fit 31 bits, as the reference asserts
    with pytest.raises(ValueError, match="P=65"):
        lane_bits_for(65)
    assert lane_bits_for(64) == 6
    assert lane_bits_for(32) == 5 and lane_bits_for(4) == 2
    packed = torch.zeros((64, 4), dtype=torch.int32)
    packed[5] = torch.tensor([1, 2, 1 << 24, 0])
    rank = torch.full((2, 4), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^24"):
        merge_rows_compact(rank, torch.full_like(rank, INF),
                           torch.zeros(2, dtype=torch.int32), packed, 1, 2)
