"""Per-row argmin BPE merge in the compact-shift layout: the plain PyTorch
version of the merge kernel (csrc/merge_rows.cu, wrapped by
ops/merge.py).  Beside it, the differential engines' pieces: the
linear-probe pair lookup ``probe_pairs`` (vocab.PairTable) and the
pointer-array bucket merge ``merge_bucket_fn``, both plain PyTorch (the
JAX package's are XLA, not Pallas).

Exactness note (why not merge many pairs per piece per round): parallel
"local minimum" merging is NOT equivalent to the reference's
lowest-rank-first order.  Counterexample: vocab {a,b,c,d bytes,
"ab":300, "cd":260, "bcd":290} on piece "abcd": sequential merges
cd(260) then b+cd(290) -> [a, bcd]; local-minimum merging fuses (a,b) and
(c,d) at once -> [ab, cd].  Merging is order-free only across pieces, so
the data-parallel unit is one lowest-rank merge per piece per round.
"""

from __future__ import annotations

import torch

from ..vocab import RANK_LIMIT
from .hashing import pair_hash_slot, pair_slot

INF = 2**31 - 1


def probe2(left, right, packed, seed1: int, seed2: int):
    """Cuckoo probe.  left/right int tensors; packed (S, 4) int32.  Returns
    the merged rank (int32) or INF where the pair is absent or either side
    is negative."""
    size = packed.shape[0]
    r1 = packed[pair_slot(left, right, seed1, size)]
    r2 = packed[pair_slot(left, right, seed2, size)]
    hit1 = (r1[..., 0] == left) & (r1[..., 1] == right)
    hit2 = (r2[..., 0] == left) & (r2[..., 1] == right)
    out = torch.where(hit1, r1[..., 2], torch.where(
        hit2, r2[..., 2], torch.full_like(r1[..., 2], INF)))
    return torch.where((left >= 0) & (right >= 0), out, INF).to(torch.int32)


def lane_bits_for(P: int) -> int:
    """Bits of the lane index in the fused min+argmin key.  The key must
    fit int32: min(pr, 2^24) << lane_bits | lane uses 25 + lane_bits bits,
    so P must stay below 64."""
    lane_bits = max(1, (P - 1).bit_length())
    if 25 + lane_bits > 31:
        raise ValueError(f"P={P} overflows the fused min+argmin key")
    return lane_bits


def merge_rows_compact(rank, pr, n_seg, packed_table, seed1: int,
                       seed2: int, fixed_rounds: int | None = None):
    """Per-row argmin BPE merge in a compact-shift layout.

    rank: (B, P) segment ranks, left-aligned (-1 pad); pr: (B, P) pair
    ranks (pr[:, i] pairs segment i with i+1; INF where absent); n_seg:
    (B,).  Each round merges the lowest-rank pair of every row (leftmost
    on ties) and closes the gap with a lane shift.  Returns (rank, n_seg),
    still left-aligned.  ``fixed_rounds`` runs exactly that many rounds
    (finished rows no-op) instead of looping until no row merges."""
    B, P = rank.shape
    dev = rank.device
    lane_bits = lane_bits_for(P)
    if packed_table.device.type == "cpu" and packed_table.numel():
        mx = int(packed_table[:, 2].max())
        if mx >= RANK_LIMIT:
            raise ValueError(f"pair-table rank {mx} >= 2^24 unsupported")
    lane = torch.arange(P, dtype=torch.int64, device=dev)[None, :]
    cap = 1 << 24
    rank = rank.to(torch.int64)
    pr = pr.to(torch.int64)
    n_seg = n_seg.to(torch.int64)

    def min_lane(pr):
        key = ((pr.clamp(max=cap) << lane_bits) | lane).min(dim=1).values
        mrank = key >> lane_bits
        return torch.where(mrank >= cap, INF, mrank), key & ((1 << lane_bits) - 1)

    def body(rank, pr, n_seg, mrank, q):
        do = mrank < INF
        qb = q[:, None]
        nb = torch.gather(rank, 1, torch.stack(
            [(q - 1).clamp(0, P - 1), (q + 2).clamp(0, P - 1)], dim=1))
        left = torch.where(q >= 1, nb[:, 0], -1)
        right2 = torch.where(q + 2 < P, nb[:, 1], -1)
        right_ok = do & (q + 2 < n_seg)
        left_ok = do & (q >= 1)
        new_pl = probe2(torch.where(left_ok, left, -1),
                        torch.where(do, mrank, -1), packed_table,
                        seed1, seed2).to(torch.int64)
        new_pq = probe2(torch.where(do, mrank, -1),
                        torch.where(right_ok, right2, -1), packed_table,
                        seed1, seed2).to(torch.int64)
        rank_sh = torch.cat([rank[:, 1:], torch.full_like(rank[:, :1], -1)], 1)
        pr_sh = torch.cat([pr[:, 1:], torch.full_like(pr[:, :1], INF)], 1)
        rank = torch.where(do[:, None], torch.where(
            lane < qb, rank, torch.where(lane == qb, mrank[:, None], rank_sh)),
            rank)
        pr = torch.where(do[:, None], torch.where(
            lane < qb - 1, pr, torch.where(
                lane == qb - 1, new_pl[:, None], torch.where(
                    lane == qb, new_pq[:, None], pr_sh))), pr)
        n_seg = n_seg - do.to(torch.int64)
        return (rank, pr, n_seg) + min_lane(pr)

    state = (rank, pr, n_seg) + min_lane(pr)
    if fixed_rounds is not None:
        for _ in range(fixed_rounds):
            state = body(*state)
    else:
        while bool((state[3] < INF).any()):
            state = body(*state)
    return state[0].to(torch.int32), state[2].to(torch.int32)


def probe_pairs(left, right, key_left, key_right, values, max_probes: int):
    """Linear-probe pair lookup in a vocab.PairTable on the device.

    left/right: int tensors of rank pairs (negative = invalid query);
    key_left/key_right/values: the table's arrays as tensors.  Probes at
    most ``max_probes`` slots, stopping at an exact key hit or an empty
    slot.  Returns the merged rank (int32) or INF where the pair is absent
    or either side is negative."""
    size = key_left.shape[0]
    left = left.to(torch.int64)
    right = right.to(torch.int64)
    slot = pair_hash_slot(left, right, size)
    found = torch.full_like(left, INF)
    done = torch.zeros_like(left, dtype=torch.bool)
    for _ in range(max_probes):
        kl = key_left[slot]
        hit = (kl == left) & (key_right[slot] == right)
        found = torch.where(~done & hit, values[slot].to(torch.int64), found)
        done = done | hit | (kl < 0)
        slot = (slot + 1) & (size - 1)
    return torch.where((left >= 0) & (right >= 0), found,
                       INF).to(torch.int32)


def make_merge_bucket(P: int, max_probes: int):
    """The per-row argmin BPE merge of a (B, P) bucket of pieces, with
    ``nxt``/``prv`` pointer arrays (no lane shifts): each round merges the
    lowest-rank pair of every row, the leftmost on ties (``torch.argmin``
    returns the first minimal index), and runs while any row has a pair
    below INF.

    Returns ``merge(ranks0, lengths, key_left, key_right, values)`` ->
    (out int32 (B, P) left-aligned and -1-padded, n_out int32 (B,)):
    ranks0 (B, P) the pieces' byte ranks, lengths (B,), and a PairTable's
    arrays as tensors."""

    def merge(ranks0, lengths, key_left, key_right, values):
        if ranks0.dim() != 2 or ranks0.shape[1] != P:
            raise ValueError(f"ranks0 must be (B, {P}), got "
                             f"{tuple(ranks0.shape)}")
        B = ranks0.shape[0]
        dev = ranks0.device
        pos = torch.arange(P, dtype=torch.int64, device=dev)[None, :]
        lens = lengths.to(torch.int64)[:, None]
        alive = pos < lens

        rank = torch.where(alive, ranks0.to(torch.int64), -1)
        nxt = (pos + 1).expand(B, P)
        prv = (pos - 1).expand(B, P)
        right = torch.cat([rank[:, 1:], torch.full_like(rank[:, :1], -1)], 1)
        pr = probe_pairs(rank, right, key_left, key_right, values,
                         max_probes).to(torch.int64)
        pr = torch.where(pos + 1 < lens, pr, INF)

        def gather_row(arr, i, fill):
            ok = (i >= 0) & (i < P)
            v = torch.gather(arr, 1, i.clamp(0, P - 1)[:, None])[:, 0]
            return torch.where(ok, v, fill)

        def probe(a, b):
            return probe_pairs(a, b, key_left, key_right, values,
                               max_probes).to(torch.int64)

        while bool((pr < INF).any()):
            m = torch.argmin(pr, dim=1)                 # leftmost min
            mrank = torch.gather(pr, 1, m[:, None])[:, 0]
            do = mrank < INF

            j = gather_row(nxt, m, P)
            nj = gather_row(nxt, j, P)
            at_m = do[:, None] & (pos == m[:, None])
            at_j = do[:, None] & (pos == j[:, None])

            rank = torch.where(at_m, mrank[:, None], rank)
            alive = alive & ~at_j
            nxt = torch.where(at_m, nj[:, None], nxt)
            prv = torch.where((do & (nj < P))[:, None] & (pos == nj[:, None]),
                              m[:, None], prv)
            pr = torch.where(at_j, INF, pr)

            new_pm = probe(torch.where(do, mrank, -1),
                           gather_row(rank, nj, -1))
            pr = torch.where(at_m, new_pm[:, None], pr)

            pm = gather_row(prv, m, -1)
            r_pm = torch.where(gather_row(alive, pm, False),
                               gather_row(rank, pm, -1), -1)
            new_pp = probe(r_pm, torch.where(do, mrank, -1))
            pr = torch.where((do & (pm >= 0))[:, None] & (pos == pm[:, None]),
                             new_pp[:, None], pr)

        # left-align the surviving ranks; -1 padding
        order = torch.cumsum(alive.to(torch.int64), dim=1) - 1
        rows = torch.arange(B, device=dev)[:, None].expand(B, P)
        out = torch.full((B, P), -1, dtype=torch.int32, device=dev)
        out[rows[alive], order[alive]] = rank[alive].to(torch.int32)
        return out, alive.sum(dim=1, dtype=torch.int32)

    return merge


def merge_bucket_fn(P: int, max_probes: int):
    """The bucket merge of width ``P`` (``make_merge_bucket``; the JAX
    package caches its jitted function here, a torch closure needs no
    cache)."""
    return make_merge_bucket(P, max_probes)
