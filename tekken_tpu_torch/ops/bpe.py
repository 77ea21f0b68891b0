"""Per-row argmin BPE merge in the compact-shift layout: the plain PyTorch
version of the merge kernel (csrc/merge_rows.cu, wrapped by
ops/merge.py).

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
from .hashing import pair_slot

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
