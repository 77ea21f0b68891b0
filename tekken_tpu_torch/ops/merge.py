"""The merge kernel's wrapper: the counterpart of the JAX package's
ops/pallas_merge.py ``merge_rows_compact_fused``.

CUDA tensors launch csrc/merge_rows.cu, which runs every round of every
row in one launch (the cuckoo probes happen inside the kernel); CPU
tensors take the plain version ``ops.bpe.merge_rows_compact``.  Both give
the same (rank, n_seg).
"""

from __future__ import annotations

import torch

from .. import _build
from .bpe import lane_bits_for, merge_rows_compact


def merge_rows_compact_fused(rank, pr, n_seg, packed_table, seed1: int,
                             seed2: int, fixed_rounds: int | None = None):
    """Merge every row of the (B2, P) compact-shift matrix to completion, or
    for ``fixed_rounds`` rounds.  Returns (rank (B2, P), n_seg (B2,))."""
    if rank.device.type == "cpu":
        return merge_rows_compact(rank, pr, n_seg, packed_table, seed1,
                                  seed2, fixed_rounds)
    B2, P = rank.shape
    lane_bits = lane_bits_for(P)
    dev = rank.device
    if dev.type != "cuda":
        raise ValueError(f"merge_rows_compact_fused runs on cpu or cuda "
                         f"tensors, not {dev.type}")
    for name, t, shape in (("rank", rank, (B2, P)), ("pr", pr, (B2, P)),
                           ("n_seg", n_seg, (B2,))):
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or t.device != dev or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a contiguous int32 tensor of "
                             f"shape {shape} on {dev}")
    S = packed_table.shape[0]
    if (packed_table.dtype != torch.int32 or packed_table.dim() != 2
            or packed_table.shape[1] != 4 or not packed_table.is_contiguous()
            or packed_table.device != dev or S & (S - 1)
            or packed_table.data_ptr() % 16):
        raise ValueError("packed_table must be a contiguous, 16-byte aligned "
                         "(S, 4) int32 tensor with S a power of two on the "
                         "rows' device")
    rounds = P if fixed_rounds is None else int(fixed_rounds)
    rank_out = torch.empty_like(rank)
    n_out = torch.empty_like(n_seg)
    _build.launch(
        "merge_rows", rank.data_ptr(), pr.data_ptr(), n_seg.data_ptr(),
        packed_table.data_ptr(), (S - 1) & 0xFFFFFFFF, seed1 & 0xFFFFFFFF,
        seed2 & 0xFFFFFFFF, B2, P, lane_bits, rounds, rank_out.data_ptr(),
        n_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return rank_out, n_out
