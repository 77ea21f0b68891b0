"""The merge kernel's wrappers: the counterpart of the JAX package's
ops/pallas_merge.py ``merge_rows_compact_fused`` and of the merge buckets
of its ops/packed.py ``_merge_buckets``.

Two entry points of csrc/merge_rows.cu, one merge core:

- ``merge_buckets`` merges every row of one encode's bucket tiers in one
  launch: each row takes its piece's bytes as lanes, merges to completion
  and writes its tokens into ``tok`` in place.  CPU tensors take the plain
  version ``merge_buckets_reference`` (a (rows, P) matrix a tier through
  ``ops.bpe.merge_rows_compact``).
- ``merge_rows_compact_fused`` merges a (B2, P) compact-shift matrix;
  CPU tensors take ``ops.bpe.merge_rows_compact``.

Each pair gives the same results.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .bpe import INF, lane_bits_for, merge_rows_compact
from .hashing import MASK32


def _check_table(packed_table, dev):
    S = packed_table.shape[0]
    if (packed_table.dtype != torch.int32 or packed_table.dim() != 2
            or packed_table.shape[1] != 4 or not packed_table.is_contiguous()
            or packed_table.device != dev or S & (S - 1)
            or packed_table.data_ptr() % 16):
        raise ValueError("packed_table must be a contiguous, 16-byte aligned "
                         "(S, 4) int32 tensor with S a power of two on the "
                         "rows' device")


def _check(name, t, dtype, shape, dev):
    if (t.dtype != dtype or not t.is_contiguous() or t.device != dev
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {dev}")


def merge_rows_compact_fused(rank, pr, n_seg, packed_table, seed1: int,
                             seed2: int, fixed_rounds: int | None = None):
    """Merge every row of the (B2, P) compact-shift matrix to completion, or
    for ``fixed_rounds`` rounds.  Returns (rank (B2, P), n_seg (B2,))."""
    if rank.device.type == "cpu":
        return merge_rows_compact(rank, pr, n_seg, packed_table, seed1,
                                  seed2, fixed_rounds)
    B2, P = rank.shape
    lane_bits_for(P)                 # refuses P the fused key cannot hold
    dev = rank.device
    if dev.type != "cuda":
        raise ValueError(f"merge_rows_compact_fused runs on cpu or cuda "
                         f"tensors, not {dev.type}")
    _check("rank", rank, torch.int32, (B2, P), dev)
    _check("pr", pr, torch.int32, (B2, P), dev)
    _check("n_seg", n_seg, torch.int32, (B2,), dev)
    _check_table(packed_table, dev)
    rounds = P if fixed_rounds is None else int(fixed_rounds)
    rank_out = torch.empty_like(rank)
    n_out = torch.empty_like(n_seg)
    _build.launch(
        "merge_rows", rank.data_ptr(), pr.data_ptr(), n_seg.data_ptr(),
        packed_table.data_ptr(), (packed_table.shape[0] - 1) & MASK32,
        seed1 & MASK32, seed2 & MASK32, B2, P, rounds, rank_out.data_ptr(),
        n_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return rank_out, n_out


def merge_buckets_reference(tok, w, byte_rank, plen, buckets, tables,
                            start=None):
    """Plain PyTorch version of the bucket merge.

    tok int32 (N + 1,): the token at each byte, updated in place; slot N
    is scratch for dropped writes (what it holds after the call is not
    part of the result).  w int64: the bucket words, (index << 2) |
    (fb << 1) | live.  byte_rank int64 (N,): each byte's value, -1 outside
    the rows.  With ``start`` None the index is a flat byte start and plen
    the (N,) piece lengths at the starts (the flat path); otherwise it is
    a compact record index into ``start`` (B, R), the row-local piece
    starts, and ``plen`` (B, R), their lengths (the routed path).
    ``buckets``: (lo, rows, P, fixed_rounds) a tier: bucket rows [lo,
    lo + rows) merge in a (rows, P) matrix, for ``fixed_rounds`` rounds or
    to completion (None).  Fallback rows (fb bit) and dead rows merge no
    lane."""
    N = byte_rank.shape[0]
    plen = plen.reshape(-1)
    i64 = torch.int64
    R = start.shape[1] if start is not None else 0
    starts = start.reshape(-1) if start is not None else None

    def rows_fn(lo, rows):
        # bucket rows [lo, lo+rows) -> (piece length, flat start); fb and
        # dead rows take zero lanes and no start
        wv = w[lo:lo + rows]
        live = (wv & 1) == 1
        keep = live & ((wv & 2) == 0)
        jj = (wv >> 2).clamp(0, N - 1)
        if starts is None:
            s = wv >> 2
        else:
            st = starts[jj].to(i64)
            s = torch.where(st >= 0, st + jj // R * R, -1)
        return (torch.where(keep, plen[jj].to(i64), 0),
                torch.where(keep, s, -1))

    for lo, rows, P, fixed_rounds in buckets:
        _merge_tier(tok, byte_rank, rows_fn, lo, rows, P, fixed_rounds,
                    tables, N)
    return tok


def _merge_tier(tok, byte_rank, rows_fn, lo, rows, P, fixed_rounds, tables,
                N):
    """Merge bucket rows [lo, lo+rows) in a (rows, P) matrix and write the
    tokens at start + lane, in place."""
    dev = tok.device
    pos = torch.arange(P, dtype=torch.int64, device=dev)[None, :]
    n0, s0 = rows_fn(lo, rows)
    lane_byte_pos = s0[:, None] + pos
    lane_in = (pos < n0[:, None]) & (s0[:, None] >= 0)
    r0 = torch.where(lane_in, byte_rank[lane_byte_pos.clamp(0, N - 1)], -1)
    right = torch.cat([r0[:, 1:], torch.full_like(r0[:, :1], -1)], dim=1)
    # the first round only pairs single bytes: one dense-table gather
    q_ok = (pos + 1 < n0[:, None]) & (r0 >= 0) & (right >= 0)
    pr0 = torch.where(q_ok, tables.dense[torch.where(q_ok, r0 * 256 + right, 0)],
                      INF)
    r, n = merge_rows_compact(
        r0.to(torch.int32), pr0.to(torch.int32), n0.to(torch.int32),
        tables.packed, tables.seed1, tables.seed2, fixed_rounds=fixed_rounds)
    lane_ok = (pos < n.to(torch.int64)[:, None]) & (s0[:, None] >= 0)
    tok[torch.where(lane_ok, lane_byte_pos, N)] = torch.where(lane_ok, r, -1)


def merge_buckets(tok, w, byte_rank, plen, buckets, tables, start=None):
    """The bucket merge; same contract as ``merge_buckets_reference``.
    CUDA tensors launch the kernel once for all ``buckets`` (at most three,
    P <= 32); CPU tensors take the plain version.  Returns tok."""
    if tok.device.type == "cpu":
        return merge_buckets_reference(tok, w, byte_rank, plen, buckets,
                                       tables, start)
    dev = tok.device
    if dev.type != "cuda":
        raise ValueError(f"merge_buckets runs on cpu or cuda tensors, not "
                         f"{dev.type}")
    N = byte_rank.shape[0]
    _check("tok", tok, torch.int32, (N + 1,), dev)
    _check("byte_rank", byte_rank, torch.int64, (N,), dev)
    if w.dtype != torch.int64 or w.dim() != 1 or not w.is_contiguous() \
            or w.device != dev:
        raise ValueError(f"w must be a contiguous int64 vector on {dev}")
    if start is None:
        _check("plen", plen, torch.int32, (N,), dev)
        R = 0
    else:
        R = start.shape[1] if start.dim() == 2 else 0
        if R == 0 or start.numel() != N:
            raise ValueError(f"start must be (B, R) with B * R = {N}")
        _check("start", start, torch.int32, start.shape, dev)
        _check("plen", plen, torch.int32, start.shape, dev)
    _check("dense", tables.dense, torch.int32, (65536,), dev)
    _check_table(tables.packed, dev)
    if len(buckets) > 3:
        raise ValueError(f"at most 3 buckets a launch, got {len(buckets)}")
    vals = []
    for lo, rows, P, fixed_rounds in buckets:
        if not 1 <= P <= 32 or rows < 0 or lo < 0 or lo + rows > w.shape[0]:
            raise ValueError(f"bucket (lo={lo}, rows={rows}, P={P}) does "
                             f"not fit {w.shape[0]} words with P <= 32")
        vals += [lo, rows, P, P if fixed_rounds is None else fixed_rounds]
    table = (ctypes.c_int * max(len(vals), 1))(*vals)
    _build.launch(
        "merge_rows", len(buckets), ctypes.addressof(table), w.data_ptr(),
        start.data_ptr() if start is not None else None, plen.data_ptr(), R,
        byte_rank.data_ptr(), N, tables.dense.data_ptr(),
        tables.packed.data_ptr(), (tables.packed.shape[0] - 1) & MASK32,
        tables.seed1 & MASK32, tables.seed2 & MASK32, tok.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
        fn_name="tk_merge_buckets")
    return tok
