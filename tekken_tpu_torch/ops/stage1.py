"""Stage 1 of the packed encode: boundary rules, piece geometry, content
dwords, the word-probe hash and, on the routed path, per-row piece
compaction.

The counterpart of the JAX package's ops/pallas_stage1.py, two kernels:

- ``stage1_compact`` (routes 1-3) launches csrc/stage1_compact.cu for
  CUDA tensors and runs the plain version ``stage1_compact_reference`` for
  CPU tensors;
- ``stage1_fused`` (the unrouted flat path's simple-ASCII branch) launches
  csrc/stage1_fused.cu for CUDA tensors and runs ``stage1_fused_reference``
  for CPU tensors.

Both plain versions build on ``stage1_planes``, the byte-level planes
(piece length, probe slot, content dwords) from piece-start flags, which
the flat path's general and UTF-8 branches also use as they are.
"""

from __future__ import annotations

import torch

from .. import _build
from .hashing import MASK32, to_i32, word_slot
from .pretokenize import (BIG, GENERAL_MAX_ROW, _iota, _rcummin, _sh,
                          ascii_boundaries, row_valid)

RULES = {"simple": 0, "general": 1, "external": 2}


def _check(byts, lengths, n_words, word_size, rules, boundary):
    if rules not in RULES:
        raise ValueError(f"rules must be one of {sorted(RULES)}: {rules!r}")
    if byts.dim() != 2:
        raise ValueError(f"byts must be (B, R), got {tuple(byts.shape)}")
    B, R = byts.shape
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    if n_words not in (0, 3, 6):
        raise ValueError(f"n_words must be 0, 3 or 6: {n_words}")
    if word_size < 1 or word_size & (word_size - 1):
        raise ValueError(f"word_size must be a power of two: {word_size}")
    if rules == "external":
        if boundary is None or tuple(boundary.shape) != (B, R):
            raise ValueError("rules='external' takes (B, R) boundary flags")
    if rules == "general" and R > GENERAL_MAX_ROW:
        raise ValueError(f"general rules take rows of <= {GENERAL_MAX_ROW} "
                         f"bytes, got {R}")


def stage1_planes(byts, lengths, bnd, n_words: int, word_size: int,
                  wseed: int):
    """Byte-level stage-1 planes of (B, R) rows from their piece-start flags
    ``bnd`` (bool, already masked to the valid lanes).

    Returns (plen, slot, ws), int64 (B, R) tensors: plen is the piece
    length at a piece start and 0 elsewhere; ws holds ``max(n_words, 1)``
    little-endian content dwords (uint32 values) of the piece starting at
    each lane, masked to its length (0 where no piece starts); slot is the
    word-map probe slot of (ws[0..2], plen) at every lane, the hash of
    zeros where no piece starts (0 everywhere for n_words 0)."""
    valid = row_valid(byts, lengths)
    idx = _iota(byts)

    # piece length at its start: distance to the first last-byte at or
    # after it (a reverse running min)
    is_last = (_sh(bnd, 1, True) | ~_sh(valid, 1, False)) & valid
    last = _rcummin(torch.where(is_last, idx, BIG))
    plen = torch.where(bnd, last - idx + 1, 0)

    # content dwords at starts, masked to plen (uint32 values in int64)
    bu = torch.where(valid, byts.to(torch.int64), 0)
    w = bu | (_sh(bu, 1, 0) << 8) | (_sh(bu, 2, 0) << 16) | (_sh(bu, 3, 0) << 24)

    def msk(m):
        m4 = m.clamp(0, 4)
        return torch.where(m4 >= 4, MASK32,
                           (torch.ones_like(m4) << (m4.clamp(max=3) * 8)) - 1)

    nw = max(n_words, 1)   # singles need ws[0] for the byte value
    ws = [_sh(w, 4 * j, 0) & msk(plen - 4 * j) for j in range(nw)]
    if n_words:
        slot = word_slot(ws[0], ws[1], ws[2], plen, wseed, word_size)
    else:
        slot = torch.zeros_like(plen)
    return plen, slot, ws


def stage1_compact_reference(byts, lengths, n_words: int, word_size: int,
                             wseed: int, rules: str = "simple",
                             boundary=None):
    """Plain PyTorch version of the stage-1 kernel.

    (B, R) uint8 bytes + (B,) lengths -> (start, plen, slot, ws..., cnt):
    ``3 + max(n_words, 1)`` (B, R) int32 arrays of piece records,
    left-compacted per row in piece order and -1 past each row's count,
    then cnt (B,) int32.  ``rules``: "simple" (no whitespace run > 1, no
    digit run > 3; the caller routes), "general" (any ASCII row) or
    "external" (``boundary`` carries the piece-start flags, e.g. the
    UTF-8 route's ``byte_boundaries``)."""
    _check(byts, lengths, n_words, word_size, rules, boundary)
    B, R = byts.shape
    if rules == "external":
        bnd = (boundary != 0) & row_valid(byts, lengths)
    else:
        bnd = ascii_boundaries(byts, lengths, rules)
    plen, slot, ws = stage1_planes(byts, lengths, bnd, n_words, word_size,
                                   wseed)
    nw = len(ws)
    idx = _iota(byts)

    # compaction: record k of a row is its k-th piece start
    mark = plen > 0
    ids = torch.cumsum(mark.to(torch.int64), dim=1) - 1
    rows, cols = torch.nonzero(mark, as_tuple=True)
    tgt = ids[rows, cols]
    out = torch.full((3 + nw, B, R), -1, dtype=torch.int32,
                     device=byts.device)
    for k, v in enumerate([idx.expand(B, R), plen, slot, *ws]):
        out[k, rows, tgt] = to_i32(v[rows, cols])
    cnt = mark.sum(dim=1).to(torch.int32)
    return tuple(out) + (cnt,)


def stage1_compact(byts, lengths, n_words: int, word_size: int, wseed: int,
                   rules: str = "simple", boundary=None):
    """Stage 1 with per-row compaction; same contract as
    ``stage1_compact_reference``.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if byts.device.type == "cpu":
        return stage1_compact_reference(byts, lengths, n_words, word_size,
                                        wseed, rules, boundary)
    _check(byts, lengths, n_words, word_size, rules, boundary)
    B, R = byts.shape
    dev = byts.device
    if dev.type != "cuda":
        raise ValueError(f"stage1_compact runs on cpu or cuda tensors, "
                         f"not {dev.type}")
    if byts.dtype != torch.uint8 or not byts.is_contiguous():
        raise ValueError("byts must be a contiguous uint8 tensor")
    if (lengths.dtype != torch.int32 or not lengths.is_contiguous()
            or lengths.device != dev):
        raise ValueError("lengths must be a contiguous int32 tensor on "
                         "the bytes' device")
    flags = None
    if rules == "external":
        if boundary.dtype == torch.bool:
            boundary = boundary.view(torch.uint8)
        if (boundary.dtype != torch.uint8 or not boundary.is_contiguous()
                or boundary.device != dev):
            raise ValueError("boundary must be a contiguous bool or uint8 "
                             "tensor on the bytes' device")
        flags = boundary
    nw = max(n_words, 1)
    out = torch.empty((3 + nw, B, R), dtype=torch.int32, device=dev)
    cnt = torch.empty(B, dtype=torch.int32, device=dev)
    if not _build.launch(
            "stage1_compact", byts.data_ptr(),
            flags.data_ptr() if flags is not None else None,
            lengths.data_ptr(), B, R, RULES[rules], n_words, nw,
            (word_size - 1) & MASK32, wseed & MASK32, out.data_ptr(),
            cnt.data_ptr(), torch.cuda.current_stream(dev).cuda_stream):
        cnt.zero_()                  # rows of width 0 hold no piece
    return tuple(out) + (cnt,)


def stage1_fused_reference(byts, lengths, n_words: int, word_size: int,
                           wseed: int):
    """Plain PyTorch version of the fused stage-1 kernel.

    (B, R) uint8 simple-ASCII rows (no whitespace run > 1, no digit run
    > 3; the caller routes) + (B,) lengths -> (plen,) for n_words 0, else
    (plen, slot, ws[0..n_words)), each (B, R) int32 at every lane: plen 0,
    dwords 0 and the hash of zeros where no piece starts."""
    _check(byts, lengths, n_words, word_size, "simple", None)
    bnd = ascii_boundaries(byts, lengths, "simple")
    plen, slot, ws = stage1_planes(byts, lengths, bnd, n_words, word_size,
                                   wseed)
    if not n_words:
        return (to_i32(plen),)
    return tuple(to_i32(x) for x in (plen, slot, *ws))


def stage1_fused(byts, lengths, n_words: int, word_size: int, wseed: int):
    """Fused stage 1 without compaction; same contract as
    ``stage1_fused_reference``.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if byts.device.type == "cpu":
        return stage1_fused_reference(byts, lengths, n_words, word_size,
                                      wseed)
    _check(byts, lengths, n_words, word_size, "simple", None)
    B, R = byts.shape
    dev = byts.device
    if dev.type != "cuda":
        raise ValueError(f"stage1_fused runs on cpu or cuda tensors, "
                         f"not {dev.type}")
    if byts.dtype != torch.uint8 or not byts.is_contiguous():
        raise ValueError("byts must be a contiguous uint8 tensor")
    if (lengths.dtype != torch.int32 or not lengths.is_contiguous()
            or lengths.device != dev):
        raise ValueError("lengths must be a contiguous int32 tensor on "
                         "the bytes' device")
    out = torch.empty((2 + n_words if n_words else 1, B, R),
                      dtype=torch.int32, device=dev)
    _build.launch(
        "stage1_fused", byts.data_ptr(), lengths.data_ptr(), B, R, n_words,
        (word_size - 1) & MASK32, wseed & MASK32, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    return tuple(out)
