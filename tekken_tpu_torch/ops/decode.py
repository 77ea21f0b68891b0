"""Batched decode on the device: token ids -> byte stream.

The counterpart of the JAX package's ops/decode.py.  The reference's
decode concatenates rank byte spans with lossy UTF-8; here the bytes are
materialized on the device and the UTF-8 decoding and special-token policy
stay on the host (``Tekkenizer.decode_batch``).

Two formulations, both returning (u8[out_cap], total) with zeros past
total:

- ``decode_bytes_compact`` for vocabs whose tokens are at most 32 bytes:
  one row of a padded per-rank table (``padded_table``) per token, stored
  at the token's output offset.  CUDA tensors launch the kernel
  csrc/decode_store.cu (``_decode_store``), which computes the lengths,
  their scan, the bytes and the total in one launch; CPU tensors take the
  plain version ``decode_bytes_compact_reference``.
- ``decode_bytes_impl``, plain torch, for vocabs with a longer token: a
  gather per output byte from the flat byte table (the JAX package's XLA
  formulation).

``DeviceDecoder`` chooses between them and streams a rank sequence of any
length in power-of-two buckets of tokens and output bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

MAX_SW4 = 32


def decode_bytes_impl(tokens, n_tokens: int, flat32, offsets, out_cap: int):
    """tokens (T,) engine ranks (entries past n_tokens ignored) -> (bytes
    u8[out_cap] left-aligned, total).  ``flat32`` is the decode table's
    byte array as int32 and ``offsets`` its (n_ranks + 1,) span offsets.

    Each output byte j gathers ``flat32[d_j + j]``, where d_j, the source
    displacement of the token owning byte j, is the running sum of
    per-token deltas placed at each token's first output byte."""
    dev = tokens.device
    T = tokens.shape[0]
    M = out_cap
    i64 = torch.int64
    valid = torch.arange(T, device=dev) < n_tokens
    tok = torch.where(valid, tokens.to(i64), 0)
    offs = offsets.to(i64)
    start = offs[tok]
    length = torch.where(valid, offs[tok + 1] - start, 0)
    out_off = torch.cumsum(length, 0) - length      # exclusive prefix sum
    total = length.sum()

    # a zero-length token's delta lands on the next token's first byte and
    # telescopes out; offsets at or past M drop into the spare slot
    d = start - out_off
    delta = d - torch.cat([d.new_zeros(1), d[:-1]])
    at = torch.where(valid, out_off, M).clamp(max=M)
    dfill = torch.zeros(M + 1, dtype=i64, device=dev)
    dfill.index_add_(0, at, torch.where(valid, delta, 0))
    dfill = torch.cumsum(dfill[:M], 0)

    j = torch.arange(M, dtype=i64, device=dev)
    vals = flat32[(dfill + j).clamp(0, flat32.shape[0] - 1)]
    out = torch.where(j < total, vals, 0).to(torch.uint8)
    return out, total


def padded_table(flat: np.ndarray, offsets: np.ndarray):
    """The per-rank byte table of ``decode_bytes_compact``: (bytes32
    (n_ranks, sw4) int32, lentab (n_ranks,) int32), sw4 the power of two
    >= max(4, the longest token); None when a token exceeds MAX_SW4
    bytes."""
    lens = (offsets[1:] - offsets[:-1]).astype(np.int32)
    max_len = max(1, int(lens.max()) if lens.size else 1)
    if max_len > MAX_SW4:
        return None
    sw4 = 4
    while sw4 < max_len:
        sw4 <<= 1
    b32 = np.zeros((lens.size, sw4), np.int32)
    cols = np.arange(sw4)
    src = offsets[:-1, None].astype(np.int64) + cols[None, :]
    ok = cols[None, :] < lens[:, None]
    b32[ok] = flat[src[ok]]
    return b32, lens


def _check_compact(tokens, bytes32, lentab, out_cap):
    if tokens.dim() != 1:
        raise ValueError(f"tokens must be (T,), got {tuple(tokens.shape)}")
    if bytes32.dim() != 2 or tuple(lentab.shape) != (bytes32.shape[0],):
        raise ValueError("bytes32 must be (n_ranks, sw4) and lentab "
                         "(n_ranks,)")
    sw4 = bytes32.shape[1]
    if sw4 < 1 or sw4 > MAX_SW4 or sw4 & (sw4 - 1):
        raise ValueError(f"sw4 must be a power of two <= {MAX_SW4}: {sw4}")
    if bytes32.shape[0] < 1:
        raise ValueError("the table has no ranks")
    if tokens.shape[0] * sw4 >= 1 << 31 or not 0 <= out_cap < 1 << 31:
        raise ValueError(f"{tokens.shape[0]} tokens x {sw4} lanes or out_cap "
                         f"{out_cap} out of range")


def _spans(tokens, n_tokens, lentab):
    """(tok clamped to the table, length (0 past n_tokens), exclusive
    cumsum of length, total), int64."""
    T = tokens.shape[0]
    valid = torch.arange(T, device=tokens.device) < n_tokens
    tok = torch.where(valid, tokens.to(torch.int64), 0).clamp(
        0, lentab.shape[0] - 1)
    length = torch.where(valid, lentab[tok].to(torch.int64), 0)
    return tok, length, torch.cumsum(length, 0) - length, length.sum()


def decode_bytes_compact_reference(tokens, n_tokens: int, bytes32, lentab,
                                   out_cap: int):
    """Plain PyTorch version of the decode store kernel.

    tokens (T,) engine ranks (entries past n_tokens ignored; ranks are
    clamped to the table) -> (bytes u8[out_cap], total int32): token i's
    ``lentab[tok]`` bytes from its row of ``bytes32`` at its exclusive-cumsum
    offset, zeros past total, bytes past out_cap dropped.  The lengths are
    at most sw4, as ``padded_table`` builds them."""
    _check_compact(tokens, bytes32, lentab, out_cap)
    sw4 = bytes32.shape[1]
    tok, length, out_off, total = _spans(tokens, n_tokens, lentab)
    jl = torch.arange(sw4, device=tokens.device)[None, :]
    dst = out_off[:, None] + jl
    ok = (jl < length[:, None]) & (dst < out_cap)
    out = torch.zeros(out_cap + 1, dtype=torch.uint8, device=tokens.device)
    out[torch.where(ok, dst, out_cap)] = (bytes32[tok] & 255).to(torch.uint8)
    return out[:out_cap], total.to(torch.int32)


def decode_bytes_compact(tokens, n_tokens: int, bytes32, lentab,
                         out_cap: int):
    """The decode byte store; same contract as
    ``decode_bytes_compact_reference``.  CUDA tensors launch the kernel,
    which computes the lengths, their exclusive cumsum, the bytes and the
    total itself (``_decode_store``); CPU tensors take the plain version."""
    if tokens.device.type == "cpu":
        return decode_bytes_compact_reference(tokens, n_tokens, bytes32,
                                              lentab, out_cap)
    _check_compact(tokens, bytes32, lentab, out_cap)
    dev = tokens.device
    if dev.type != "cuda":
        raise ValueError(f"decode_bytes_compact runs on cpu or cuda tensors, "
                         f"not {dev.type}")
    for name, t in (("tokens", tokens), ("bytes32", bytes32),
                    ("lentab", lentab)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"the tokens' device")
    return _decode_store(tokens, n_tokens, bytes32, lentab, out_cap)


# tokens a CTA of the decode store kernel takes (kTile in decode_store.cu)
DECODE_TILE = 1024
# (device index, stream) -> [status words of the kernel's chained scan,
# epoch of the last call].  A word holds the epoch of the call that wrote
# it, so a call never reads an earlier call's words and the buffer is
# zeroed only when it is made (or when the 32-bit epoch wraps).  Calls on
# one stream run in order; a CUDA graph would replay one epoch, so the
# store is not captured in one.
_SCAN_STATE: dict = {}


def _scan_state(dev, stream: int, tiles: int):
    key = (dev.index, stream)
    st = _SCAN_STATE.get(key)
    if st is None or st[0].numel() < tiles:
        st = _SCAN_STATE[key] = [
            torch.zeros(max(tiles, 64), dtype=torch.int64, device=dev), 0]
    if st[1] == 0xFFFFFFFF:
        st[0].zero_()
        st[1] = 0
    st[1] += 1
    return st[0], st[1]


def _decode_store(tokens, n_tokens: int, bytes32, lentab, out_cap: int):
    """Launch the decode store kernel on the raw inputs: the lengths (0 past
    n_tokens, ranks clamped to the table), their exclusive scan, every byte
    and the zeros from the total to out_cap.  tokens (T,), bytes32 and
    lentab int32, contiguous on one CUDA device, as
    ``decode_bytes_compact`` checks them.  Returns (u8[out_cap], total
    int32)."""
    dev = tokens.device
    T = tokens.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(out_cap, dtype=torch.uint8, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    status, epoch = _scan_state(dev, stream, -(-T // DECODE_TILE))
    if not _build.launch(
            "decode_store", tokens.data_ptr(), T,
            max(0, min(int(n_tokens), T)), lentab.data_ptr(),
            bytes32.shape[0], bytes32.data_ptr(),
            bytes32.shape[1].bit_length() - 1, out.data_ptr(), out_cap,
            total.data_ptr(), status.data_ptr(), status.numel(), epoch,
            stream):
        total.zero_()             # no token and no byte: nothing launched
    return out, total


def _bucket(n: int) -> int:
    """The power of two >= n, at least 256."""
    cap = 256
    while cap < n:
        cap <<= 1
    return cap


class DeviceDecoder:
    """Batched rank-stream decoder against a tokenizer's DecodeTable, on
    ``device``."""

    def __init__(self, tokenizer, capacity: int = 1 << 16, device="cuda"):
        dt = tokenizer.decode_table
        self._device = torch.device(device)
        offsets = np.asarray(dt.offsets)
        self._n_ranks = len(offsets) - 1
        self._np_lens = (offsets[1:] - offsets[:-1]).astype(np.int64)
        self._cap = capacity
        # the compact formulation's table; None (gather formulation, which
        # reads the flat table) for a vocab with a token beyond MAX_SW4 bytes
        self._sw4 = None
        tab = padded_table(np.asarray(dt.flat), offsets)
        if tab is not None:
            b32, lens = tab
            self._sw4 = b32.shape[1]
            self._bytes32 = torch.from_numpy(b32).to(self._device)
            self._lentab = torch.from_numpy(lens).to(self._device)
        else:
            self._flat = torch.from_numpy(
                np.asarray(dt.flat).astype(np.int32)).to(self._device)
            self._offsets = torch.from_numpy(
                offsets.astype(np.int32)).to(self._device)

    def decode_ranks(self, ranks) -> bytes:
        """Engine ranks -> concatenated bytes (at most ``capacity``)."""
        ranks = np.asarray(ranks, dtype=np.int32)
        if ranks.size > self._cap:
            raise ValueError(f"{ranks.size} tokens exceed capacity "
                             f"{self._cap}")
        return self.decode_stream(ranks)

    def byte_ends(self, ranks) -> np.ndarray:
        """int64 running byte count after each rank (ranks in the table)."""
        return np.cumsum(self._np_lens[np.asarray(ranks).reshape(-1)])

    def out_cap_for(self, chunk: np.ndarray) -> int:
        """Power-of-two output-byte bucket (>= 256) for a rank chunk."""
        return _bucket(int(self._np_lens[chunk].sum()))

    def decode_stream(self, ranks, ends=None) -> bytes:
        """Engine ranks of any length -> concatenated bytes, in
        capacity-sized device calls (bytes concatenate freely, so chunking
        at token granularity is exact).  Token counts are bucketed to
        powers of two from 256 to the capacity and output sizes to powers
        of two from 256.  ``ends``, where the caller has it, is
        ``byte_ends(ranks)``.  Raises ValueError for a rank outside the
        table."""
        ranks = np.asarray(ranks, dtype=np.int32).reshape(-1)
        if ranks.size == 0:
            return b""
        lo_r, hi_r = int(ranks.min()), int(ranks.max())
        if lo_r < 0 or hi_r >= self._n_ranks:
            bad = lo_r if lo_r < 0 else hi_r
            raise ValueError(f"rank {bad} outside the decode table "
                             f"(0..{self._n_ranks - 1})")
        if ends is None:
            ends = self.byte_ends(ranks)
        parts = []
        for lo in range(0, ranks.size, self._cap):
            chunk = ranks[lo:lo + self._cap]
            total = int(ends[lo + chunk.size - 1] - (ends[lo - 1] if lo else 0))
            buf = np.zeros(_bucket(chunk.size), dtype=np.int32)
            buf[:chunk.size] = chunk
            toks = torch.from_numpy(buf).to(self._device)
            if self._sw4 is not None:
                out, _ = decode_bytes_compact(toks, chunk.size, self._bytes32,
                                              self._lentab, _bucket(total))
            else:
                out, _ = decode_bytes_impl(toks, chunk.size, self._flat,
                                           self._offsets, _bucket(total))
            parts.append(out[:total].cpu().numpy().tobytes())
        return b"".join(parts)
