"""Packed batched encode on the device: the port's main path.

The counterpart of the JAX package's ops/packed.py, device merge, default
settings: the routed pipeline (routes 1-3) and the unrouted flat path
(``route=None``, ``_flat_encode``).  On the routed pipeline a (B, R)
buffer of document rows goes through:

1. stage 1 (ops/stage1.py, a CUDA kernel): piece-start flags (simple or
   general ASCII rules in-kernel, or route 3's UTF-8 flags from
   ``byte_boundaries``), piece lengths, content dwords, the word-probe
   slot, and the pieces left-compacted per row;
2. the word-exact probe on a (B, C) window (C a tier over the densest
   row): a piece that IS a vocab token of 2..12 (24) bytes is one row
   gather + compares; single bytes are their own token;
3. the bucket build: vocab misses are numbered per length class (2-3,
   4, 5-8, > 8 bytes) and written into disjoint row ranges of one table;
4. the P23 tier: 2-3-byte misses resolve with one dense-table gather and
   one cuckoo probe;
5. the merge buckets: 4-byte and 5-8-byte misses, and longer ones up to
   ``fb_len_limit``, merge in (rows, P) compact-shift matrices through the
   merge kernel (ops/merge.py), the longer ones in the P=32 bucket;
6. on the host: misses longer than ``fb_len_limit`` are merged and
   spliced at their spans, and rows whose pieces overflowed a bucket are
   re-encoded exactly.

``packed_encode``'s limit defaults to the JAX package's, 8 bytes.
``PackedEncoder`` passes ``P_LANES`` (32): the merge kernel runs every
bucket of a call in one launch and a row's rounds in one thread, so a
9-32-byte miss costs one row of the P=32 bucket; only longer misses reach
the host's merge.

The flat path runs at byte granularity with no compaction: a branch
chain picks the stage-1 rules for the whole buffer (the fused stage-1
kernel, ops/stage1.py, for simple ASCII; the general ASCII or UTF-8 flags
in plain torch otherwise), every byte position probes the word map, and
the misses of 2-4, 5-8 and > 8 bytes go to the P=4, P=8 and P=32 merge
buckets (there is no P23 tier).

In host-merge mode (``host_merge=True``, both paths) the device stops
after the emission of singles and hits: every vocab miss is recorded as
a (start, length) span and no merge kernel runs; the host merges and
splices the spans.

The JAX package picks its branches and tiers with ``lax.cond``; here each
predicate and count is read once to the host and the same branch or tier
is taken in Python, so every capacity (and with it ``overflow`` and
``row_bad``) is the reference's.  One departure: the long bucket's tier
covers every row it fills (fallback rows included), not just the
mergeable ones (ROADMAP.md, queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.timing import COUNTERS, StageClock, mark, span
from .bpe import INF, probe2
from .hashing import to_i32
from .merge import merge_buckets
from .pretokenize import (GENERAL_MAX_ROW, ascii_boundaries, byte_boundaries,
                          row_valid)
from .stage1 import stage1_compact, stage1_fused, stage1_planes

__all__ = ["P_LANES", "P_SHORT", "PackedEncoder", "StageClock",
           "default_np_cap", "doc_routes", "host_route", "oracle_merge_fn",
           "packed_encode", "piece_safe_segments", "probe2",
           "splice_host_merges"]

P_LANES = 32
P_SHORT = 8

# C-window ladder as fractions of R: prose runs ~R/5.5 pieces per row
C_FRACTIONS = (0.125, 0.15625, 0.1953125, 0.25, 0.3125, 0.390625, 0.5,
               0.625, 0.78125, 1.0)


def default_np_cap(n_bytes: int) -> int:
    """Default merge-matrix row capacity for an n_bytes buffer (counts only
    vocab-miss pieces).  NP sizes the P=4 bucket and the P23 tier; the P=8
    bucket gets NP/2 and the P=32 bucket NP/8.  A batch whose misses of a
    class exceed its bucket flags overflow, and its rows re-encode exactly
    on the host."""
    return max(64, n_bytes // 8)


def _stage(clock, name, device):
    """A device stage's synchronizing mark, recorded as a child of the
    span it runs in (``tekken.device``)."""
    mark(clock, name, device, child=True)


def _tier(count: int, tiers) -> int:
    """The smallest tier holding ``count`` rows (the largest if none)."""
    tiers = sorted(set(tiers))
    for t in tiers[:-1]:
        if count <= t:
            return t
    return tiers[-1]


def packed_encode(byts, lengths, tables, route: int | None,
                  np_cap: int | None = None, fb_len_limit: int = P_SHORT,
                  clock=None, host_merge: bool = False):
    """Encode a (B, R) uint8 buffer of document rows with a host-chosen
    route (1 simple ASCII / 2 general ASCII / 3 UTF-8) or, with ``route``
    None, on the unrouted flat path, which picks the rules on the device.

    Returns (tok, n_out, fb_start, fb_len, overflow, row_bad):
    tok int32 (B*R,) — tok[i] >= 0 is the token placed at flat byte i, in
    byte order; n_out its count (0-d int32); fb_start / fb_len the byte
    spans of misses longer than ``fb_len_limit`` (-1 / 0 = none), which
    the host merges and splices — (NP32,) on the routed pipeline, (NPT,)
    on the flat path; overflow (int) nonzero when a bucket overflowed;
    row_bad int32 (B,) the rows holding dropped pieces, which the host
    re-encodes.

    With ``host_merge`` the device only emits singles and whole-piece hits
    and records EVERY vocab miss as a span, (NP,) of them, for the host to
    merge (no merge kernel runs, ``fb_len_limit`` plays no part); overflow
    is set when the misses outnumber NP."""
    if route not in (None, 1, 2, 3):
        raise ValueError(f"route must be None, 1, 2 or 3, got {route!r}")
    if not 1 <= fb_len_limit <= P_LANES:
        raise ValueError(f"fb_len_limit must be in 1..{P_LANES}")
    B, R = byts.shape
    N = B * R
    NP = np_cap if np_cap is not None else max(64, N // 16)
    if route is None:
        return _flat_encode(byts, lengths, tables, NP, fb_len_limit, clock,
                            host_merge)
    if route == 2 and R > GENERAL_MAX_ROW:
        # ASCII rows beyond the general rules' row bound: the UTF-8 route's
        # byte-level rules give the same flags on ASCII, for any length
        route = 3
    return _compact_encode(byts, lengths, tables, NP, route, fb_len_limit,
                           clock, host_merge)


def _host_spans(tok, miss, start, plen, NP: int, row_of, B: int):
    """Host-merge mode's tail, shared by both paths: number the misses
    (``miss``, flat, in byte order) and record the first NP as (start,
    length) spans; a miss past NP sets overflow and flags its row."""
    i64 = torch.int64
    dev = tok.device
    N = tok.shape[0] - 1
    fb_id = torch.cumsum(miss.to(i64), 0) - 1
    n_miss = int(miss.sum())
    keep = miss & (fb_id < NP)
    fb_start = torch.full((NP,), -1, dtype=torch.int32, device=dev)
    fb_len = torch.zeros(NP, dtype=torch.int32, device=dev)
    fb_start[fb_id[keep]] = start[keep].to(torch.int32)
    fb_len[fb_id[keep]] = plen[keep].to(torch.int32)
    row_bad = torch.zeros(B + 1, dtype=torch.int32, device=dev)
    row_bad[torch.where(miss & (fb_id >= NP), row_of, B)] = 1
    tok = tok[:N]
    n_out = (tok >= 0).sum(dtype=torch.int32)
    return tok, n_out, fb_start, fb_len, int(n_miss > NP), row_bad[:B]


def _flat_stage1(byts, lengths, n_words, wsize, wseed, clock):
    """The flat path's stage 1: the branch chain over the whole buffer,
    then (plen, slot, ws...) at byte granularity as int32 (B, R) planes
    ((plen,) alone for n_words 0)."""
    dev = byts.device
    is_ascii = bool((byts < 0x80).all())
    if is_ascii:
        is_w = (byts == 32) | ((byts >= 9) & (byts <= 13))
        is_n = (byts >= 48) & (byts <= 57)
        ws_run2 = (is_w[:, 1:] & is_w[:, :-1]).any()
        dig_run4 = (is_n[:, 3:] & is_n[:, 2:-1] & is_n[:, 1:-2]
                    & is_n[:, :-3]).any()
        if not bool(ws_run2 | dig_run4):
            _stage(clock, "branch", dev)
            return stage1_fused(byts, lengths, n_words, wsize, wseed)
    if is_ascii and byts.shape[1] <= GENERAL_MAX_ROW:
        bnd = ascii_boundaries(byts, lengths, "general")
    else:
        # UTF-8, or ASCII rows beyond the general rules' row bound: the
        # byte-level rules give the same flags on ASCII, for any length
        bnd = byte_boundaries(byts, lengths)
    _stage(clock, "branch", dev)
    plen, slot, ws = stage1_planes(byts, lengths, bnd, n_words, wsize, wseed)
    planes = (plen, slot, *ws) if n_words else (plen,)
    return tuple(to_i32(x) for x in planes)


def _flat_encode(byts, lengths, tables, NP: int, fb_len_limit: int, clock,
                 host_merge: bool = False):
    """The unrouted flat path (the JAX package's ``packed_encode_impl``
    with ``route=None``)."""
    B, R = byts.shape
    N = B * R
    dev = byts.device
    # bucket rows pack flat byte positions shifted by 2 bits
    if N >= (1 << 29):
        raise ValueError(f"buffer of {N} bytes exceeds 2^29")
    i64 = torch.int64
    idx = torch.arange(N, dtype=i64, device=dev)
    valid = row_valid(byts, lengths).reshape(N)
    byte_rank = torch.where(valid, byts.reshape(N).to(i64), -1)

    if tables.wseed:
        n_words, maxl = tables.n_words, tables.max_word_len
        wsize = tables.word_rows.shape[0]
    else:
        n_words, maxl, wsize = 0, 0, 1

    s1 = [x.reshape(N) for x in _flat_stage1(byts, lengths, n_words, wsize,
                                               tables.wseed, clock)]
    plen = s1[0].to(i64)
    is_pstart = plen > 0
    multi = plen >= 2
    _stage(clock, "stage1", dev)

    # --- word-exact whole-piece probe at every byte position ---
    if n_words:
        slot, ws = s1[1], s1[2:]
        row = tables.word_rows[slot.to(i64)]                    # (N, W)
        meta = row[:, n_words].to(i64)
        ok = (meta >= 0) & ((meta & 31) == plen)
        for k in range(n_words):
            ok = ok & (row[:, k] == ws[k])
        hit_start = ok & multi & (plen <= maxl)
        found = torch.where(hit_start, meta >> 5, -1)
    else:
        hit_start = torch.zeros_like(multi)
        found = torch.full_like(plen, -1)
    single = is_pstart & (plen == 1)
    # singles and whole-piece hits emit at their start byte; slot N drops
    tok = torch.cat([torch.where(single, byte_rank, found).to(torch.int32),
                     torch.full((1,), -1, dtype=torch.int32, device=dev)])
    mp_mark = multi & ~hit_start
    if host_merge:
        out = _host_spans(tok, mp_mark, idx, plen, NP, idx // R, B)
        _stage(clock, "probe_emit", dev)
        return out

    # --- bucket build: misses of 2-4 / 5-8 / > 8 bytes to the P=4 / P=8 /
    # P=32 buckets, disjoint row ranges of one table ---
    tiny = mp_mark & (plen <= 4)
    short = mp_mark & (plen > 4) & (plen <= P_SHORT)
    long_ = mp_mark & (plen > P_SHORT)

    def ids(m):
        return torch.cumsum(m.to(i64), 0) - 1

    id_t, id_s, id_l = ids(tiny), ids(short), ids(long_)
    NP4 = NP
    NP8 = max(64, NP // 2)
    NP32 = max(64, NP // 8)
    NPT = NP4 + NP8 + NP32
    fb_piece = long_ & (plen > fb_len_limit)
    mergeable = long_ & ~fb_piece
    n_t, n_s, n_l, n_lm, n_ld = torch.stack([
        tiny.sum(), short.sum(), long_.sum(), mergeable.sum(),
        (mergeable & (id_l < NP32)).sum()]).tolist()
    COUNTERS.add("device_long_rows", n_ld)
    overflow = int(n_t > NP4 or n_s > NP8 or n_l > NP32)

    tgt_row = torch.where(
        tiny & (id_t < NP4), id_t, torch.where(
            short & (id_s < NP8), NP4 + id_s, torch.where(
                long_ & (id_l < NP32), NP4 + NP8 + id_l, NPT)))
    # (start, fb, live) in one word: plen is re-read from the flat plen
    # array at the start (plen at a piece start IS its length)
    word = (idx << 2) | (fb_piece.to(i64) << 1) | 1
    w = torch.zeros(NPT + 1, dtype=i64, device=dev)
    w[tgt_row] = word
    w = w[:NPT]
    live = (w & 1) == 1
    start_r = w >> 2
    fb_r = live & ((w & 2) != 0)
    fb_start = torch.where(fb_r, start_r, -1).to(torch.int32)
    fb_len = torch.where(fb_r, plen[start_r.clamp(0, N - 1)], 0).to(
        torch.int32)
    dropped = mp_mark & (tgt_row == NPT)
    row_bad = torch.zeros(B + 1, dtype=torch.int32, device=dev)
    row_bad[torch.where(dropped, idx // R, B)] = 1
    row_bad = row_bad[:B]
    _stage(clock, "probe_emit", dev)

    _merge_buckets(tok, w, byte_rank, s1[0], (n_t, n_s, n_l, n_lm),
                   (NP4, NP8, NP32), tables)
    tok = tok[:N]
    n_out = (tok >= 0).sum(dtype=torch.int32)
    _stage(clock, "merge", dev)
    return tok, n_out, fb_start, fb_len, overflow, row_bad


def _compact_encode(byts, lengths, tables, NP: int, route: int,
                    fb_len_limit: int, clock, host_merge: bool = False):
    B, R = byts.shape
    N = B * R
    dev = byts.device
    # bucket rows pack compact indices j < N shifted by 2 bits
    if N >= (1 << 29):
        raise ValueError(f"buffer of {N} bytes exceeds 2^29")
    i64 = torch.int64

    if tables.wseed:
        n_words, maxl = tables.n_words, tables.max_word_len
        wsize = tables.word_rows.shape[0]
    else:
        n_words, maxl, wsize = 0, 0, 1

    if route == 3:
        bound = byte_boundaries(byts, lengths)
        _stage(clock, "utf8_flags", dev)
        st, pl, sl, *wsc, cnt = stage1_compact(
            byts, lengths, n_words, wsize, tables.wseed, rules="external",
            boundary=bound)
    else:
        st, pl, sl, *wsc, cnt = stage1_compact(
            byts, lengths, n_words, wsize, tables.wseed,
            rules="general" if route == 2 else "simple")
    cmax = int(cnt.max()) if B else 0
    _stage(clock, "stage1", dev)

    valid = row_valid(byts, lengths).reshape(N)
    byte_rank = torch.where(valid, byts.reshape(N).to(i64), -1)

    NP4 = NP
    NP8 = max(64, NP // 2)
    NP32 = max(64, NP // 8)
    NP3 = NP           # 2-3-byte misses dominate real corpora
    NPM = NP4 + NP8 + NP32
    NPT = NPM + NP3

    # --- C window: the smallest tier covering the densest row ---
    C = _tier(cmax, {min(R, max(64, int(R * f))) for f in C_FRACTIONS})
    stc, plc, slc = st[:, :C], pl[:, :C], sl[:, :C]
    wsC = [w[:, :C] for w in wsc]
    live = stc >= 0
    row_base = (torch.arange(B, dtype=i64, device=dev) * R)[:, None]
    fstart = torch.where(live, stc.to(i64) + row_base, -1)        # (B, C)

    # --- word-exact whole-piece probe, piece granularity ---
    if n_words:
        rowv = tables.word_rows[slc.clamp(0, wsize - 1).to(i64)]  # (B, C, W)
        meta = rowv[..., n_words]
        ok = live & (meta >= 0) & ((meta & 31) == plc)
        for k in range(n_words):
            ok = ok & (rowv[..., k] == wsC[k])
        hit = ok & (plc >= 2) & (plc <= maxl)
        found = torch.where(hit, meta >> 5, -1)
    else:
        hit = torch.zeros_like(live)
        found = torch.full_like(plc, -1)
    single = live & (plc == 1)
    # byte tokens ARE their byte value; ws0 is masked to 1 byte
    tokv = torch.where(single, wsC[0] & 0xFF, found)

    miss = live & (plc >= 2) & ~hit
    pos = fstart.reshape(-1)
    plf = plc.reshape(-1)
    jg = (row_base + torch.arange(C, dtype=i64, device=dev)[None, :]
          ).reshape(-1)

    # --- emit singles + hits into the flat token stream (slot N drops) ---
    src = tokv.reshape(-1)
    tok = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    tok[torch.where(src >= 0, pos, N)] = src
    if host_merge:
        out = _host_spans(tok, miss.reshape(-1), pos, plf, NP, pos // R, B)
        _stage(clock, "probe_emit", dev)
        return out

    # --- bucket build: 2-3-byte misses go to the P23 tier, 4 / 5-8 / > 8
    # byte misses to the P=4 / P=8 / P=32 merge buckets ---
    m23f = (miss & (plc <= 3)).reshape(-1)
    missf = (miss & (plc >= 4)).reshape(-1)
    tinym = missf & (plf == 4)
    is3f = (miss & (plc == 3)).reshape(-1)
    shortm = missf & (plf > 4) & (plf <= P_SHORT)
    longm = missf & (plf > P_SHORT)
    fb_piece = longm & (plf > fb_len_limit)

    def ids(m):
        return torch.cumsum(m.to(i64), 0) - 1

    id_23, id_t, id_s, id_l = ids(m23f), ids(tinym), ids(shortm), ids(longm)
    mergeable = longm & ~fb_piece
    n_23, n_t, n_s, n_l, n_lm, n_ld = torch.stack([
        m23f.sum(), tinym.sum(), shortm.sum(), longm.sum(), mergeable.sum(),
        (mergeable & (id_l < NP32)).sum()]).tolist()
    COUNTERS.add("device_long_rows", n_ld)
    overflow = int(n_23 > NP3 or n_t > NP4 or n_s > NP8 or n_l > NP32)

    tgt_row = torch.where(
        tinym & (id_t < NP4), id_t, torch.where(
            shortm & (id_s < NP8), NP4 + id_s, torch.where(
                longm & (id_l < NP32), NP4 + NP8 + id_l, torch.where(
                    m23f & (id_23 < NP3), NPM + id_23, NPT))))
    # merge rows pack the global compact index (row*R + col) and the
    # fallback bit; P23 rows pack the flat byte position and the plen-3 bit
    word = torch.where(
        m23f, (pos << 2) | (is3f.to(i64) << 1) | 1,
        (jg << 2) | (fb_piece.to(i64) << 1) | 1)
    w = torch.zeros(NPT + 1, dtype=i64, device=dev)
    w[tgt_row] = word
    w = w[:NPT]
    dropped = miss.reshape(-1) & (tgt_row == NPT)
    row_bad = torch.zeros(B + 1, dtype=torch.int32, device=dev)
    row_bad[torch.where(dropped, pos // R, B)] = 1
    row_bad = row_bad[:B]
    _stage(clock, "probe_emit", dev)

    if n_23:
        T = _tier(n_23, {64, max(64, NP3 // 64), max(64, NP3 // 16),
                         max(64, NP3 // 4), NP3})
        _p23_tier(tok, w[NPM:NPM + T], byte_rank, tables, N)
    _stage(clock, "p23", dev)

    # merge rows index the compact records: their geometry is (st, pl)
    _merge_buckets(tok, w, byte_rank, pl, (n_t, n_s, n_l, n_lm),
                   (NP4, NP8, NP32), tables, start=st)
    tok = tok[:N]
    n_out = (tok >= 0).sum(dtype=torch.int32)
    _stage(clock, "merge", dev)

    # fallback records (misses past the device-merge limit) sit in the
    # long bucket's rows
    if n_l:
        wl = w[NP4 + NP8:NPM]
        fbl = ((wl & 1) == 1) & ((wl & 2) != 0)
        jj = (wl >> 2).clamp(0, N - 1)
        s = st.reshape(N)[jj].to(i64)
        fb_start = torch.where(fbl & (s >= 0), s + jj // R * R,
                               -1).to(torch.int32)
        fb_len = torch.where(fbl, pl.reshape(N)[jj], 0).to(torch.int32)
    else:
        fb_start = torch.full((NP32,), -1, dtype=torch.int32, device=dev)
        fb_len = torch.zeros(NP32, dtype=torch.int32, device=dev)
    return tok, n_out, fb_start, fb_len, overflow, row_bad


def _p23_tier(tok, wv, byte_rank, tables, N):
    """Resolve 2-3-byte misses in place.  A 2-byte miss's only pair rank IS
    its merged token (dense table); a 3-byte miss takes the dense argmin
    (leftmost on ties) and one cuckoo probe for the second merge."""
    T = wv.shape[0]
    livev = (wv & 1) == 1
    posr = torch.where(livev, wv >> 2, -1)
    is3 = livev & ((wv & 2) != 0)
    pc = posr.clamp(0, N - 1)
    bs = byte_rank[torch.cat([pc, (pc + 1).clamp(0, N - 1),
                              (pc + 2).clamp(0, N - 1)])]
    b0, b1, b2 = bs[:T], bs[T:2 * T], bs[2 * T:]
    q1ok = livev & (b0 >= 0) & (b1 >= 0)
    q2ok = is3 & (b2 >= 0)
    dd = tables.dense[torch.cat([torch.where(q1ok, b0 * 256 + b1, 0),
                                 torch.where(q2ok, b1 * 256 + b2, 0)])]
    p1 = torch.where(q1ok, dd[:T].to(torch.int64), INF)
    p2 = torch.where(q2ok, dd[T:].to(torch.int64), INF)
    any3 = is3 & ((p1 < INF) | (p2 < INF))
    first = p1 <= p2
    ql = torch.where(any3, torch.where(first, p1, b0), -1)
    qr = torch.where(any3, torch.where(first, b2, p2), -1)
    m = probe2(ql, qr, tables.packed, tables.seed1,
               tables.seed2).to(torch.int64)
    hitp = m < INF
    two = livev & ~is3
    t0 = torch.where(two, torch.where(p1 < INF, p1, b0), torch.where(
        is3, torch.where(any3, torch.where(hitp, m, torch.where(
            first, p1, b0)), b0), -1))
    t1 = torch.where(two & (p1 >= INF), b1, torch.where(
        is3 & any3 & ~hitp & ~first, p2, torch.where(is3 & ~any3, b1, -1)))
    t2 = torch.where(is3 & ((any3 & ~hitp & first) | ~any3), b2, -1)
    src = torch.cat([t0, t1, t2])
    dst = torch.cat([posr, posr + 1, posr + 2])
    ok = (src >= 0) & (torch.cat([posr, posr, posr]) >= 0)
    tok[torch.where(ok, dst, N)] = src.to(torch.int32)


def _bucket_tiers(counts, caps):
    """The tiers of the P=4, P=8 and P=32 buckets (rows [0, NP4), [NP4,
    NP4+NP8) and [NP4+NP8, NP4+NP8+NP32) of the bucket words), each the
    smallest tier holding its count, as ``merge_buckets`` takes them: (lo,
    rows, P, fixed rounds or None).  counts = (n_t, n_s, n_l, n_lm): the
    rows each bucket fills, and n_lm the long bucket's mergeable ones;
    caps = (NP4, NP8, NP32).  Empty buckets have no tier."""
    n_t, n_s, n_l, n_lm = counts
    NP4, NP8, NP32 = caps
    tiers = []
    if n_t:
        tiers.append((0, _tier(
            n_t, [64, max(64, NP4 // 16), max(64, NP4 // 4), NP4]), 4, 3))
    if n_s:
        tiers.append((NP4, _tier(
            n_s, [64, max(64, NP8 // 16), max(64, NP8 // 4), NP8]),
            P_SHORT, P_SHORT - 1))
    if n_lm:
        # the tier covers every row the bucket fills: fb rows share the
        # bucket's numbering with the mergeable ones (ROADMAP.md, queue 3)
        tiers.append((NP4 + NP8, _tier(
            min(n_l, NP32), [64, max(64, NP32 // 4), NP32]), P_LANES, None))
    return tiers


def _merge_buckets(tok, w, byte_rank, plen, counts, caps, tables,
                   start=None):
    """Merge every non-empty bucket of the words ``w`` in one
    ``merge_buckets`` call (tiers from ``_bucket_tiers``; ``plen`` and
    ``start`` give the rows' geometry, ops/merge.py)."""
    tiers = _bucket_tiers(counts, caps)
    if tiers:
        merge_buckets(tok, w, byte_rank, plen, tiers, tables, start)


# --------------------------------------------------------------------- #
# host side (numpy)
# --------------------------------------------------------------------- #

def host_route(buf: np.ndarray) -> int:
    """The routing decision over a whole buffer: 1 simple ASCII / 2 general
    ASCII / 3 UTF-8 (padding zeros are neither whitespace nor digits)."""
    if buf.size and int(buf.max()) >= 0x80:
        return 3
    is_w = (buf == 32) | ((buf >= 9) & (buf <= 13))
    if (is_w[:, 1:] & is_w[:, :-1]).any():
        return 2
    is_n = (buf >= 48) & (buf <= 57)
    if (is_n[:, 3:] & is_n[:, 2:-1] & is_n[:, 1:-2] & is_n[:, :-3]).any():
        return 2
    return 1


def doc_routes(buf: np.ndarray) -> np.ndarray:
    """Per-row routing: host_route's predicates row by row (pieces never
    cross rows).  Returns int8[B]; host_route(buf) == doc_routes(buf).max()
    for non-empty buffers."""
    r = np.ones(buf.shape[0], np.int8)
    is_w = (buf == 32) | ((buf >= 9) & (buf <= 13))
    ws2 = (is_w[:, 1:] & is_w[:, :-1]).any(axis=1)
    is_n = (buf >= 48) & (buf <= 57)
    dig4 = (is_n[:, 3:] & is_n[:, 2:-1] & is_n[:, 1:-2]
            & is_n[:, :-3]).any(axis=1)
    r[ws2 | dig4] = 2
    r[(buf >= 0x80).any(axis=1)] = 3
    return r


def piece_safe_segments(doc: str, budget: int) -> list[tuple[str, object]]:
    """Split an oversize document into ('d', chunk) segments of whole
    pre-tokenization pieces of at most ``budget`` bytes — plus ('hp',
    [pieces]) for stretches that cannot be safely cut and ('h', piece)
    for a lone piece larger than ``budget`` (both merged on the host, piece
    by piece; pathological inputs only).  Tekkenizer.encode_batch and
    CorpusEncoder.encode_stream cut their oversize docs with it.

    Exactness: BPE merges never cross piece boundaries (the engine
    encodes pieces independently, reference src/tekkenizer.rs:384).
    Re-tokenizing a chunk is identical to the original pieces iff the
    cut points are SAFE: a chunk may start at any piece start (the
    pattern has no lookbehind — tokenization from a position depends
    only on the text after it), but must END at a boundary whose
    preceding char is NOT whitespace — the ``\\s+(?!\\S)`` lookahead
    and the last-ws-char attach rules re-split a trailing whitespace
    run differently at end-of-chunk (counterexample: original pieces
    ``['\\x0c', ' ']`` re-tokenize as ``['\\x0c ']``).  The doc's own
    end is always safe."""
    import regex as _rx

    from ..oracle import pretokenize

    is_ws = _rx.compile(r"\s").match
    out: list[tuple[str, object]] = []
    cur: list[str] = []       # pieces of the open chunk
    size = 0
    last_safe = 0             # pieces of cur before the last safe cut
    safe_size = 0

    def emit_upto(k: int):
        # flush cur[:k] as a device chunk (k > 0)
        nonlocal cur, size, last_safe, safe_size
        out.append(("d", "".join(cur[:k])))
        cur = cur[k:]
        size -= safe_size
        last_safe, safe_size = 0, 0
        # recompute the safe cut inside the carried-over tail
        acc = 0
        for j, q in enumerate(cur):
            acc += len(q.encode("utf-8"))
            if not is_ws(q[-1]):
                last_safe, safe_size = j + 1, acc

    pieces = pretokenize(doc)
    for idx, p in enumerate(pieces):
        b = len(p.encode("utf-8"))
        if b > budget:
            if last_safe:
                emit_upto(last_safe)
            if cur:
                out.append(("hp", cur))
                cur, size, last_safe, safe_size = [], 0, 0, 0
            out.append(("h", p))
            continue
        if size + b > budget:
            if last_safe:
                emit_upto(last_safe)
            if size + b > budget:
                # still no room: no safe cut in a whole row of pieces
                out.append(("hp", cur))
                cur, size, last_safe, safe_size = [], 0, 0, 0
        cur.append(p)
        size += b
        if not is_ws(p[-1]) or idx == len(pieces) - 1:
            last_safe, safe_size = len(cur), size
    if cur:
        out.append(("d", "".join(cur)))
    return out


def splice_host_merges(out, out_pos, flat, fb_start, fb_len, merge_fn,
                       base: int = 0, clock=None):
    """Merge the recorded miss spans on the host and splice their tokens
    into the device token stream by position.

    out/out_pos: device tokens and their flat byte positions (np arrays);
    flat: the flat input byte buffer; merge_fn(buf, starts, lens) ->
    (tokens back-to-back, counts) with byte_pair_merge semantics.  Token k
    of a span at start s gets position s + k (< s + len, so it never
    collides with another piece's slots).  The spans merged count toward
    ``host_merge_spans``; ``clock`` records the merge and the sort as
    spans."""
    sel = fb_start >= 0
    starts = fb_start[sel].astype(np.int64)
    if starts.size == 0:
        return out, out_pos
    lens = fb_len[sel].astype(np.int64)
    with span("tekken.splice.merge", clock):
        toks, cnts = merge_fn(flat, base + starts, lens)
    COUNTERS.add("host_merge_spans", starts.size)
    with span("tekken.splice.sort", clock):
        cnts = np.asarray(cnts, dtype=np.int64)
        within = np.arange(len(toks), dtype=np.int64) - np.repeat(
            np.cumsum(cnts) - cnts, cnts)
        pos = np.repeat(starts, cnts) + within
        out = np.concatenate([out, np.asarray(toks, out.dtype)])
        out_pos = np.concatenate([out_pos, pos.astype(out_pos.dtype)])
        o = np.argsort(out_pos, kind="stable")
        return out[o], out_pos[o]


def oracle_merge_fn(ranks):
    """byte_pair_merge-based merge_fn for ``splice_host_merges``."""
    from ..oracle import byte_pair_merge

    def fn(flat, starts, lens):
        toks: list[int] = []
        cnts = np.empty(len(starts), np.int32)
        for i, (s, ln) in enumerate(zip(starts, lens)):
            t = byte_pair_merge(flat[s:s + ln].tobytes(), ranks)
            toks.extend(t)
            cnts[i] = len(t)
        return np.asarray(toks, np.int32), cnts
    return fn


class PackedEncoder:
    """Host wrapper over the packed device pipeline for (rows, row_len)
    buffers.  Docs are routed one by one on the host; each route group
    runs in a power-of-two sub-batch of its own, so one UTF-8 doc does not
    send a whole batch down the slower route.

    ``merge="device"`` (default) merges misses of up to ``P_LANES`` (32)
    bytes on the device in the length buckets (the rare longer ones are
    merged on the host by the oracle); ``merge="host"`` has the
    device record every miss as a span, which the host merges with the
    tokenizer's host engine (the native engine's ``merge_spans``) and
    splices.  Rows whose pieces overflowed a bucket are re-encoded by the
    host engine.

    ``stats`` holds the last ``encode_batch``'s increments of
    ``utils.timing.COUNTERS``: the rows re-encoded on the host after a
    bucket overflow, the spans merged and spliced on the host and the
    long bucket's rows merged on the device.
    ``clock`` (a ``StageClock``, measurement only) records the stage marks
    and the layers' spans."""

    def __init__(self, tokenizer, rows: int = 64, row_len: int = 1024,
                 np_cap: int | None = None, device="cuda",
                 merge: str = "device"):
        if merge not in ("host", "device"):
            raise ValueError(f"merge must be 'host' or 'device': {merge!r}")
        self._host_merge = merge == "host"
        self._tables = tokenizer.device_tables(device)
        self._device = self._tables.device
        self._B = rows
        self._R = row_len
        self._np_cap = (np_cap if np_cap is not None
                        else default_np_cap(rows * row_len))
        self._tokenizer = tokenizer   # the host engine of overflow rows
        self._merge_fn = (tokenizer._host_merge_fn() if self._host_merge
                          else oracle_merge_fn(tokenizer.ranks))
        self.stats = dict.fromkeys(COUNTERS.VIEWS, 0)

    def pack(self, texts):
        datas = [t.encode("utf-8") for t in texts]
        if len(datas) > self._B:
            raise ValueError(f"{len(datas)} docs exceed {self._B} rows")
        buf = np.zeros((self._B, self._R), dtype=np.uint8)
        lengths = np.zeros(self._B, dtype=np.int32)
        for i, d in enumerate(datas):
            if len(d) > self._R:
                raise ValueError(f"doc of {len(d)} bytes exceeds row "
                                 f"{self._R}")
            if d:
                buf[i, :len(d)] = np.frombuffer(d, dtype=np.uint8)
            lengths[i] = len(d)
        return buf, lengths

    def encode_batch(self, texts, clock=None):
        before = dict(COUNTERS.totals)
        try:
            return self._encode_routes(texts, clock)
        finally:
            self.stats = COUNTERS.since(before)

    def _encode_routes(self, texts, clock):
        with span("tekken.pack", clock):
            buf, lengths = self.pack(texts)
            routes = doc_routes(buf)[:len(texts)]
            distinct = sorted(set(routes.tolist())) if len(texts) else [1]
            mark(clock, "route_pack")
            route = host_route(buf) if len(distinct) <= 1 else None
        if len(distinct) <= 1:
            return self._encode_buffer(buf, lengths, len(texts), route,
                                       clock)
        result: list[list[int] | None] = [None] * len(texts)
        for r in distinct:
            idx = np.flatnonzero(routes == r)
            Bg = 8
            while Bg < idx.size:
                Bg <<= 1
            Bg = min(Bg, self._B)
            for lo in range(0, idx.size, Bg):
                with span("tekken.pack", clock):
                    sel = idx[lo:lo + Bg]
                    sub_buf = np.zeros((Bg, self._R), dtype=np.uint8)
                    sub_buf[:sel.size] = buf[sel]
                    sub_len = np.zeros(Bg, dtype=np.int32)
                    sub_len[:sel.size] = lengths[sel]
                    mark(clock, "route_pack")
                sub_out = self._encode_buffer(sub_buf, sub_len, sel.size,
                                              int(r), clock)
                for j, i in enumerate(sel):
                    result[int(i)] = sub_out[j]
        return result

    def _encode_buffer(self, buf, lengths, n_docs: int, route: int | None,
                       clock=None):
        """Run the pipeline on one (Bg, R) buffer with a static route, or
        on the unrouted flat path for ``route`` None; splice fb spans and
        re-encode overflow rows on the host."""
        Bg = buf.shape[0]
        np_cap = (self._np_cap if Bg == self._B
                  else max(64, self._np_cap * Bg // self._B))
        dev = self._device
        with span("tekken.upload", clock):
            byts = torch.from_numpy(buf).to(dev)
            lens = torch.from_numpy(lengths).to(dev)
            mark(clock, "upload", dev)
        with span("tekken.device", clock):
            tok, _, fb_start, fb_len, overflow, row_bad = packed_encode(
                byts, lens, self._tables, route, np_cap,
                fb_len_limit=P_LANES, clock=clock,
                host_merge=self._host_merge)
        with span("tekken.readback", clock):
            back = [t.cpu() for t in ((tok, fb_start, fb_len, row_bad)
                                      if overflow else
                                      (tok, fb_start, fb_len))]
            COUNTERS.add("readback_bytes", sum(t.nbytes for t in back))
            tok, fb_start, fb_len = (t.numpy() for t in back[:3])
            bad_rows = (set(np.flatnonzero(back[3].numpy()).tolist())
                        if overflow else set())
            mark(clock, "readback", dev)

        with span("tekken.doc_lists", clock):
            out_pos = np.flatnonzero(tok >= 0).astype(np.int64)
            out = tok[out_pos]
        out, out_pos = splice_host_merges(
            out, out_pos, buf.reshape(-1), fb_start, fb_len, self._merge_fn,
            clock=clock)
        with span("tekken.doc_lists", clock):
            rows = out_pos // self._R
            cut = np.searchsorted(rows, np.arange(n_docs + 1))
            result = [None if i in bad_rows else
                      out[cut[i]:cut[i + 1]].tolist() for i in range(n_docs)]
        if bad_rows:
            with span("tekken.overflow_rows", clock):
                COUNTERS.add("overflow_rows", len(bad_rows))
                for i in sorted(bad_rows):
                    if i < n_docs:
                        data = buf[i, :lengths[i]].tobytes()
                        result[i] = self._tokenizer._host_ranks(
                            data.decode("utf-8"))
        mark(clock, "splice")
        return result
