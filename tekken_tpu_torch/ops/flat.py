"""The flat encode engine: boundaries + BPE merge over a flat byte buffer,
in plain PyTorch on the device.

The differential-testing engine, not the production path (that is
ops/packed.py): an independent formulation of the same semantics, held
against the oracle and the packed engine, which launches none of the CUDA
kernels.  Documents are packed into rows of a (B, row_len) byte matrix;
piece boundaries are computed per row (``byte_boundaries``; docs are
independent); the BPE merge then runs on the flattened buffer with
per-piece lowest-rank-first semantics: each round performs one argmin
merge in every piece at once, found by a piece-segmented lexicographic
min scan, and pair ranks come from the linear-probe ``vocab.PairTable``.
Pieces whose bytes ARE a vocab token take the whole-piece fast path
first: a segmented polynomial signature, a cuckoo probe of
``vocab.CuckooPieceTable`` and an exact byte verification.

Exactness: the merge order inside a piece is the scalar oracle's (see
ops/bpe.py for why several merges in one piece per round are unsafe);
pieces are independent, so merging across pieces at once is free.  Mirrors
the JAX package's ops/flat.py.
"""

from __future__ import annotations

import numpy as np
import torch

from .bpe import INF, probe2, probe_pairs
from .hashing import MASK32, mul32
from .pretokenize import _cummax, _rcummin, byte_boundaries, row_valid


def _scan(combine, xs):
    """Inclusive scan of the tuple of tensors ``xs`` along the last axis by
    log doubling (Hillis-Steele): at offset d = 1, 2, 4, ... each element
    becomes ``combine(x[i - d], x[i])``.  ``combine`` must be associative;
    its first operand is the earlier element (the combines here do not
    commute)."""
    n = xs[0].shape[-1]
    d = 1
    while d < n:
        c = combine(tuple(x[..., :n - d] for x in xs),
                    tuple(x[..., d:] for x in xs))
        xs = tuple(torch.cat([x[..., :d], y], dim=-1) for x, y in zip(xs, c))
        d <<= 1
    return xs


def _seg_lexmin_suffix(values, idx, end_mark):
    """Per-segment suffix lexicographic (value, idx) min; segments delimited
    by end_mark=True at their last element (the scan runs right to
    left)."""
    def flip(x):
        return torch.flip(x, [-1])

    def combine(a, b):
        va, ia, ra = a
        vb, ib, rb = b
        take_b = (vb < va) | ((vb == va) & (ib < ia))
        mv = torch.where(take_b, vb, va)
        mi = torch.where(take_b, ib, ia)
        return (torch.where(rb, vb, mv), torch.where(rb, ib, mi), ra | rb)

    v, i, _ = _scan(combine, (flip(values), flip(idx), flip(end_mark)))
    return flip(v), flip(i)


def _seg_polyhash(byte_vals, boundary, k: int):
    """Per-position polynomial hash of the piece prefix ending there:
    ``h[i] = sum_j b[j] * k^(i-j) mod 2^32`` over the piece holding i (reset
    at boundary=True), as int64 in [0, 2^32).  At a piece's last byte it is
    the piece's ``vocab.poly_sig``: the hash of a concatenation is
    ``h_a * k^len_b + h_b``, so one segmented scan gives every piece's
    signature.  The products are tensor by tensor, so they go through
    ``mul32``."""
    h0 = byte_vals.to(torch.int64) & MASK32
    p0 = torch.full_like(h0, k & MASK32)

    def combine(a, b):
        ha, pa, ra = a
        hb, pb, rb = b
        return (torch.where(rb, hb, (mul32(ha, pb) + hb) & MASK32),
                torch.where(rb, pb, mul32(pa, pb)),
                ra | rb)

    h, _, _ = _scan(combine, (h0, p0, boundary))
    return h


def flat_encode_impl(byts, lengths, key_left, key_right, values,
                     max_probes: int, piece_packed=None, token_byte_rows=None,
                     poly_k: int = 0, pseed1: int = 0, pseed2: int = 0):
    """Flat encode of a (B, R) uint8 buffer of document rows, on its
    device.

    Returns (out int32 (N,) left-aligned and -1-padded, out_pos int32 (N,)
    the flat byte position of each output token, n_out 0-d int32), N =
    B*R.  key_left/key_right/values are a vocab.PairTable's arrays as
    tensors.  With ``piece_packed`` (a vocab.CuckooPieceTable's packed
    array) and ``token_byte_rows`` (DecodeTable.padded_rows, (V, Lcap)),
    pieces whose bytes ARE a vocab token encode as that token before any
    merging (the reference engine's semantics).

    The merge loop reads ``any(pair rank < INF)`` on the host once a
    round, as the JAX package's while_loop condition does on the
    device."""
    B, R = byts.shape
    N = B * R
    dev = byts.device

    boundary = byte_boundaries(byts, lengths).reshape(N)
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    valid = row_valid(byts, lengths).reshape(N)
    one = torch.ones(1, dtype=torch.bool, device=dev)

    piece_id = torch.cumsum(boundary.to(torch.int64), dim=0) - 1
    rank = torch.where(valid, byts.reshape(N).to(torch.int64), -1)
    nxt = idx + 1
    prv = idx - 1
    alive = valid
    pstart = _cummax(torch.where(boundary, idx, -1))

    def gather(arr, i, fill):
        ok = (i >= 0) & (i < N)
        return torch.where(ok, arr[i.clamp(0, N - 1)], fill)

    def probe(left, right):
        return probe_pairs(left, right, key_left, key_right, values,
                           max_probes).to(torch.int64)

    boundary_next = torch.cat([boundary[1:], one])
    right0 = torch.where(~boundary_next,
                         torch.cat([rank[1:], -one.to(torch.int64)]), -1)
    pr = torch.where(valid, probe(rank, right0), INF)

    if piece_packed is not None and poly_k:
        # whole-piece fast path
        next_valid = torch.cat([valid[1:], ~one])
        is_last = (boundary_next | ~next_valid) & valid
        offset = idx - pstart
        last_pos = _rcummin(torch.where(is_last, idx, 1 << 30))
        plen = torch.where(valid, last_pos - pstart + 1, 0)

        byte_u = torch.where(valid, byts.reshape(N).to(torch.int64), 0)
        h = _seg_polyhash(byte_u, boundary, poly_k)
        pend = pstart + plen - 1
        sig = gather(h, pend, 0)
        cand = probe2(sig & 0x7FFFFFFF,
                      torch.where(valid & (plen >= 2), plen, -1),
                      piece_packed, pseed1, pseed2).to(torch.int64)
        found = torch.where(cand == INF, -1, cand)

        # exact verification: the candidate's byte at this offset
        V, Lcap = token_byte_rows.shape
        tb_flat = token_byte_rows.reshape(V * Lcap)
        vidx = (found.clamp(min=0) * Lcap + offset).clamp(0, V * Lcap - 1)
        ok_pos = ((found >= 0) & (tb_flat[vidx].to(torch.int64) == byte_u)
                  & valid)

        # segmented AND over each piece (a suffix scan), read at its start
        def and_combine(a, b):
            va, ra = a
            vb, rb = b
            return torch.where(rb, vb, va & vb), ra | rb

        ok_all, _ = _scan(and_combine, (torch.flip(ok_pos, [0]),
                                        torch.flip(is_last, [0])))
        ok_at_start = gather(torch.flip(ok_all, [0]), pstart, False)
        hit = (found >= 0) & ok_at_start & (plen >= 2) & valid

        rank = torch.where(hit & boundary, found, rank)
        alive = alive & ~(hit & ~boundary)
        pr = torch.where(hit, INF, pr)

    while bool((pr < INF).any()):
        sfx_v, sfx_i = _seg_lexmin_suffix(pr, idx, boundary_next)
        min_v = gather(sfx_v, pstart, INF)
        min_i = gather(sfx_i, pstart, -1)
        is_m = (pr < INF) & (min_v == pr) & (min_i == idx)

        j = torch.where(is_m, nxt, N)
        nj = gather(nxt, j, N)
        at_j = torch.zeros(N, dtype=torch.bool, device=dev)
        at_j[j[is_m & (j < N)]] = True

        rank = torch.where(is_m, pr, rank)
        alive = alive & ~at_j
        nxt = torch.where(is_m, nj, nxt)
        sel = is_m & (nj < N)
        prv = prv.index_put((nj[sel],), idx[sel])
        pr = torch.where(at_j, INF, pr)

        # the new pair at each merge: (rank[m], rank[nxt[m]])
        same = gather(piece_id, nxt, -2) == piece_id
        r_right = torch.where(same & is_m, gather(rank, nxt, -1), -1)
        pr = torch.where(is_m, probe(torch.where(is_m, rank, -1), r_right),
                         pr)

        # the new pair before it: (rank[prv[m]], rank[m])
        pm = torch.where(is_m, prv, -1)
        pm_ok = (pm >= 0) & (gather(piece_id, pm, -2) == piece_id)
        new_pp = probe(torch.where(pm_ok, gather(rank, pm, -1), -1),
                       torch.where(pm_ok, rank, -1))
        pr = pr.index_put((pm[pm_ok],), new_pp[pm_ok])

    order = torch.cumsum(alive.to(torch.int64), dim=0) - 1
    out = torch.full((N,), -1, dtype=torch.int32, device=dev)
    out[order[alive]] = rank[alive].to(torch.int32)
    out_pos = torch.full((N,), -1, dtype=torch.int32, device=dev)
    out_pos[order[alive]] = idx[alive].to(torch.int32)
    return out, out_pos, alive.sum(dtype=torch.int32)


class FlatEncoder:
    """Host wrapper: documents -> flat encode on ``device`` -> per-doc rank
    lists.

    The reference / testing engine (``PackedEncoder``, ops/packed.py, is
    the production path), with the whole-piece fast path, so parity with
    the oracle holds also on vocabularies with merge-unreachable tokens.
    Its tables are copied to ``device`` once, here."""

    def __init__(self, tokenizer, rows: int = 64, row_len: int = 1024,
                 device="cuda"):
        self._device = torch.device(device)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)

        table = tokenizer.pair_table()
        self._key_left = put(table.key_left)
        self._key_right = put(table.key_right)
        self._values = put(table.values)
        self._max_probes = int(table.max_probes)
        pt = tokenizer.piece_table()
        self._piece_packed = put(pt.packed)
        self._token_byte_rows = put(tokenizer.decode_table.padded_rows())
        self._poly_k = int(pt.k)
        self._pseed1 = int(pt.seed1)
        self._pseed2 = int(pt.seed2)
        self._B = rows
        self._R = row_len

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

    def encode_batch(self, texts):
        buf, lengths = self.pack(texts)
        out, out_pos, n_out = flat_encode_impl(
            torch.from_numpy(buf).to(self._device),
            torch.from_numpy(lengths).to(self._device),
            self._key_left, self._key_right, self._values, self._max_probes,
            piece_packed=self._piece_packed,
            token_byte_rows=self._token_byte_rows, poly_k=self._poly_k,
            pseed1=self._pseed1, pseed2=self._pseed2)
        n = int(n_out)
        out = out[:n].cpu().numpy()
        rows = out_pos[:n].cpu().numpy() // self._R
        cut = np.searchsorted(rows, np.arange(len(texts) + 1))
        return [out[cut[i]:cut[i + 1]].tolist() for i in range(len(texts))]
