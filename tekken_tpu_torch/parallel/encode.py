"""Data-parallel distributed encode over a torch.distributed process group.

The JAX package's ``DistributedEncoder`` runs one controller over a
``jax.sharding.Mesh``: the document rows are sharded over the ``dp`` axis,
each shard runs the packed encode, the counters are ``psum``'d, and the
controller does the host work of every shard.  Here each rank is a
process with one device (SPMD: every rank of the group calls with the same
inputs): it uploads and encodes its own rows, merges and splices its own
fallback spans and re-encodes its own overflow rows, and the ranks meet in
one ``all_reduce`` of the counters and, in ``encode_batch``, one
``all_gather_object`` of the docs.  Documents are independent, so the
sharding is exact.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.packed import (default_np_cap, doc_routes, host_route,
                          packed_encode, splice_host_merges)
from ..tables import DeviceTables
from .mesh import dp_sharded, make_dp_mesh, replicated


class DistributedEncoder:
    """Multi-GPU data-parallel encoder.

    ``rows`` is the global document-row count (must divide by the mesh
    size); ``row_len`` the padded per-document byte budget.  ``merge`` is
    "device" (merge buckets on the device) or "host" (every miss merged on
    the host, as ``PackedEncoder(merge="host")``).  Every encode call uses
    one shard capacity, ``np_cap`` or ``default_np_cap`` of a full shard,
    whatever the rows of the call (the JAX encoder does not rescale it
    either), so the overflow counts are the JAX package's.
    """

    def __init__(self, tokenizer, mesh=None, rows: int = 64,
                 row_len: int = 1024, np_cap: int | None = None,
                 merge: str = "device"):
        self.mesh = (mesh if mesh is not None
                     else make_dp_mesh(device=tokenizer._device))
        if not self.mesh.member:
            raise ValueError("this process is not a rank of the mesh")
        n = self.mesh.size
        if rows % n:
            raise ValueError(f"rows ({rows}) must divide mesh size ({n})")
        self._B = rows
        self._R = row_len
        self._shard_cap = (np_cap if np_cap is not None
                           else default_np_cap((rows // n) * row_len))
        if merge not in ("host", "device"):
            raise ValueError(f"merge must be 'host' or 'device': {merge!r}")
        self._host_merge = merge == "host"
        # the host engine (native unless the tokenizer was made with
        # native=False) merges the spans in both modes and re-encodes
        # overflow rows
        self._host_ranks = tokenizer._host_ranks
        self._merge_fn = tokenizer._host_merge_fn()
        self.last_overflow_rows = 0  # all-reduced count of the last batch

        # copied once: the whole tables live on every rank's device
        table = tokenizer.cuckoo_table()
        wm = tokenizer.word_map()
        self._tables = DeviceTables(
            packed=replicated(self.mesh, table.packed),
            dense=replicated(self.mesh, table.byte_pair_dense()),
            word_rows=replicated(self.mesh, wm.rows),
            seed1=int(table.seed1), seed2=int(table.seed2),
            wseed=int(wm.seed))

    def encode_step(self, buf: np.ndarray, lengths: np.ndarray,
                    route: int | None = None):
        """One distributed step over a packed (rows, row_len) buffer: this
        rank encodes its rows ``rows/n * rank ...`` with the host-chosen
        ``route`` (1-3, as ops/packed.host_route; None is the unrouted
        flat path).

        Returns (tok, n_out, fb_start, fb_len, overflow, row_bad,
        total_bytes, total_tokens, overflow_rows): the first six are this
        rank's shard, as ``packed_encode`` returns them (fb positions are
        shard-local); the last three 0-d int64 tensors on the rank's
        device, all-reduced over the group in one ``all_reduce``: the
        bytes, the device tokens and the rows holding dropped pieces."""
        byts = dp_sharded(self.mesh, buf)
        lens = dp_sharded(self.mesh, lengths)
        tok, n_out, fb_start, fb_len, overflow, row_bad = packed_encode(
            byts, lens, self._tables, route, self._shard_cap,
            host_merge=self._host_merge)
        counts = torch.stack([lens.sum(dtype=torch.int64),
                              n_out.to(torch.int64),
                              row_bad.sum(dtype=torch.int64)])
        if self.mesh.group is not None:
            dist.all_reduce(counts, group=self.mesh.group)
        return (tok, n_out, fb_start, fb_len, overflow, row_bad,
                counts[0], counts[1], counts[2])

    def encode_batch(self, texts):
        """texts -> (per-doc rank lists in input order, total bytes, total
        tokens), the same on every rank.

        Routing is per row group as in PackedEncoder: when the batch mixes
        routes, each route's docs run in their own distributed step of
        rows a power of two from the mesh size up."""
        if len(texts) > self._B:
            raise ValueError(f"{len(texts)} docs exceed {self._B} rows")
        buf, lengths = self._pack(texts, self._B)
        routes = doc_routes(buf)[:len(texts)]
        distinct = sorted(set(routes.tolist())) if len(texts) else [1]
        if len(distinct) <= 1:
            return self._encode_buffer(buf, lengths, len(texts),
                                       host_route(buf))

        n = self.mesh.size
        results: list = [None] * len(texts)
        total_bytes = 0
        n_tokens = 0
        overflow_rows = 0
        for r in distinct:
            idx = np.flatnonzero(routes == r)
            Bg = n
            while Bg < idx.size:
                Bg <<= 1
            Bg = min(Bg, self._B)
            for lo in range(0, idx.size, Bg):
                sel = idx[lo:lo + Bg]
                sub = [texts[int(i)] for i in sel]
                sub_buf, sub_len = self._pack(sub, Bg)
                docs_g, bytes_g, toks_g = self._encode_buffer(
                    sub_buf, sub_len, len(sub), int(r))
                overflow_rows += self.last_overflow_rows
                total_bytes += bytes_g
                n_tokens += toks_g
                for j, i in enumerate(sel):
                    results[int(i)] = docs_g[j]
        self.last_overflow_rows = overflow_rows
        return results, total_bytes, n_tokens

    def _pack(self, texts, rows: int):
        buf = np.zeros((rows, self._R), dtype=np.uint8)
        lengths = np.zeros(rows, dtype=np.int32)
        for i, t in enumerate(texts):
            d = t.encode("utf-8")
            if len(d) > self._R:
                raise ValueError(f"doc of {len(d)} bytes exceeds row "
                                 f"{self._R}")
            if d:
                buf[i, :len(d)] = np.frombuffer(d, dtype=np.uint8)
            lengths[i] = len(d)
        return buf, lengths

    def _encode_buffer(self, buf, lengths, n_docs: int, route: int):
        """One distributed step over a packed (Bg, R) buffer, this rank's
        host post-processing (fb splice, per-row overflow re-encode), and
        the gather of every rank's docs."""
        (tok, _, fb_start, fb_len, _, row_bad, total_bytes, total_tokens,
         overflow_rows) = self.encode_step(buf, lengths, route=route)

        per = buf.shape[0] // self.mesh.size
        lo = self.mesh.rank * per
        flat = buf[lo:lo + per].reshape(-1)
        tok = tok.cpu().numpy()
        fb_start = fb_start.cpu().numpy()
        fb_len = fb_len.cpu().numpy()
        row_bad = row_bad.cpu().numpy()

        pos = np.flatnonzero(tok >= 0).astype(np.int64)
        block = tok[pos]
        # merge + splice this shard's recorded miss spans (all misses in
        # host mode; only oversize pieces in device mode)
        corrected = bool((fb_start >= 0).any())  # spliced tokens aren't
        if corrected:                             # in the device counts
            block, pos = splice_host_merges(block, pos, flat, fb_start,
                                            fb_len, self._merge_fn)
        cut = np.searchsorted(pos // self._R, np.arange(per + 1))
        docs: list[list[int]] = []
        for r in range(per):
            if row_bad[r]:
                # a bucket overflow corrupts only this row: re-encode it
                # alone on the host
                corrected = True
                data = flat[r * self._R:r * self._R + lengths[lo + r]]
                docs.append(self._host_ranks(data.tobytes().decode("utf-8")))
            else:
                docs.append(block[cut[r]:cut[r + 1]].tolist())

        if self.mesh.group is not None:
            parts: list = [None] * self.mesh.size
            dist.all_gather_object(parts, (docs, corrected),
                                   group=self.mesh.group)
        else:
            parts = [(docs, corrected)]
        docs = [d for part, _ in parts for d in part][:n_docs]
        corrected = any(c for _, c in parts)
        n_tokens = (sum(len(d) for d in docs) if corrected
                    else int(total_tokens))
        self.last_overflow_rows = int(overflow_rows)
        return docs, int(total_bytes), n_tokens
