"""Data-parallel distributed encode over a torch.distributed process group.

The JAX package's ``DistributedEncoder`` runs one controller over a
``jax.sharding.Mesh``: the document rows are sharded over the ``dp`` axis,
each shard runs the packed encode, the counters are ``psum``'d, and the
controller does the host work of every shard.  Here each rank is a
process with one device (SPMD: every rank of the group calls with the same
inputs): it uploads and encodes its own rows and assembles their ranks on
the host as ``PackedEncoder`` does (``ops.packed.assemble_rows``: spans
merged and spliced, overflow rows re-encoded), and the ranks meet in one
``all_reduce`` of the counters and, in ``encode_batch``, one
``all_gather_object`` of each shard's (flat, cuts) arrays.  Documents are
independent, so the sharding is exact.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.packed import (_join, assemble_rows, default_np_cap, doc_routes,
                          encode_route_groups, pack_rows, packed_encode,
                          single_route, split_ids)
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

        Routing is per row group as in PackedEncoder, from the texts:
        when the batch mixes routes, each route's docs are packed into
        their own distributed step of rows a power of two from the mesh
        size up."""
        datas = [t.encode("utf-8") for t in texts]
        routes = doc_routes(texts)
        self.last_overflow_rows = 0
        route = single_route(routes)
        if route is None:
            flat, cuts = encode_route_groups(
                datas, routes, self.mesh.size, self._B,
                lambda docs, rows: pack_rows(docs, rows, self._R),
                self._encode_buffer)
        else:
            buf, lengths = pack_rows(datas, self._B, self._R)
            flat, cuts = self._encode_buffer(buf, lengths, len(texts), route)
        return (split_ids(flat, cuts), sum(map(len, datas)),
                int(flat.size))

    def _encode_buffer(self, buf, lengths, n_docs: int, route: int,
                       clock=None):
        """One distributed step over a packed (Bg, R) buffer, the host
        assembly of this rank's rows, and the gather of every rank's
        (flat, cuts): the first ``n_docs`` rows' ranks, as
        ``PackedEncoder._encode_buffer`` returns them."""
        (tok, _, fb_start, fb_len, _, row_bad, _, _,
         overflow_rows) = self.encode_step(buf, lengths, route=route)
        self.last_overflow_rows += int(overflow_rows)
        per = buf.shape[0] // self.mesh.size
        lo = self.mesh.rank * per
        part = assemble_rows(
            tok.cpu().numpy(), fb_start.cpu().numpy(), fb_len.cpu().numpy(),
            row_bad.nonzero()[:, 0].cpu().numpy(), buf[lo:lo + per],
            lengths[lo:lo + per], min(max(n_docs - lo, 0), per),
            self._merge_fn, self._host_ranks, clock)
        parts = [part]
        if self.mesh.group is not None:
            parts = [None] * self.mesh.size
            dist.all_gather_object(parts, part, group=self.mesh.group)
        return _join(parts)
