"""Streaming corpus encoder: sharded text files -> DP encode -> counters.

A corpus sharded into files is streamed batch by batch through the
DistributedEncoder (document rows sharded over the ranks, tables copied to
every rank, byte/token counters all-reduced), with throughput metering.
Output token streams are written as JSONL (by rank 0 of the mesh) or
consumed by a callback (on every rank: each gets the whole batch).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable, Iterator, Optional

from ..ops.packed import piece_safe_segments
from ..utils.timing import Meter
from .encode import DistributedEncoder


def iter_corpus_lines(paths: Iterable[str]) -> Iterator[str]:
    """Stream documents (one per line) from a list of shard files."""
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    yield line


def find_shards(root: str, suffix: str = ".txt") -> list[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(suffix):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


class CorpusEncoder:
    """Batch-streaming wrapper around DistributedEncoder."""

    def __init__(self, tokenizer, mesh=None, rows: int = 64,
                 row_len: int = 2048):
        self._enc = DistributedEncoder(tokenizer, mesh=mesh, rows=rows,
                                       row_len=row_len)
        self._rows = rows
        self._row_len = row_len
        self._ranks = tokenizer.ranks
        self._shift = tokenizer.num_special_tokens()
        self.meter = Meter()

    def encode_stream(
        self,
        docs: Iterable[str],
        on_batch: Optional[Callable] = None,
        add_special_shift: bool = True,
    ) -> dict:
        """Encode a document stream; returns aggregate counters.

        ``on_batch(doc_ids: list[list[int]])`` receives batches of public
        token ids in input order.  Documents longer than the row budget are
        split at piece-safe boundaries and ride the device path as multiple
        rows (their ids concatenate exactly); only a single piece larger
        than a whole row — pathological input — touches the host oracle.
        """
        from ..oracle import byte_pair_merge

        shift = self._shift if add_special_shift else 0
        # device-pending rows and, per logical doc, its segment plan:
        # ('d', pending_index) awaiting a device result, ('r', ranks) a
        # device result, ('hr', ranks) a host-encoded oversize piece
        pending: list[str] = []
        plans: list[list[tuple[str, object]]] = []
        emitted = 0
        total_docs = 0
        n_oversized = 0

        def flush(tail_plan=None):
            nonlocal pending, emitted
            if tail_plan is not None:
                plans.append(tail_plan)
            if pending:
                with self.meter.measure():
                    ids, n_bytes, n_tokens = self._enc.encode_batch(pending)
                self.meter.bytes_total += n_bytes
                self.meter.tokens_total += n_tokens
                for plan in plans[emitted:]:
                    for k, (kind, val) in enumerate(plan):
                        if kind == "d":
                            plan[k] = ("r", ids[val])
                pending = []
            if tail_plan is not None:
                plans.pop()  # caller keeps filling it
            # emit completed documents in input order
            out_ids: list[list[int]] = []
            while emitted < len(plans) and all(
                    k in ("r", "hr") for k, _ in plans[emitted]):
                doc_ids: list[int] = []
                for _, val in plans[emitted]:
                    doc_ids.extend(val)
                out_ids.append([t + shift for t in doc_ids])
                plans[emitted] = []  # free memory
                emitted += 1
            if out_ids and on_batch is not None:
                on_batch(out_ids)

        for doc in docs:
            total_docs += 1
            data_len = len(doc.encode("utf-8"))
            if data_len <= self._row_len:
                segments = [("d", doc)]
            else:
                n_oversized += 1
                segments = piece_safe_segments(doc, self._row_len)
            plan: list[tuple[str, object]] = []
            for kind, text in segments:
                if kind in ("h", "hp"):
                    group = [text] if kind == "h" else text
                    n_b = sum(len(p.encode("utf-8")) for p in group)
                    with self.meter.measure(n_bytes=n_b):
                        ranks = []
                        for p in group:
                            ranks.extend(byte_pair_merge(
                                p.encode("utf-8"), self._ranks))
                    self.meter.tokens_total += len(ranks)
                    plan.append(("hr", ranks))
                else:
                    if len(pending) == self._rows:
                        flush(tail_plan=plan)  # mid-doc batch boundary
                    plan.append(("d", len(pending)))
                    pending.append(text)
            plans.append(plan)
            if len(pending) >= self._rows:
                flush()
        flush()

        return {
            "documents": total_docs,
            "oversized_documents": n_oversized,
            **self.meter.summary(),
        }

    def encode_files_to_jsonl(self, shard_paths: Iterable[str],
                              out_path: str) -> dict:
        """Encode corpus shards and write one JSON id-list per line.  Every
        rank of the mesh encodes the stream; rank 0 writes the file."""
        if self._enc.mesh.rank != 0:
            return self.encode_stream(iter_corpus_lines(shard_paths))
        with open(out_path, "w") as out:
            def sink(batch_ids):
                for ids in batch_ids:
                    out.write(json.dumps(ids) + "\n")
            return self.encode_stream(iter_corpus_lines(shard_paths),
                                      on_batch=sink)
