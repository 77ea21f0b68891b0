"""Bench-scale multi-card validation: the DistributedEncoder at real
shapes over every rank of a process group, one card a rank, with the
bench vocabulary (130,872 ranks, 1,000 specials).

    torchrun --nproc_per_node=N -m tekken_tpu_torch.tools.multichip_scale [--out FILE]
    python -m tekken_tpu_torch.tools.multichip_scale --device cpu ...

(a) parity: on every rank, every doc of ``encode_batch`` (``--rows`` x
``--row-len``, default 4096 x 2048 of bench-corpus docs) equals the
native engine's ``encode_batch``, and a sample of 64 docs the oracle's;
(b) the all-reduced bytes and tokens are exact; (c) the sharding overhead,
``parallel.scaling.measure_dp_overhead`` over the same buffer for each
device count (the powers of two up to the world size, and the world
size); (d) weak scaling, ``measure_scaling`` at ``rows / max(counts)``
rows a device.  The gather of the docs alone (``all_gather_object`` of
each rank's share) is timed once more.  Rank 0 prints one JSON line with
the JAX tool's keys, the scaling report, the gather's time and each
rank's card (its ``nvidia-smi`` name and power limit), and writes it to
``--out`` when one is named.  Under ``torchrun`` every rank joins the
process group (NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU); a caller
that has initialized a group calls ``main`` on every rank instead.
``--vocab synthetic`` takes the 400-merge synthetic vocabulary.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

import torch.distributed as dist

from ..models import (bench_tokenizer, bench_words, build_corpus,
                      build_synthetic_tokenizer)
from ..models.bench import BENCH_SEED
from ..native import NativeEncoder
from ..oracle import encode_ranks
from ..parallel.encode import DistributedEncoder
from ..parallel.mesh import _rank_device, make_dp_mesh
from ..parallel.scaling import measure_dp_overhead, measure_scaling
from . import card

NOTE = ("one card a rank, one process a rank.  dp_overhead: the same "
        "rows x row_len buffer on 1, 2, ... ranks (each rank encodes its "
        "share, then one all_reduce of the counters); a ratio below 1 is "
        "the work split.  scaling: rows_per_device x row_len a rank "
        "(weak scaling), efficiency = bytes/s a device at the largest "
        "count over one device's.  gather_s: all_gather_object of each "
        "rank's share of the docs, which encode_batch pays once a call.")


def _tokenizer(vocab: str, words, device):
    if vocab == "synthetic":
        return build_synthetic_tokenizer(num_merges=400,
                                         num_special_tokens=20, device=device)
    return bench_tokenizer(words, device)


def _gather(obj, world: int) -> list:
    if world == 1:
        return [obj]
    out: list = [None] * world
    dist.all_gather_object(out, obj)
    return out


def run(vocab: str = "bench", rows: int = 4096, row_len: int = 2048,
        device=None) -> dict:
    """Every rank of the default process group (or a world of one) calls
    this with the same arguments; each holds its own results against the
    native engine and the oracle and raises on a difference.  Returns the
    report (the same on every rank)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    # the powers of two up to the world size, and the world size
    counts = [1 << k for k in range(world.bit_length())]
    counts += [world] if counts[-1] != world else []
    mesh = make_dp_mesh(device=device)
    rng = random.Random(BENCH_SEED)
    words = bench_words(rng)
    t0 = time.time()
    tok = _tokenizer(vocab, words, mesh.device)
    build_s = time.time() - t0
    print(f"[rank {mesh.rank}] vocab {len(tok.ranks)} built in "
          f"{build_s:.1f}s on {mesh.device}", flush=True)

    enc = DistributedEncoder(tok, mesh=mesh, rows=rows, row_len=row_len)
    docs = build_corpus(words, rng, n_docs=rows, doc_len=row_len)
    batch_s = []
    for _ in range(2):                   # the first call builds the kernels
        t1 = time.time()
        got, total_bytes, total_tokens = enc.encode_batch(docs)
        batch_s.append(time.time() - t1)

    # (a) parity: every doc against the native engine, 64 against the oracle
    native = NativeEncoder(tok)
    nat = native.encode_batch(docs)
    bad = [i for i, (g, n) in enumerate(zip(got, nat)) if g != n]
    sample = list(range(0, rows, max(1, rows // 64)))[:64]
    bad += [i for i in sample if got[i] != encode_ranks(docs[i], tok.ranks)]
    if bad:
        raise AssertionError(f"rank {mesh.rank}: docs {sorted(set(bad))[:8]} "
                             f"differ from the native engine or the oracle "
                             f"(first: {docs[bad[0]][:60]!r})")

    # (b) the all-reduced counters are exact
    want_bytes = sum(len(d.encode("utf-8")) for d in docs)
    want_tokens = sum(len(g) for g in got)
    if (total_bytes, total_tokens) != (want_bytes, want_tokens):
        raise AssertionError(f"rank {mesh.rank}: counters {total_bytes}, "
                             f"{total_tokens} against {want_bytes}, "
                             f"{want_tokens}")

    # the gather of the docs alone, each rank's share as encode_batch sends
    per = rows // world
    share = (got[mesh.rank * per:(mesh.rank + 1) * per], False)
    if world > 1:
        dist.barrier()
    t2 = time.time()
    _gather(share, world)
    gather_s = time.time() - t2

    # (c) the sharding overhead and (d) weak scaling
    t3 = time.time()
    overhead = measure_dp_overhead(tok, device_counts=counts, rows=rows,
                                   row_len=row_len, iters=2, repeats=4)
    overhead_s = time.time() - t3
    t4 = time.time()
    scaling = measure_scaling(tok, counts, rows_per_device=rows // max(counts),
                              row_len=row_len).summary()
    scaling_s = time.time() - t4

    ranks_info = _gather({"rank": mesh.rank, "device": str(mesh.device),
                          "card": card(mesh.device), "gather_s": gather_s,
                          "encode_batch_s": batch_s}, world)
    # the points of every count are complete on rank 0 (a member of all)
    overhead, scaling = _gather((overhead, scaling), world)[0]
    return {
        "devices": world,
        "rows": rows,
        "row_len": row_len,
        "vocab_ranks": len(tok.ranks),
        "bytes": int(total_bytes),
        "tokens": int(total_tokens),
        "parity": (f"ok (every doc equals the native engine's on every "
                   f"rank; {len(sample)} equal the oracle)"),
        "counters": "ok (all-reduced totals exact)",
        "shard_np_cap": enc._shard_cap,
        "dp_overhead": overhead,
        "scaling": scaling,
        "device_counts": counts,
        "gather_s": max(r["gather_s"] for r in ranks_info),
        "ranks": ranks_info,
        "seconds": {"vocab_build": build_s, "dp_overhead": overhead_s,
                    "scaling": scaling_s},
        "note": NOTE,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tekken_tpu_torch.tools.multichip_scale",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help='"cuda" (cuda:LOCAL_RANK under torchrun) or "cpu"')
    p.add_argument("--rows", type=int, default=4096)
    p.add_argument("--row-len", type=int, default=2048)
    p.add_argument("--vocab", choices=["bench", "synthetic"], default="bench")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = _rank_device(args.device)
    own_group = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if own_group:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        out = run(args.vocab, args.rows, args.row_len, dev)
        rank = dist.get_rank() if dist.is_initialized() else 0
    finally:
        if own_group:
            dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
