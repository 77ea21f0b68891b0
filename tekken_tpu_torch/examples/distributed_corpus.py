"""Distributed corpus encoding demo (the counterpart of the repo's
``examples/distributed_corpus.py``): a document stream sharded
data-parallel over the ranks of a ``torch.distributed`` group (one
device a rank, tables copied to every rank, byte and token counters
all-reduced), piece-safe chunking for documents larger than a row, and
throughput metering.  The JAX demo runs on a virtual 8-device CPU mesh.

    python -m tekken_tpu_torch.examples.distributed_corpus [--device cpu]
    torchrun --nproc_per_node=N -m tekken_tpu_torch.examples.distributed_corpus [--device cpu]

As a world of one it needs no process group; under ``torchrun`` every
rank joins one (NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU), every rank
holds every document against the oracle, and rank 0 prints.
"""

import argparse
import os
import random
import sys

import torch.distributed as dist

from ..models import build_synthetic_tokenizer
from ..oracle import encode_ranks
from ..parallel.corpus import CorpusEncoder
from ..parallel.mesh import _rank_device, make_dp_mesh


def run(device) -> dict:
    """Encode the demo corpus over the default process group (or a world
    of one); every rank checks every doc.  Returns the stream's stats."""
    mesh = make_dp_mesh(device=device)
    if mesh.rank == 0:
        print(f"devices: {mesh.size} x {mesh.device.type}")

    tok = build_synthetic_tokenizer(device=mesh.device, num_merges=400,
                                    num_special_tokens=20)
    enc = CorpusEncoder(tok, mesh=mesh, rows=2 * mesh.size, row_len=1024)

    # a small corpus with one document far larger than a device row —
    # it rides the device path via piece-safe chunking
    rng = random.Random(7)
    words = ["hello", "world", "tokenizer", "mesh", "stream", "data"]
    docs = [" ".join(rng.choice(words) for _ in range(30))
            for _ in range(40)]
    docs.insert(3, " ".join(rng.choice(words) for _ in range(3000)))

    got = []
    stats = enc.encode_stream(docs, on_batch=got.extend,
                              add_special_shift=False)
    if len(got) != len(docs):
        raise AssertionError(f"{len(got)} results for {len(docs)} docs")
    for i, (d, g) in enumerate(zip(docs, got)):
        if g != encode_ranks(d, tok.ranks):
            raise AssertionError(f"doc {i} differs from the oracle")

    if mesh.rank == 0:
        print(f"documents:  {stats['documents']} "
              f"({stats['oversized_documents']} chunked)")
        print(f"bytes:      {stats['bytes']}")
        print(f"tokens:     {stats['tokens']}")
        if mesh.device.type == "cuda":
            print(f"throughput: {stats['bytes_per_sec'] / 1e3:.1f} KB/s "
                  f"(tiny corpus; the first call loads the kernels)")
        else:
            print(f"throughput: not measured ({mesh.device.type})")
        print("parity:     all documents equal the scalar oracle")
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tekken_tpu_torch.examples.distributed_corpus",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help='"cuda" (cuda:LOCAL_RANK under torchrun) or "cpu"')
    args = p.parse_args(argv)
    dev = _rank_device(args.device)
    own_group = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if own_group:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        run(dev)
    finally:
        if own_group:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
