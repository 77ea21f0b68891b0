"""The port's single-card step and multi-card dryrun: the counterpart of
the JAX package's ``__graft_entry__.py``.

``entry(device)`` returns the flagship step, the unrouted packed encode
(``ops.packed.packed_encode`` with ``route=None``) on a toy tokenizer at
B=8, R=128, with example args on ``device``.

``dryrun_multichip(n, device)`` runs one ``DistributedEncoder`` batch
over the current ``torch.distributed`` group of ``n`` ranks (or a world of
one with no group) against the 130,872-rank bench vocabulary, and holds
every doc and both counters against the oracle.  A tokenizer admits
document-granular data parallelism only, so that is the sharding.

    python -m tekken_tpu_torch.graft_entry [--device cpu]
    torchrun --nproc_per_node=N -m tekken_tpu_torch.graft_entry [--device cpu]

The first runs ``entry()``'s step.  Under ``torchrun`` (which sets
``WORLD_SIZE``) every rank also joins the process group (NCCL on
``cuda:LOCAL_RANK``, or gloo on the CPU) and runs
``dryrun_multichip(WORLD_SIZE)``.
"""

from __future__ import annotations

import argparse
import functools
import os
import random
import sys

import numpy as np
import torch
import torch.distributed as dist

from .models import bench_tokenizer, bench_words, build_synthetic_tokenizer
from .oracle import encode_ranks
from .ops.packed import packed_encode
from .parallel.encode import DistributedEncoder
from .parallel.mesh import _rank_device, make_dp_mesh

SAMPLES = (b"Hello, world! it's a test 123",
           b"the quick brown fox jumps",
           b"  whitespace   handling  \n",
           b"tokenizer encoding decoding")


def toy_tokenizer(device="cuda"):
    """The toy step's tokenizer: 200 BPE merges, 20 specials."""
    return build_synthetic_tokenizer(num_merges=200, num_special_tokens=20,
                                     device=device)


def entry(device="cuda"):
    """(fn, example_args) of the flagship step on ``device``: fn(byts,
    lengths) is ``packed_encode`` on the toy tokenizer's device tables,
    unrouted, with a merge capacity of B*R/4; example_args a (8, 128)
    uint8 buffer holding the four sample strings and its lengths."""
    tok = toy_tokenizer(device)
    B, R = 8, 128
    fn = functools.partial(packed_encode, tables=tok.device_tables(),
                           route=None, np_cap=B * R // 4)
    buf = np.zeros((B, R), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(SAMPLES):
        buf[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
        lengths[i] = len(s)
    return fn, (torch.from_numpy(buf).to(device),
                torch.from_numpy(lengths).to(device))


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One data-parallel encode over the current process group, which must
    hold ``n_devices`` ranks (no group is a world of one): 2N docs at rows
    2N and row_len 256 on the bench vocabulary.  Every doc and both
    counters are held against the oracle on every rank.  Returns the
    counts."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a process group "
                         f"of {world} ranks")
    mesh = make_dp_mesh(device=device)
    words = bench_words()
    tok = bench_tokenizer(words, mesh.device)
    enc = DistributedEncoder(tok, mesh=mesh, rows=2 * n_devices,
                             row_len=256)

    rng = random.Random(7)
    texts = [f"doc {i}: it's {' '.join(rng.choice(words) for _ in range(24))}"
             f" {rng.randint(0, 9999)}" for i in range(2 * n_devices)]
    docs, total_bytes, total_tokens = enc.encode_batch(texts)

    for t, got in zip(texts, docs):
        if got != encode_ranks(t, tok.ranks):
            raise AssertionError(f"dryrun_multichip: {t!r} differs from the "
                                 f"oracle")
    if total_bytes != sum(len(t.encode("utf-8")) for t in texts):
        raise AssertionError(f"dryrun_multichip: {total_bytes} bytes")
    if total_tokens != sum(len(d) for d in docs):
        raise AssertionError(f"dryrun_multichip: {total_tokens} tokens")
    print(f"dryrun_multichip({n_devices}) rank {mesh.rank} on {mesh.device}: "
          f"OK, {total_bytes} bytes -> {total_tokens} tokens over "
          f"{len(tok.ranks)} ranks, parity verified", flush=True)
    return {"docs": len(docs), "bytes": total_bytes, "tokens": total_tokens,
            "ranks": len(tok.ranks)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tekken_tpu_torch.graft_entry",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help='"cuda" (cuda:LOCAL_RANK under torchrun) or "cpu"')
    args = p.parse_args(argv)
    dev = _rank_device(args.device)
    fn, example = entry(dev)
    out = fn(*example)
    print(f"entry(): ran on {dev}, n_out = {int(out[1])}", flush=True)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        try:
            dryrun_multichip(dist.get_world_size(), dev)
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
