"""Batch-size sweep of the packed encode in one process, the sizes timed
in turns: the counterpart of the repo's ``tools/bench_batchscale.py``.

    python -m tekken_tpu_torch.tools.bench_batchscale [--sizes 128,512,1024]
        [--reps 16] [--samples 3] [--device cuda]

Each size is ``rows`` x 2048-byte docs of the bench corpus (drawn one
size after another from the bench's generator, as the JAX tool draws
them) on the bench tokenizer, routed by ``host_route``, with
``np_cap = rows * 2048 // 16``.  Every size is built and warmed first;
then ``samples`` rounds time each size in turn over ``reps`` calls
(CUDA events, the lengths one byte shorter every other call), printing
MB/s and ms a call a sample, and the mean, min and max MB/s a size.  Off
the card (``--device cpu``) every call runs and no rate is printed.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..models import bench_tokenizer, bench_words, build_corpus
from ..ops import packed
from . import card
from .bench import (ROW_LEN, bench_device, corpus_rng, encoder_loop,
                    interleaved)


def run(tok, words, sizes=(128, 512, 1024), reps: int = 16,
        samples: int = 3, device="cuda") -> dict:
    """Print the sweep; returns {"B=<rows>": [MB/s of each sample]}."""
    dev = bench_device(device)
    R = ROW_LEN
    print(f"card: {card(dev)}", flush=True)
    print(f"device={dev} R={R} reps={reps} sizes={list(sizes)}", flush=True)
    tables = tok.device_tables(dev)
    rng = corpus_rng()
    variants = {}
    for B in sizes:
        docs = build_corpus(words, rng, n_docs=B, doc_len=R)
        enc = packed.PackedEncoder(tok, rows=B, row_len=R,
                                   np_cap=B * R // 16, device=dev)
        buf, lengths = enc.pack(docs)
        fn = encoder_loop(torch.from_numpy(buf).to(dev),
                          torch.from_numpy(lengths).to(dev), tables,
                          packed.host_route(buf), enc._np_cap)
        variants[f"B={B}"] = (fn, sum(len(d.encode()) for d in docs))
    return interleaved(variants, reps, samples, dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tekken_tpu_torch.tools.bench_batchscale",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", default="128,512,1024",
                   help="comma-separated document rows (R = 2048)")
    p.add_argument("--reps", type=int, default=16)
    p.add_argument("--samples", type=int, default=3)
    p.add_argument("--device", default="cuda", help='"cuda" or "cpu"')
    args = p.parse_args(argv)
    dev = bench_device(args.device)
    words = bench_words()
    run(bench_tokenizer(words, dev), words,
        [int(s) for s in args.sizes.split(",")], args.reps, args.samples, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
