"""The routed against the flat packed encode, timed in turns in one
process: the counterpart of the repo's ``tools/bench_ab.py``.

    python -m tekken_tpu_torch.tools.bench_ab [--rows 128] [--reps 32]
        [--samples 3] [--device cuda]

On ``profile_packed_stages.build_setup``'s batch (``rows`` x 2048-byte
docs of the bench corpus), ``routed`` runs ``packed_encode`` with the
route ``host_route`` picks and ``flat`` with ``route=None`` (the JAX
tool's "pallas+route" and "pallas+devroute"; the port has no Pallas
switch).  Both are warmed, then ``samples`` rounds time each in turn over
``reps`` calls (CUDA events), printing MB/s a sample and the mean, min and
max.  Off the card (``--device cpu``) every call runs and no rate is
printed.  ``tekken_tpu_torch.kernel_ab`` compares two checkouts' kernels.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..models import bench_tokenizer, bench_words
from ..ops import packed
from . import card
from .bench import bench_device, encoder_loop, interleaved
from .profile_packed_stages import build_setup


def run(tok, words, rows: int = 128, reps: int = 32, samples: int = 3,
        device="cuda") -> dict:
    """Print the A/B; returns {"routed": [MB/s], "flat": [MB/s]}."""
    dev = bench_device(device)
    print(f"card: {card(dev)}", flush=True)
    _, enc, buf, lengths, nbytes = build_setup(rows, dev, tok, words)
    print(f"device={dev} bytes={nbytes} rows={rows} reps={reps}", flush=True)
    byts = torch.from_numpy(buf).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    tables = tok.device_tables(dev)
    variants = {
        name: (encoder_loop(byts, lens, tables, route, enc._np_cap), nbytes)
        for name, route in (("routed", packed.host_route(buf)),
                            ("flat", None))}
    return interleaved(variants, reps, samples, dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tekken_tpu_torch.tools.bench_ab",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=128)
    p.add_argument("--reps", type=int, default=32)
    p.add_argument("--samples", type=int, default=3)
    p.add_argument("--device", default="cuda", help='"cuda" or "cpu"')
    args = p.parse_args(argv)
    dev = bench_device(args.device)
    words = bench_words()
    run(bench_tokenizer(words, dev), words, args.rows, args.reps,
        args.samples, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
