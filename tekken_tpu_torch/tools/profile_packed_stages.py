"""Card time of the packed encode's stages (bench setup): the counterpart
of the repo's ``tools/profile_packed_stages.py``.

    python -m tekken_tpu_torch.tools.profile_packed_stages [--rows 128]
        [--reps 64] [--device-route] [--device cuda]

``rows`` x 2048-byte docs of the bench corpus on the bench tokenizer, on
the routed path (the route ``host_route`` picks) or, with
``--device-route``, the unrouted flat path (``route=None``).  Printed, in
ms a call, each the mean over ``reps`` calls with the lengths one byte
shorter every other call:

- ``boundaries``: ``byte_boundaries`` alone over all rows (CUDA events);
- each stage that ``ops.packed.StageClock`` records (``utf8_flags`` or
  ``branch``, ``stage1``, ``probe_emit``, ``p23``, ``merge``), and their
  sum; each mark synchronizes the card;
- ``clocked call``: the same clocked calls by the host clock, to a
  synchronize after the last (the stages leave out the work after the
  ``merge`` mark and the loop's own);
- ``full``: unclocked calls, by CUDA events;
- the stage sum less ``full``: what the clock's synchronizes cost.

The JAX tool cuts the jitted program after each stage; the port's stages
are clocked in place.  Off the card (``--device cpu``) every call runs and
the stages are listed with no time.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..models import bench_tokenizer, bench_words, build_corpus
from ..ops import packed
from ..ops.pretokenize import byte_boundaries
from . import card
from .bench import (ROW_LEN, bench_device, corpus_rng, encoder_loop,
                    host_seconds, loop_seconds)


def build_setup(rows: int = 128, device="cuda", tok=None, words=None):
    """(tok, enc, buf, lengths, nbytes): the bench tokenizer (built from
    the bench words unless ``tok`` and ``words`` are given), a
    ``PackedEncoder(rows, 2048, np_cap=rows * 2048 // 16)`` and ``rows``
    docs of the bench corpus packed by it."""
    if tok is None:
        words = bench_words()
        tok = bench_tokenizer(words, device)
    R = ROW_LEN
    enc = packed.PackedEncoder(tok, rows=rows, row_len=R,
                               np_cap=rows * R // 16, device=device)
    docs = build_corpus(words, corpus_rng(), n_docs=rows, doc_len=R)
    buf, lengths = enc.pack(docs)
    return tok, enc, buf, lengths, sum(len(d.encode()) for d in docs)


def run(tok, words, rows: int = 128, reps: int = 64,
        device_route: bool = False, device="cuda") -> dict:
    """Print and return the stage times (ms a call; None off the card)."""
    dev = bench_device(device)
    on_card = dev.type == "cuda"
    print(f"card: {card(dev)}", flush=True)
    _, enc, buf, lengths, nbytes = build_setup(rows, dev, tok, words)
    route = None if device_route else packed.host_route(buf)
    print(f"device={dev} bytes/iter={nbytes} rows={rows} reps={reps} "
          f"route={route}", flush=True)
    byts = torch.from_numpy(buf).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    alt = (lens, (lens - 1).clamp(min=0))
    tables = tok.device_tables(dev)
    encode = encoder_loop(byts, lens, tables, route, enc._np_cap)
    encode(0)                                    # warm-up

    def ms_line(name, s):
        if s is None:
            print(f"{name:16s} not measured ({dev})", flush=True)
        else:
            print(f"{name:16s} {s * 1e3:9.4f} ms/iter  "
                  f"({nbytes / s / 1e6:9.1f} MB/s)", flush=True)

    def boundaries(i):
        return byte_boundaries(byts, alt[i & 1])

    boundaries(0)
    bnd = loop_seconds(boundaries, reps, dev)
    ms_line("boundaries", bnd)

    stages: dict[str, float] = {}

    def clocked(i):
        clock = packed.StageClock()
        packed.packed_encode(byts, alt[i & 1], tables, route, enc._np_cap,
                             clock=clock)
        for k, v in clock.times.items():
            stages[k] = stages.get(k, 0.0) + v

    clocked_s = host_seconds(clocked, reps, dev)
    stage_s = {k: v / reps if on_card else None for k, v in stages.items()}
    for k, v in stage_s.items():
        ms_line(k, v)
    total = sum(stage_s.values()) if on_card else None
    ms_line("stage sum", total)
    ms_line("clocked call", clocked_s)
    full = loop_seconds(encode, reps, dev)
    ms_line("full", full)
    if on_card:
        print(f"{'sum - full':16s} {(total - full) * 1e3:9.4f} ms/iter  (the "
              f"clock's synchronizes)", flush=True)
    else:
        print(f"{'sum - full':16s} not measured ({dev})", flush=True)

    def ms(s):
        return None if s is None else s * 1e3
    return {"route": route, "bytes": nbytes, "boundaries_ms": ms(bnd),
            "stages_ms": {k: ms(v) for k, v in stage_s.items()},
            "sum_ms": ms(total), "clocked_ms": ms(clocked_s),
            "full_ms": ms(full),
            "clock_ms": ms(total - full) if on_card else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tekken_tpu_torch.tools.profile_packed_stages",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=128)
    p.add_argument("--reps", type=int, default=64)
    p.add_argument("--device-route", action="store_true",
                   help="the unrouted flat path (route=None)")
    p.add_argument("--device", default="cuda", help='"cuda" or "cpu"')
    args = p.parse_args(argv)
    dev = bench_device(args.device)
    t0 = time.perf_counter()
    words = bench_words()
    tok = bench_tokenizer(words, dev)
    print(f"vocab {len(tok.ranks)} built in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    run(tok, words, args.rows, args.reps, args.device_route, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
