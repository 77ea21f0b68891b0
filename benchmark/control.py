"""Read a cell's control: the configuration's control (``core/control.py``)
put in the program's place in the cell's own entry, at the cell's own
size, its answers judged by the check the runs use (``Keeper``,
``judge``, ``result.is_correct``), on several seeds.

    python3 -m benchmark.control --workload corpus.multilingual --seeds 1,2,3

Prints one JSON line a seed: ``correct`` (a control has to read false),
``answers_wrong`` beside its limit, and the answers compared.  The
control is pure Python and needs no card: the entry runs it on the CPU,
with no warm-up, for one pass over the pool.  The benchmark's runs do
not run it."""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

from .core import result, spec
from .core.control import CONTROLS


class StandIn:
    """A control model behind the program's ``encode_batch``."""

    def __init__(self, model, cfg: dict):
        self.model, self.cfg = model, cfg

    def device_tables(self) -> None:
        pass

    def encode_batch(self, texts, add_bos=False, add_eos=False, clock=None):
        bos = self.cfg["bos_id"] if add_bos else None
        eos = self.cfg["eos_id"] if add_eos else None
        return [self.model.encode(t, bos, eos) for t in texts]


def stand_in(cfg: dict, token_bytes: list, device) -> StandIn:
    model = CONTROLS[cfg["control"]](token_bytes,
                                     cfg["default_num_special_tokens"])
    return StandIn(model, cfg)


def reading(cell, seed: int) -> dict:
    c = copy.copy(cell)
    c.mix = dict(cell.mix, warmup_passes=0)
    t0 = time.perf_counter()
    _, checks, attempted, _, _ = c.entry.run(c, seed, 0.0, False, t0,
                                             device="cpu", program=stand_in)
    n = checks["answers_wrong"]
    return {"workload": cell.name, "seed": seed,
            "control": cell.config["control"],
            "correct": result.is_correct(checks),
            "answers_compared": attempted, "answers_wrong": n["value"],
            "limit": n["limit"], "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(reading(cell, int(s))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
