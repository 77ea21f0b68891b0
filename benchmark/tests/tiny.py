"""Cells of BENCHMARK.json cut to a size the CPU tests can hold: a small
vocabulary, few and short docs, and the program on the CPU."""

from __future__ import annotations

import copy
import time

from benchmark.core import spec

TINY_CONFIG = {"default_vocab_size": 1000 + 3000, "batch_docs": 8,
               "vocabulary": {"words": 400, "min_letters": 2,
                              "max_letters": 11}}
TINY_MIX = {"doc_bytes": 256, "pool_batches": 2, "warmup_passes": 1}


def cell(name: str):
    c = spec.cell(name)
    c.config = copy.deepcopy(c.config)
    c.config.update(TINY_CONFIG)
    c.mix = copy.deepcopy(c.mix)
    c.mix.update({k: v for k, v in TINY_MIX.items() if k in c.mix})
    return c


def run(name: str, seed: int = 11, seconds: float = 0.2, c=None):
    """(context, checks, attempted, failed, peak) of a CPU run."""
    c = c or cell(name)
    return c.entry.run(c, seed, seconds, False, time.perf_counter(),
                       device="cpu")

