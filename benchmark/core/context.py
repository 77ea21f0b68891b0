"""What a run hands its metric readers (``metrics/<name>.py``, each a
``read(ctx)`` that returns a number, or None where it finds nothing to
read)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Window:
    """The calls of a measured stretch: their host-clock durations and
    input bytes by kind, and the stretch's wall seconds."""
    seconds: float = 0.0
    cpu_s: float = 0.0        # this process's CPU time in the stretch
    durations: dict = field(default_factory=dict)
    nbytes: dict = field(default_factory=dict)

    def add(self, kind: str, seconds: float, nbytes: int = 0) -> None:
        self.durations.setdefault(kind, []).append(seconds)
        self.nbytes[kind] = self.nbytes.get(kind, 0) + nbytes


@dataclass
class Context:
    setup_s: float
    window: Window            # --trace 0: the window; 1: its plain part
    cfg: dict
    mix: dict
    stages: list = field(default_factory=list)   # StageClock times a call
    trace: object = None      # core.trace.Trace of the profiled part
    reference: object = None  # core.reference.Reference
    pool: list = field(default_factory=list)     # what the calls take
    memo: dict = field(default_factory=dict)

    def cached(self, key, fn):
        """``fn()``, computed once a run for ``key`` (readers share the
        reference's work on a batch this way)."""
        if key not in self.memo:
            self.memo[key] = fn()
        return self.memo[key]


class Laps:
    """Wall seconds of set-up's parts, for the log."""

    def __init__(self, t_start: float):
        self.t = t_start
        self.laps: dict = {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = round(now - self.t, 3)
        self.t = now


def cycle(step, n_pool: int, seconds: float, start: int = 0,
          min_calls: int = 0, win=None) -> tuple[float, int]:
    """Call ``step(k)`` for k cycling over the pool from ``start`` until
    ``seconds`` have passed after a call and at least ``min_calls`` calls
    were made.  Returns (wall seconds from the first call's start to the
    last call's end, the next k); ``win``, where given, gets the
    stretch's CPU time."""
    k = start
    c0 = time.process_time()
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        step(k % n_pool)
        k += 1
        if time.perf_counter() >= end and k - start >= min_calls:
            break
    wall = time.perf_counter() - t0
    if win is not None:
        win.cpu_s = time.process_time() - c0
    return wall, k
