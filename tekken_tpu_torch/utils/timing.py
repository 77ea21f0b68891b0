"""Timing meters and profiling helpers.

The reference has no tracer; its profiling lives in ad-hoc test timers
(reference: tests/test_full_vocab_profile.rs:8-66,
tests/test_detailed_profile.rs:10-89).  Here: throughput meters, a named
stage timer, and a ``torch.profiler`` trace context.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field


@dataclass
class Meter:
    """Accumulating throughput meter (bytes and tokens per second)."""

    bytes_total: int = 0
    tokens_total: int = 0
    seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_bytes: int = 0, n_tokens: int = 0) -> float:
        dt = time.perf_counter() - self._t0
        self.seconds += dt
        self.bytes_total += n_bytes
        self.tokens_total += n_tokens
        return dt

    @contextlib.contextmanager
    def measure(self, n_bytes: int = 0, n_tokens: int = 0):
        self.start()
        yield self
        self.stop(n_bytes, n_tokens)

    @property
    def bytes_per_sec(self) -> float:
        return self.bytes_total / self.seconds if self.seconds else 0.0

    @property
    def tokens_per_sec(self) -> float:
        return self.tokens_total / self.seconds if self.seconds else 0.0

    def summary(self) -> dict:
        return {
            "bytes": self.bytes_total,
            "tokens": self.tokens_total,
            "seconds": round(self.seconds, 4),
            "bytes_per_sec": round(self.bytes_per_sec, 1),
            "tokens_per_sec": round(self.tokens_per_sec, 1),
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the block: host ops, and the CUDA
    kernels where torch sees a GPU; written as a Chrome trace to
    ``log_dir/trace.json`` (chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class StageTimer:
    """Named stage timer, mirroring the reference's stepwise loading
    profile (file read / JSON parse / table build — reference:
    tests/test_detailed_profile.rs:33-57)."""

    stages: list = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.stages.append((name, time.perf_counter() - t0))

    def report(self) -> str:
        total = sum(s for _, s in self.stages) or 1e-12
        lines = [f"{n:<28s} {s*1e3:9.2f} ms  {100*s/total:5.1f}%"
                 for n, s in self.stages]
        lines.append(f"{'total':<28s} {total*1e3:9.2f} ms")
        return "\n".join(lines)
