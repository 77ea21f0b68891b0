"""Timing meters, and the spans and counters of the encode path.

The reference has no tracer; its profiling lives in ad-hoc test timers
(reference: tests/test_full_vocab_profile.rs:8-66,
tests/test_detailed_profile.rs:10-89).  Here: throughput meters, a named
stage timer, and the encode path's recorder:

- ``StageClock``, passed down ``Tekkenizer.encode_batch(clock=...)``:
  synchronizing stage marks (``clock.times``) and, in memory, the
  ``span`` records of each layer (``clock.spans``), their self times added
  to ``clock.times`` under the span's name;
- ``span(name, clock)``, a layer boundary: a record on the clock, and a
  ``record_function`` range of the same name while ``torch.profiler``
  runs, so that the device trace charges the host's time to the layer;
  with neither, a flag check and a shared null context;
- ``COUNTERS``, the process-wide counts of the work done (kernel launches,
  encode calls, host-merged spans, device-merged long misses, overflow
  rows, readback bytes).
"""

from __future__ import annotations

import contextlib
import itertools
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _profiler


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


# --------------------------------------------------------------------- #
# counters
# --------------------------------------------------------------------- #

class Counters:
    """The process-wide counts of the encode path's work, added where the
    work happens.  ``launches`` counts kernel launches by kernel name
    (``_build.LAUNCHES`` is this dict); ``totals`` holds:

    - ``encode_calls``: ``Tekkenizer.encode_batch`` calls;
    - ``host_merge_spans``: misses merged on the host in
      ``splice_host_merges``;
    - ``device_long_rows``: misses over 8 bytes merged on the device, in
      the long (P=32) merge bucket of ``packed_encode``;
    - ``overflow_rows``: rows re-encoded on the host after a bucket
      overflowed;
    - ``readback_bytes``: bytes of the tensors ``PackedEncoder`` reads
      back from the device.

    A call's own counts are the difference of ``totals`` across it:
    ``since`` gives them as ``PackedEncoder.stats`` and
    ``Tekkenizer.last_batch_stats`` show them."""

    NAMES = ("encode_calls", "host_merge_spans", "device_long_rows",
             "overflow_rows", "readback_bytes")
    # the per-call views' keys and the totals they read
    VIEWS = {"overflow_rows": "overflow_rows", "fb_spans": "host_merge_spans",
             "device_long_rows": "device_long_rows"}

    def __init__(self):
        self.launches: dict[str, int] = {}
        self.totals: dict[str, int] = dict.fromkeys(self.NAMES, 0)

    def add(self, name: str, n: int) -> None:
        self.totals[name] += n

    def since(self, before: dict[str, int]) -> dict[str, int]:
        """The rows re-encoded on the host, the spans merged on the host
        and the long bucket's rows merged on the device since ``before``, a
        copy of ``totals``."""
        return {view: self.totals[name] - before[name]
                for view, name in self.VIEWS.items()}


COUNTERS = Counters()


# --------------------------------------------------------------------- #
# spans
# --------------------------------------------------------------------- #

_CALL_IDS = itertools.count(1)


@dataclass(slots=True)
class SpanRecord:
    """One span: times in ns on the profiler's host clock (Unix epoch),
    ``parent`` the id (index in ``clock.spans``) of the span that opened
    it, ``call`` shared by every span under one root span."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    call: int
    attrs: dict
    child_ns: int = 0

    @property
    def self_ns(self) -> int:
        """The duration less the part its child spans cover."""
        return self.end_ns - self.start_ns - self.child_ns


class StageClock:
    """The encode path's recorder, for measurement only; pass none on the
    production path.

    ``mark(name)`` adds the wall time since the previous mark to
    ``times[name]``, synchronizing the device first, so a stage's time
    includes its device work.  ``span`` records go to ``spans``, stamped
    on the profiler's host clock from one (Unix, perf-counter) anchor, and
    each span's self time is added to ``times`` under its name; a stage
    mark made with ``child=True`` inside a span is also recorded as that
    span's child."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self.spans: list[SpanRecord] = []
        self._open: list[SpanRecord] = []
        self._anchor = time.time_ns() - time.perf_counter_ns()
        self._t = time.perf_counter_ns()

    def _now_ns(self) -> int:
        return self._anchor + time.perf_counter_ns()

    def mark(self, name: str, device=None, child: bool = False) -> None:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter_ns()
        self.times[name] = self.times.get(name, 0.0) + (t - self._t) * 1e-9
        if child and self._open:
            parent = self._open[-1]
            start = max(self._anchor + self._t, parent.start_ns)
            rec = self._record(name, start, parent)
            rec.end_ns = self._anchor + t
            parent.child_ns += rec.end_ns - start
        self._t = t

    def _record(self, name: str, start_ns: int,
                parent: SpanRecord | None) -> SpanRecord:
        rec = SpanRecord(len(self.spans), name, start_ns, start_ns,
                         parent.id if parent else None,
                         parent.call if parent else next(_CALL_IDS), {})
        self.spans.append(rec)
        return rec

    def _enter(self, name: str) -> SpanRecord:
        rec = self._record(name, self._now_ns(),
                           self._open[-1] if self._open else None)
        self._open.append(rec)
        return rec

    def _exit(self, rec: SpanRecord) -> None:
        rec.end_ns = self._now_ns()
        self._open.pop()
        if rec.parent is not None:
            self.spans[rec.parent].child_ns += rec.end_ns - rec.start_ns
        self.times[rec.name] = (self.times.get(rec.name, 0.0)
                                + rec.self_ns * 1e-9)


def mark(clock: StageClock | None, name: str, device=None,
         child: bool = False) -> None:
    if clock is not None:
        clock.mark(name, device, child)


class _Span:
    __slots__ = ("name", "clock", "rec", "rf")

    def __init__(self, name: str, clock: StageClock | None):
        self.name, self.clock, self.rec, self.rf = name, clock, None, None

    def __enter__(self) -> SpanRecord | None:
        # the record encloses the range: the profiler stamps a range's
        # start early in its entry, which can take a millisecond
        if self.clock is not None:
            self.rec = self.clock._enter(self.name)
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        return self.rec

    def __exit__(self, *exc) -> bool:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.rec is not None:
            self.clock._exit(self.rec)
        return False


_NULL_SPAN = contextlib.nullcontext()


def span(name: str, clock: StageClock | None = None):
    """A layer boundary, as a context manager: a record on ``clock`` (its
    ``SpanRecord``, or None, is what ``with`` binds) and, while
    ``torch.profiler`` runs, a ``record_function`` range of the same name.
    A span opened with no span open on its clock starts a new call id.
    With no clock and no profiler it records nothing and allocates
    nothing."""
    if clock is None and not _profiler._is_profiler_enabled:
        return _NULL_SPAN
    return _Span(name, clock)
