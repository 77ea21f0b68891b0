"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a
stretch of calls, reduced to the device's busy time, the kernel time by
name, and the idle gaps by what the host was doing.

``profiled(fn, kernels, launches)`` takes the trace again, up to three
times, when one lacks a kernel that the program's launch counter says the
calls launched (the profiler has returned such traces on the H100), and
raises when the third still lacks it: a kernel's time is never read as 0.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

WINDOW = "bench.window"
GAP_SLICE_NS = 200_000
NAME_CHARS = 120      # a CUDA kernel's demangled name can run to 1,000


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)    # device op -> seconds
    gaps_s: dict = field(default_factory=dict)      # host op -> idle s
    inputs: list = field(default_factory=list)      # one entry a call

    def kernel(self, pattern: str):
        """Seconds of the device ops whose name holds ``pattern`` (None
        when there is none)."""
        hits = [s for k, s in self.kernel_s.items() if pattern in k]
        return sum(hits) if hits else None

    def breakdown(self, n: int = 10) -> dict:
        def top(d):
            return [[k[:NAME_CHARS], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(self.kernel_s),
                "idle_gaps": top(self.gaps_s)}


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return f()
    return getattr(ev, f"{what}_us")() * 1000


def reduce_events(events) -> Trace:
    """Busy time, kernel time by name and idle gaps by host op, over the
    ``bench.window`` range, from kineto events."""
    from torch.autograd import DeviceType

    dev, host, win = [], [], None
    for ev in events:
        s = _ns(ev, "start")
        d = _ns(ev, "duration")
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # a record_function range also shows on the device's timeline
            # (from its first to its last kernel): it is no device work
            if not _annotation(ev):
                dev.append((s, s + d, name))
        elif name == WINDOW:
            win = (s, s + d)
        else:
            host.append((s, s + d, name))
    if win is None:
        raise RuntimeError("the trace holds no bench.window range")
    lo, hi = win
    kernel_s: dict = {}
    spans = []
    for s, e, name in dev:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) * 1e-9
            spans.append((s, e))
    spans.sort()
    busy = 0
    gaps = []
    cur = lo
    for s, e in spans:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    # each gap is cut into slices of at most GAP_SLICE_NS, each slice
    # charged to the innermost host op running at its middle
    gaps_s: dict = {}
    nest = _Nest(host)
    for g0, g1 in gaps:
        n = max(1, -(-(g1 - g0) // GAP_SLICE_NS))
        w = (g1 - g0) / n
        for i in range(n):
            label = nest.at(int(g0 + (i + 0.5) * w))
            gaps_s[label] = gaps_s.get(label, 0.0) + w * 1e-9
    return Trace(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
                 kernel_s=kernel_s, gaps_s=gaps_s)


def _annotation(ev) -> bool:
    f = getattr(ev, "is_user_annotation", None)
    if f is not None and f():
        return True
    kind = getattr(ev, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


class _Nest:
    """Host ops (start, end, name) nested by a stack sweep, for the
    innermost op at a time point."""

    def __init__(self, host):
        self.ops = sorted(host, key=lambda x: (x[0], -x[1]))
        self.starts = [op[0] for op in self.ops]
        self.parent = []
        stack = []
        for i, (s, e, _) in enumerate(self.ops):
            while stack and self.ops[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ops[i][1] < t:
            i = self.parent[i]
        return self.ops[i][2] if i >= 0 else "host outside any traced op"


def profiled(fn, kernels: dict, launches: dict, tries: int = 3) -> Trace:
    """Trace ``fn()``, which runs calls and returns a list with one entry
    (the inputs that a byte count reads) for each call.
    ``kernels`` maps a launch-counter name to the pattern of its kernel's
    name in the trace; ``launches`` is the program's counter dict."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for k in range(tries):
        before = dict(launches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                inputs = fn()
                torch.cuda.synchronize()
        tr = reduce_events(prof.profiler.kineto_results.events())
        tr.inputs = inputs
        missing = [name for name, pat in kernels.items()
                   if launches[name] > before[name]
                   and tr.kernel(pat) is None]
        if not missing:
            return tr
        print(f"[trace] trace {k + 1} of {tries} lacks {missing}",
              flush=True)
        time.sleep(0.1)
    raise RuntimeError(f"the profiler saw no {missing} kernel in {tries} "
                       f"traces")
