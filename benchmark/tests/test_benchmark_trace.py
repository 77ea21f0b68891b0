"""The trace reader on events built by hand: busy time is the union of
device intervals inside the window, idle gaps go to the innermost host
op, and a trace that lacks a launched kernel is taken again, then
fails."""

import pytest
from torch.autograd import DeviceType

from benchmark.core import trace


class Ev:
    def __init__(self, name, start_us, dur_us, dev=DeviceType.CPU,
                 note=False):
        self._n, self._s, self._d, self._dev = name, start_us, dur_us, dev
        self._note = note

    def is_user_annotation(self):
        return self._note

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._d * 1000)

    def device_type(self):
        return self._dev


CUDA = DeviceType.CUDA


def events():
    return [Ev(trace.WINDOW, 0, 1000),
            Ev("encode_batch", 10, 900),
            Ev("splice", 500, 300),
            Ev("k1", 100, 100, CUDA), Ev("k2", 150, 100, CUDA),
            Ev("k1", 400, 50, CUDA), Ev("k_out", 2000, 10, CUDA),
            Ev("encode_batch", 100, 350, CUDA, note=True)]


def test_busy_and_kernels():
    t = trace.reduce_events(events())
    assert t.window_s == pytest.approx(1e-3)
    # [100, 250) and [400, 450): 200 us busy
    assert t.busy_s == pytest.approx(200e-6)
    assert t.kernel("k1") == pytest.approx(150e-6)
    assert t.kernel("k2") == pytest.approx(100e-6)
    assert t.kernel("k_out") is None


def test_gaps_by_host_op():
    t = trace.reduce_events(events())
    # gaps [0,100), [250,400), [450,1000); splice covers [500,800) of
    # the last, which is cut into three slices of 183 us, two of them
    # with their middle inside splice
    assert t.gaps_s["splice"] == pytest.approx(2 * 550e-6 / 3)
    assert sum(t.gaps_s.values()) == pytest.approx(800e-6)
    b = t.breakdown()
    assert b["device_ops"][0][0] in ("k1", "k2")
    assert len(b["idle_gaps"]) <= 10


def test_missing_kernel_retraced_then_fails(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    launches = {"k": 0}

    def fn():
        launches["k"] += 1          # a launch the trace will not hold
        return [0]
    with pytest.raises(RuntimeError, match="3 traces"):
        trace.profiled(fn, {"k": "my_kernel"}, launches)
    assert launches["k"] == 3
