"""The readers of the program's own spans and counters: each returns its
value from a synthetic context, and None where the program records
nothing (as a program without the spans or the counters does); and the
trace reader charges an idle gap inside a span's range to the span, not
to the range around it."""

import os

import pytest

from benchmark.core import spec, trace
from benchmark.core.context import Context, Window
from benchmark.tests.test_benchmark_trace import CUDA, Ev

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPANS = {"splice_merge_ms.corpus": "tekken.splice.merge",
         "splice_sort_ms.corpus": "tekken.splice.sort",
         "doc_lists_ms.corpus": "tekken.doc_lists"}
COUNTERS = {"readback_MB.corpus": ("readback_bytes", 1e-6),
            "host_merge_spans.corpus": ("host_merge_spans", 1.0)}


def reader(name):
    return spec.load_module(os.path.join(HERE, "metrics", name + ".py"))


def ctx(stages=()):
    return Context(0.0, Window(), {}, {}, stages=list(stages))


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader(name):
    key = SPANS[name]
    # two clocked calls, the second without the span: ms a call
    c = ctx([{key: 0.030, "splice": 0.5}, {"splice": 0.4}])
    assert reader(name).read(c) == pytest.approx(15.0)
    assert reader(name).read(ctx([{"splice": 0.5}])) is None
    assert reader(name).read(ctx()) is None


class Registry:
    def __init__(self, totals):
        self.totals = totals


@pytest.mark.parametrize("name", sorted(COUNTERS))
def test_counter_reader(name, monkeypatch):
    from tekken_tpu_torch.utils import timing

    key, scale = COUNTERS[name]
    monkeypatch.setattr(timing, "COUNTERS", Registry(
        {"encode_calls": 4, key: 4_000_000}))
    assert reader(name).read(ctx()) == pytest.approx(1e6 * scale)
    monkeypatch.setattr(timing, "COUNTERS", Registry({"encode_calls": 0,
                                                       key: 0}))
    assert reader(name).read(ctx()) is None
    monkeypatch.setattr(timing, "COUNTERS", Registry({"encode_calls": 4}))
    assert reader(name).read(ctx()) is None
    monkeypatch.delattr(timing, "COUNTERS")
    assert reader(name).read(ctx()) is None


def test_gap_inside_a_span_goes_to_the_span():
    """The benchmark's range around ``Tekkenizer.encode_batch`` holds the
    program's ``tekken.encode_batch`` and, inside it, a
    ``tekken.splice.merge`` range: the idle gap under the merge is the
    merge's, and only what lies outside it is the outer ranges'."""
    evs = [Ev(trace.WINDOW, 0, 1000),
           Ev("Tekkenizer.encode_batch", 0, 1000),
           Ev("tekken.encode_batch", 10, 980),
           Ev("tekken.splice.merge", 250, 500),
           Ev("k", 0, 100, CUDA), Ev("k", 900, 100, CUDA)]
    t = trace.reduce_events(evs)
    # the gap [100, 900) in slices of 200 us: the middles at 400 and 600
    # lie in the merge, those at 200 and 800 outside it
    assert t.gaps_s["tekken.splice.merge"] == pytest.approx(400e-6)
    assert t.gaps_s["tekken.encode_batch"] == pytest.approx(400e-6)
    assert "Tekkenizer.encode_batch" not in t.gaps_s
