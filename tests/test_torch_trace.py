"""PyTorch port: the encode path's spans and counters (utils/timing.py).

``Tekkenizer.encode_batch(clock=StageClock())`` records one root span a
call and the layers' spans under it, every one with the root's call id;
a span's self time is its duration less its children's; the counters
(``COUNTERS``) and the per-call views (``last_batch_stats``,
``PackedEncoder.stats``) come from the same increments; with no clock and
no profiler nothing is recorded; under ``torch.profiler`` every span is a
host range nested in ``tekken.encode_batch``, starting where its record
starts."""

import random
import string

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tekken_tpu_torch.tekkenizer as ttk
from tekken_tpu_torch.models import build_synthetic_tokenizer
from tekken_tpu_torch.ops import packed
from tekken_tpu_torch.ops.packed import StageClock
from tekken_tpu_torch.utils import timing
from tekken_tpu_torch.utils.timing import COUNTERS

LAYERS = {"tekken.encode_batch", "tekken.plan", "tekken.pack",
          "tekken.upload", "tekken.device", "tekken.readback",
          "tekken.splice.merge", "tekken.splice.sort",
          "tekken.overflow_rows", "tekken.doc_lists", "tekken.public_ids"}
STAGES = {"utf8_flags", "branch", "stage1", "probe_emit", "p23", "merge"}
# the keys StageClock.times held before the spans, by route
MARKS = {"route_pack", "upload", "stage1", "probe_emit", "p23", "merge",
         "readback", "splice", "public_ids"}


def _words(seed, n, lo=2, hi=12):
    rng = random.Random(seed)
    return " ".join("".join(rng.choice(string.ascii_lowercase)
                            for _ in range(rng.randint(lo, hi)))
                    for _ in range(n))


# misses of 9-32 bytes merge on the device; the 33-40-letter words are
# the misses the host merges and splices
ROUTE1 = ["Hello world, it's a test.",
          _words(1, 10, 9, 13) + " " + _words(11, 2, 33, 40)]
ROUTE2 = ["two  spaces here",
          "digits 123456 " + _words(2, 8, 9, 13) + " " + _words(12, 2, 33, 40)]
ROUTE3 = ["café naïve 中文 " + _words(3, 8, 9, 13) + " "
          + _words(13, 2, 33, 40), "日本語 \U0001f600 x"]
# (texts, route groups a sub-batch: packed encode calls)
CASES = {"route1": (ROUTE1, 1), "route2": (ROUTE2, 1),
         "route3": (ROUTE3, 1), "mixed": (ROUTE1 + ROUTE2 + ROUTE3, 3)}
# with a bucket capacity of 4 (``default_np_cap`` patched), the random
# words overflow the buckets
OVERFLOW = ROUTE1 + ROUTE2 + ROUTE3 + [_words(5, 80)]


def _texts(tok, monkeypatch, overflow):
    if not overflow:
        return CASES["mixed"][0]
    monkeypatch.setattr(packed, "default_np_cap", lambda n: 4)
    monkeypatch.setattr(tok, "_packed_encoders", {})
    return OVERFLOW


@pytest.fixture(scope="module")
def tok():
    return build_synthetic_tokenizer(device="cpu", num_merges=400,
                                     num_special_tokens=20)


def _clocked(tok, texts, **kw):
    clock = StageClock()
    ids = tok.encode_batch(texts, clock=clock, **kw)
    return clock, ids


def _check_tree(clock, n_calls):
    recs = clock.spans
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["tekken.encode_batch"]
    root = roots[0]
    assert {r.call for r in recs} == {root.call}
    for r in recs:
        assert r.name in LAYERS | STAGES
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = recs[r.parent]
            assert p.id < r.id
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
            want = "tekken.device" if r.name in STAGES else \
                "tekken.encode_batch"
            assert p.name == want, r.name
    names = [r.name for r in recs]
    assert names.count("tekken.device") == n_calls
    assert names.count("tekken.readback") == n_calls
    assert names.count("tekken.public_ids") == 1
    return root


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_under_one_call(tok, case):
    texts, n_calls = CASES[case]
    clock, ids = _clocked(tok, texts, add_end_of_sequence=True)
    root = _check_tree(clock, n_calls)
    assert root.attrs["docs"] == len(texts)
    assert root.attrs["bytes"] == sum(len(t.encode()) for t in texts)
    assert tok.last_batch_stats["fb_spans"] > 0
    assert tok.last_batch_stats["device_long_rows"] > 0
    assert {"tekken.splice.merge", "tekken.splice.sort",
            "tekken.doc_lists"} <= {r.name for r in clock.spans}
    assert ids == tok.encode_batch(texts, add_end_of_sequence=True)


def test_row_sub_batches_share_the_call(tok, monkeypatch):
    """A batch over MAX_BATCH_BYTES (patched to 4096) runs as 8-row
    sub-batches: one plan span for the cut and one for each sub-batch's
    encoder, one device span for each, all under one root."""
    monkeypatch.setattr(ttk, "MAX_BATCH_BYTES", 4096)
    texts = [_words(i, 6) for i in range(20)]
    clock, ids = _clocked(tok, texts)
    n_sub = -(-len(texts) // 16)        # 16 rows of 256 bytes a sub-batch
    _check_tree(clock, n_sub)
    assert [r.name for r in clock.spans].count("tekken.plan") == 1 + n_sub
    assert ids == tok.encode_batch(texts)


def test_self_time_is_duration_less_children(tok):
    clock, _ = _clocked(tok, CASES["mixed"][0])
    kids = {}
    for r in clock.spans:
        if r.parent is not None:
            kids[r.parent] = kids.get(r.parent, 0) + r.end_ns - r.start_ns
    for r in clock.spans:
        assert r.self_ns == r.end_ns - r.start_ns - kids.get(r.id, 0)
        assert r.self_ns >= 0
    for name in LAYERS & {r.name for r in clock.spans}:
        assert clock.times[name] == pytest.approx(
            sum(r.self_ns for r in clock.spans if r.name == name) * 1e-9)


@pytest.mark.parametrize("overflow", [False, True])
def test_readback_bytes_are_the_copied_tensors(tok, monkeypatch, overflow):
    """``readback_bytes`` of a call is the summed nbytes of what
    ``_encode_buffer`` reads back: the token plane, the span arrays and,
    after an overflow, the row flags."""
    texts = _texts(tok, monkeypatch, overflow)
    want = []
    real = packed.packed_encode

    def spy(*a, **kw):
        out = real(*a, **kw)
        tok_, _, fb_start, fb_len, ovf, row_bad = out
        want.append(sum(t.nbytes for t in (tok_, fb_start, fb_len))
                    + (row_bad.nbytes if ovf else 0))
        return out
    monkeypatch.setattr(packed, "packed_encode", spy)
    before = COUNTERS.totals["readback_bytes"]
    tok.encode_batch(texts)
    assert len(want) == 3
    assert COUNTERS.totals["readback_bytes"] - before == sum(want)
    assert (tok.last_batch_stats["overflow_rows"] > 0) == overflow


@pytest.mark.parametrize("overflow", [False, True])
def test_counters_agree_with_last_batch_stats(tok, monkeypatch, overflow):
    texts = _texts(tok, monkeypatch, overflow)
    before = dict(COUNTERS.totals)
    clock, ids = _clocked(tok, texts)
    stats = tok.last_batch_stats
    got = {k: COUNTERS.totals[k] - before[k] for k in before}
    assert got["encode_calls"] == 1
    assert got["host_merge_spans"] == stats["fb_spans"] > 0
    assert got["device_long_rows"] == stats["device_long_rows"] > 0
    assert got["overflow_rows"] == stats["overflow_rows"]
    assert (stats["overflow_rows"] > 0) == overflow
    n_over = [r.name for r in clock.spans].count("tekken.overflow_rows")
    assert (n_over > 0) == overflow
    # the same call through the packed encoder directly: its view agrees
    enc = tok._get_packed_encoder(texts)
    ns = tok.num_special_tokens()
    assert enc.encode_batch(texts) == [[i - ns for i in d] for d in ids]
    assert enc.stats == stats


def test_benchmark_reads_the_long_rows_counter(tok):
    """The benchmark's ``device_long_rows.corpus`` reader gives the
    counter's total over the encode calls; without the counter (a
    program that lacks it) it reads None."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark", "metrics",
        "device_long_rows.corpus.py")
    spec = importlib.util.spec_from_file_location("device_long_rows", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    tok.encode_batch(CASES["mixed"][0])
    t = COUNTERS.totals
    assert t["device_long_rows"] > 0
    assert reader.read(None) == t["device_long_rows"] / t["encode_calls"]
    saved = t.pop("device_long_rows")
    try:
        assert reader.read(None) is None
    finally:
        t["device_long_rows"] = saved


def test_off_records_nothing(tok, monkeypatch):
    """No clock and no profiler: every span is the shared null context,
    no record is made, and the ids equal a clocked call's."""
    assert not torch.autograd.profiler._is_profiler_enabled
    assert timing.span("tekken.x") is timing.span("tekken.y")

    def refuse(*a, **kw):
        raise AssertionError("a span was recorded")
    texts = CASES["mixed"][0]
    clock, want = _clocked(tok, texts, add_beginning_of_sequence=True)
    monkeypatch.setattr(timing, "_Span", refuse)
    monkeypatch.setattr(StageClock, "_enter", refuse)
    assert tok.encode_batch(texts, True) == want


@pytest.mark.parametrize("route", [1, 2, 3])
def test_stage_clock_keeps_its_keys(tok, route):
    texts = CASES[f"route{route}"][0]
    clock, _ = _clocked(tok, texts)
    marks = MARKS | ({"utf8_flags"} if route == 3 else set())
    assert marks <= set(clock.times)
    assert set(clock.times) - marks <= LAYERS
    assert all(v >= 0 for v in clock.times.values())


def _profiled(tok, texts, clock):
    """The ``tekken.*`` host events (start, end, name) of one profiled
    call, by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tok.encode_batch(texts, clock=clock)
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("tekken."))


@pytest.mark.parametrize("clocked", [False, True])
def test_spans_are_profiler_ranges(tok, clocked):
    """Under torch.profiler (CPU) each span is a host range nested in
    ``tekken.encode_batch``; with a clock, each record starts within 1 ms
    of its range (in one of three calls: the host may deschedule the
    process between a record's stamp and its range's)."""
    texts = CASES["mixed"][0]
    tok.encode_batch(texts)
    for _ in range(3):
        clock = StageClock() if clocked else None
        evs = _profiled(tok, texts, clock)
        roots = [e for e in evs if e[2] == "tekken.encode_batch"]
        assert len(roots) == 1
        lo, hi, _ = roots[0]
        assert all(lo <= s <= e <= hi for s, e, _ in evs)
        assert LAYERS - {"tekken.overflow_rows"} <= {n for _, _, n in evs}
        if not clocked:
            return
        recs = sorted((r.start_ns, r.name) for r in clock.spans
                      if r.name in LAYERS)
        assert [n for _, n in recs] == [n for _, _, n in evs]
        lag = max(abs(rs - es) for (rs, _), (es, _, _) in zip(recs, evs))
        if lag < 1_000_000:
            return
    pytest.fail(f"a record starts {lag} ns from its range")
