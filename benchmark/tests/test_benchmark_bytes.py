"""The kernels' byte counts against shapes worked by hand."""

import os

import pytest

from benchmark.core import peaks, spec
from benchmark.core.reference import Reference

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reader(name):
    return spec.load_module(os.path.join(HERE, "metrics", name + ".py"))


@pytest.mark.parametrize("doc,want", [
    # 5 bytes + 4 (length) + 2 pieces x 8 + 4 (count)
    ("ab cd", 5 + 4 + 16 + 4),
    # route 3: 2 bytes + 4 + 2 flag bytes + 1 piece x 8 + 4
    ("é", 2 + 4 + 2 + 8 + 4),
    ("", 0 + 4 + 0 + 0 + 4),
])
def test_stage1_bytes(doc, want):
    assert reader("stage1_compact_roofline.corpus").doc_bytes(doc) == want


def test_merge_bytes():
    tb = [bytes([i]) for i in range(256)] + [b" a", b"bc", b" abc"]
    ranks = Reference(tb, 0).ranks
    m = reader("merge_rows_roofline.corpus")
    # " abcd" (5 bytes, a miss): 4 first pair lookups, then merging " a"
    # looks up " ab", merging "bc" looks up "bcd" and " abc", merging
    # " abc" looks up " abcd": 8 pair lookups, 2 tokens
    assert m.doc_bytes(" abcd", ranks) == 8 + 5 + 12 * 8 + 4 * 2
    # whole tokens, singles and misses outside 4..8 bytes cost nothing
    assert m.doc_bytes(" abc", ranks) == 0
    assert m.doc_bytes("x y", ranks) == 0
    assert m.doc_bytes(" abcdefgh", ranks) == 0


def test_merge_loop_by_hand():
    tb = [bytes([i]) for i in range(256)] + [b" a", b"bc", b" abc"]
    ranks = Reference(tb, 0).ranks
    from benchmark.core.reference import merge_loop
    # " a" (256) beats "bc" (257), then " a"+"bc" = " abc" (258)
    assert merge_loop(b" abcd", ranks.get) == [258, ord("d")]


def test_roofline_pct():
    assert peaks.roofline_pct(3.35e12 * 1e-3, 2e-3) == pytest.approx(50.0)
    assert peaks.roofline_pct(100, None) is None
    assert peaks.roofline_pct(0, 1.0) is None
