"""What decides ``correct``: the plain reference against the port at a
tiny vocabulary on the CPU, each configuration's control, run through
the cell's own entry, reads ``correct`` false, and runs with the timed
path broken underneath read ``correct`` false."""

import functools

import pytest

from benchmark import control
from benchmark.core import result
from benchmark.core.reference import Reference, pretokenize
from benchmark.tests import tiny

CELLS = ["corpus.multilingual"]
TEXTS = ["Hello world", "  two  spaces\n\nand lines\r\n", "1234567 ab12",
         "café naïve 中文字 😀🚀 Ελληνικά", "don't I'LL we've", "a" * 300,
         "tabs\tand\x0bvertical", "", " ", "...!!! ?? ;"]


@pytest.mark.parametrize("name", CELLS)
def test_port_matches_reference(name):
    ctx, checks, attempted, failed, _ = tiny.run(name, seed=2147483901)
    assert checks["answers_wrong"]["value"] == 0
    assert failed == 0 and attempted > 0


@pytest.mark.parametrize("text", TEXTS)
def test_reference_matches_port_oracle(text):
    from tekken_tpu_torch.oracle import encode_ranks, pretokenize as port_pt

    from benchmark.core import vocab
    words, tb = vocab.build(tiny.cell(CELLS[0]).config, 3)
    ref = Reference(tb, 1000)
    assert pretokenize(text) == port_pt(text)
    assert ref.encode(text, shift=False) == encode_ranks(text, ref.ranks)


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_incorrect(name):
    c = tiny.cell(name)
    c.mix["doc_bytes"] = 2048
    c.config["batch_docs"] = 32
    for seed in (1, 2, 3):
        r = control.reading(c, seed)
        assert r["correct"] is False, r
        assert r["answers_wrong"] > r["limit"] == 0, r
        assert r["answers_compared"] == 32 * c.mix["pool_batches"], r


def test_stand_in_of_the_reference_reads_correct(monkeypatch):
    """The control's path itself judges a sound model correct: the
    reference in the program's place reads no wrong answer."""
    monkeypatch.setitem(control.CONTROLS, "merge_leftmost", Reference)
    r = control.reading(tiny.cell(CELLS[0]), 4)
    assert r["correct"] is True and r["answers_wrong"] == 0, r


def _fault(monkeypatch, fn):
    """Wrap the program's encode_batch output."""
    import tekken_tpu_torch as tt

    real = tt.Tekkenizer.encode_batch
    state = {}

    @functools.wraps(real)
    def broken(self, texts, *a, **kw):
        return fn(state, real(self, texts, *a, **kw))
    monkeypatch.setattr(tt.Tekkenizer, "encode_batch", broken)


def stale(state, out):
    """A step that returns the state it had: the previous call's ids."""
    prev = state.get("prev", out)
    state["prev"] = out
    return prev


def half(state, out):
    """Half of the batch left out."""
    return out[:len(out) // 2]


def altered(state, out):
    """One token altered where it is produced."""
    out = [list(x) for x in out]
    out[len(out) // 2][-1] += 1
    return out


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [stale, half, altered])
def test_fault_reads_incorrect(monkeypatch, name, fault):
    _fault(monkeypatch, fault)
    c = tiny.cell(name)
    ctx, checks, *_ = tiny.run(name, seconds=0.5, c=c)
    assert not result.is_correct(checks), (fault.__name__, checks)
