"""The traffic generator: found by the mix's ``generator`` key, the same
seed gives the same pool, and the mixes route as their cells say."""

import random

from benchmark.core import spec, traffic, vocab
from benchmark.tests import tiny


def _pool(c, seed, n_docs):
    words, tb = vocab.build(c.config, seed)
    ranks = set(tb)
    return c.generator.pool(c.mix, words, ranks.__contains__, seed, n_docs)


def _english(c):
    """The cell with its mix's word lists left out: only the OOV rules
    replace words, so every doc is ASCII (route 1)."""
    c.mix["replace"] = [r for r in c.mix["replace"] if "oov_letters" in r]
    return c


def test_generator_found_by_the_mix():
    c = spec.cell("corpus.multilingual")
    assert c.mix["generator"] == "corpus"
    assert c.generator.__file__.endswith("generators/corpus.py")


def test_same_seed_same_pool():
    c = tiny.cell("corpus.multilingual")
    a = _pool(c, 7, 4)
    assert a == _pool(c, 7, 4)
    assert a != _pool(c, 8, 4)
    assert len(a) == c.mix["pool_batches"] and len(a[0]) == 4


def test_mixes_route_as_their_cells_say():
    en = _pool(_english(tiny.cell("corpus.multilingual")), 9, 16)
    assert all(d.isascii() and "  " not in d for b in en for d in b)
    ml = tiny.cell("corpus.multilingual")
    ml.mix["doc_bytes"] = 2048
    multi = _pool(ml, 9, 16)
    assert all(not d.isascii() for b in multi for d in b)
    assert all(len(d.encode()) <= 2048 for b in multi for d in b)


def test_doc_replace_touches_a_share_of_docs():
    """A per-doc rule (a share of the docs gets one word from a list) is
    data for the same generator: the docs it draws take route 3, the
    others stay ASCII."""
    c = _english(tiny.cell("corpus.multilingual"))
    c.mix["doc_replace"] = [{"p": 0.25, "words": 1, "choose": ["中文"]}]
    docs = [d for b in _pool(c, 5, 64) for d in b]
    touched = [d for d in docs if not d.isascii()]
    assert 0 < len(touched) < len(docs) // 2
    assert all(d.count("中文") == 1 for d in touched)


def test_replace_in_doc_without_a_draw_keeps_the_text():
    rng = random.Random(1)
    assert traffic.replace_in_doc("a b c", rng, [{"p": 0.0, "words": 1,
                                                  "choose": ["x"]}],
                                  lambda b: False) == "a b c"
