"""PyTorch port: the serving cell of the benchmark (``serve.chat``,
``benchmark/entries/serve.py``) at a tiny size on the CPU, and the plain
decode reference (``benchmark/core/decode_reference.py``) against the
port's decode.

The cell runs ``Tekkenizer.encode_batch`` on the prompts and
``Tekkenizer.decode_batch`` on the completions; its check reads 0 wrong
answers of either kind for the port, and catches a decode that drops
the specials before decoding (which joins the bytes of a character that
a special cut; the tests put such cuts into the completions, the cell's
traffic has none).  The reference holds tekken-rs's ``decode_all``
(src/tekkenizer.rs:463-560): maximal same-specialness runs, special runs
dropped (IGNORE), kept as strings (KEEP) or refused (RAISE), each run of
ranks lossy UTF-8."""

import ast
import base64
import functools
import os

import pytest

import tekken_tpu_torch as tt
from benchmark import control_serve
from benchmark.core import spec, vocab
from benchmark.core.context import Context, Window
from benchmark.core.decode_reference import (DecodeReference,
                                             SpecialTokenError,
                                             special_strings)
from benchmark.core.reference import Reference
from benchmark.entries import common, serve
from benchmark.tests import tiny
from tekken_tpu_torch.errors import SpecialTokenPolicyError
from tekken_tpu_torch.special_tokens import (SpecialTokenPolicy,
                                             get_deprecated_special_tokens)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "serve.chat"
SEED = 2147483911


def small_cell(**mix):
    """serve.chat at tiny.py's sizes, its lengths cut to match."""
    c = tiny.cell(CELL)
    c.config["batch_completions"] = 8
    c.mix["prompt_bytes"] = dict(c.mix["prompt_bytes"], median=384,
                                 min=64, max=1024)
    c.mix["system_prompts"] = dict(c.mix["system_prompts"], bytes=256)
    c.mix["completion_bytes"] = dict(c.mix["completion_bytes"],
                                     median=128, max=512)
    c.mix.update(mix)
    return c


def test_cell_reads_correct_for_the_port():
    c = small_cell()
    ctx, checks, attempted, failed, _ = tiny.run(CELL, seed=SEED, c=c)
    assert ctx.memo["wrong"] == {"prompts": 0, "completions": 0}
    assert checks["answers_wrong"] == {"value": 0, "limit": 0}
    assert failed == 0 and attempted >= 2 * 8 * c.mix["pool_batches"]
    assert c.readers["encode_MBps"].read(ctx) > 0
    assert 0 < c.readers["pad_share.serve"].read(ctx) < 100


def test_pool_mixes_routes_and_tool_calls():
    c = small_cell(pool_batches=4)
    cfg = c.config
    ns = cfg["default_num_special_tokens"]
    words, tb = vocab.build(cfg, SEED)
    ref = Reference(tb, ns)
    pool = c.generator.pool(c.mix, words, ref, SEED, cfg)
    assert pool == c.generator.pool(c.mix, words, ref, SEED, cfg)
    prompts = [p for s in pool for p in s["prompts"]]
    comps = [x for s in pool for x in s["completions"]]
    assert any("\n\n" in p and p.isascii() for p in prompts)
    assert any(not p.isascii() for p in prompts)
    assert all(x[-1] == cfg["eos_id"] for x in comps)
    assert any(x[0] == cfg["tool_calls_id"] for x in comps)
    # a completion's only specials: a leading tool call and the EOS
    assert all(t >= ns for x in comps
               for t in x[int(x[0] == cfg["tool_calls_id"]):-1])
    assert all(len(p.encode()) <= c.mix["prompt_bytes"]["max"]
               for p in prompts)
    # the seed draws the shapes too
    other = c.generator.pool(c.mix, words, ref, SEED + 1, cfg)
    assert [len(p) for p in prompts] != [len(p) for s in other
                                         for p in s["prompts"]]


def cut_characters(pool, ns, special=9):
    """The pool with ``special`` put inside an "é" (two byte tokens;
    rank b is the byte b) before the EOS of every other completion."""
    return [dict(s, completions=[
        x[:-1] + [ns + 0xC3, special, ns + 0xA9] + x[-1:] if j % 2 else x
        for j, x in enumerate(s["completions"])]) for s in pool]


def _cut_pool(monkeypatch, c):
    real = c.generator.pool

    def pool(mix, words, ref, seed, cfg):
        return cut_characters(real(mix, words, ref, seed, cfg),
                              cfg["default_num_special_tokens"])
    monkeypatch.setattr(c.generator, "pool", pool)


def _drop_specials(monkeypatch):
    real = tt.Tekkenizer.decode_batch

    @functools.wraps(real)
    def broken(self, token_lists, policy, clock=None):
        ns = self.num_special_tokens()
        return real(self, [[t for t in x if t >= ns] for x in token_lists],
                    policy, clock=clock)
    monkeypatch.setattr(tt.Tekkenizer, "decode_batch", broken)


def test_cut_characters_read_correct_for_the_port(monkeypatch):
    c = small_cell()
    _cut_pool(monkeypatch, c)
    ctx, checks, *_ = tiny.run(CELL, seed=SEED, c=c)
    assert ctx.memo["wrong"] == {"prompts": 0, "completions": 0}


def test_decode_that_drops_specials_is_caught(monkeypatch):
    _drop_specials(monkeypatch)
    c = small_cell()
    _cut_pool(monkeypatch, c)
    ctx, checks, *_ = tiny.run(CELL, seed=SEED, c=c)
    assert ctx.memo["wrong"]["prompts"] == 0
    assert ctx.memo["wrong"]["completions"] > 0
    assert checks["answers_wrong"]["value"] > checks["answers_wrong"]["limit"]


def test_control_reads_wrong_on_both_kinds():
    r = control_serve.reading(small_cell(), 3)
    assert r["correct"] is False, r
    assert r["wrong"]["prompts"] > 0 and r["wrong"]["completions"] > 0, r


# a table of the 256 bytes and three merged tokens, under the first five
# specials of the legacy table
TOKENS = [bytes([i]) for i in range(256)] + [b"he", b"llo", b" w"]
NS = 5
E_ACUTE = [NS + 0xC3, NS + 0xA9]          # "é" as two byte tokens
HE, LLO, W = NS + 256, NS + 257, NS + 258
BOS, EOS, INST, END_INST = 1, 2, 3, 4
CASES = [
    ([BOS, HE, LLO, EOS], "IGNORE", "hello"),
    ([BOS, HE, LLO, EOS], "KEEP", "<s>hello</s>"),
    ([HE, INST, LLO], "IGNORE", "hello"),
    ([HE, INST, END_INST, LLO], "KEEP", "he[INST][/INST]llo"),
    (E_ACUTE, "IGNORE", "é"),
    ([E_ACUTE[0], INST, E_ACUTE[1]], "IGNORE", "\ufffd\ufffd"),
    ([E_ACUTE[0], INST, E_ACUTE[1]], "KEEP", "\ufffd[INST]\ufffd"),
    ([HE, LLO, W, E_ACUTE[0]], "RAISE", "hello w\ufffd"),
    ([], "RAISE", ""),
    ([EOS], "IGNORE", ""),
]


@pytest.fixture(scope="module")
def small_tok():
    vocab_ = [tt.TokenInfo(rank=r, token_bytes=base64.b64encode(t).decode(),
                           token_str=None) for r, t in enumerate(TOKENS)]
    return tt.Tekkenizer(
        vocab=vocab_, special_tokens=get_deprecated_special_tokens()[:NS],
        pattern="", vocab_size=NS + len(TOKENS), num_special_tokens=NS,
        version=tt.TokenizerVersion.V7, device="cpu")


@pytest.mark.parametrize("ids,policy,want", CASES)
def test_decode_reference_cases(small_tok, ids, policy, want):
    ref = DecodeReference(TOKENS, special_strings(NS))
    assert ref.decode(ids, policy) == want
    pol = SpecialTokenPolicy[policy]
    assert small_tok.decode(ids, pol) == want
    assert small_tok.decode_batch([ids, ids[::-1]], pol) == [
        ref.decode(ids, policy), ref.decode(ids[::-1], policy)]


@pytest.mark.parametrize("ids", [[BOS, HE], [HE, INST, LLO]])
def test_decode_reference_raises_on_specials(small_tok, ids):
    ref = DecodeReference(TOKENS, special_strings(NS))
    with pytest.raises(SpecialTokenError):
        ref.decode(ids, "RAISE")
    with pytest.raises(SpecialTokenPolicyError):
        small_tok.decode_batch([ids], SpecialTokenPolicy.RAISE)


def test_special_strings_are_the_legacy_table():
    want = [t.token_str for t in get_deprecated_special_tokens()]
    got = special_strings(1000)
    assert got[:len(want)] == want
    assert got[len(want):] == [f"<SPECIAL_{i}>"
                               for i in range(len(want), 1000)]


@pytest.mark.parametrize("policy", ["IGNORE", "KEEP"])
def test_decode_batch_matches_reference_on_seeded_completions(policy):
    c = small_cell()
    cfg = c.config
    words, tb = vocab.build(cfg, SEED + 1)
    ns = cfg["default_num_special_tokens"]
    pool = cut_characters(c.generator.pool(c.mix, words, Reference(tb, ns),
                                           SEED + 1, cfg), ns)
    tok = common.tokenizer(cfg, tb, "cpu")
    ref = DecodeReference(tb, special_strings(ns))
    comps = [x for s in pool for x in s["completions"]]
    assert tok.decode_batch(comps, SpecialTokenPolicy[policy]) == [
        ref.decode(x, policy) for x in comps]


def test_span_readers_read_a_clocked_step():
    """The clocked quarter keeps the clock's times and the whole spans: the
    ``.serve`` span readers and the corpus cell's mark readers both read
    a step."""
    from tekken_tpu_torch.utils.timing import StageClock

    c = small_cell(pool_batches=1)
    cfg = c.config
    ns = cfg["default_num_special_tokens"]
    words, tb = vocab.build(cfg, SEED)
    (step,) = c.generator.pool(c.mix, words, Reference(tb, ns), SEED, cfg)
    tok = common.tokenizer(cfg, tb, "cpu")
    clock = StageClock()
    tok.encode_batch(step["prompts"], True, False, clock=clock)
    tok.decode_batch(step["completions"], SpecialTokenPolicy.IGNORE,
                     clock=clock)
    ctx = Context(0.0, Window(), cfg, c.mix,
                  stages=[dict(clock.times, spans=serve.span_totals(clock))])
    got = {m: c.readers[m].read(ctx) for m in (
        "encode_ms.serve", "decode_ms.serve", "decode_device_ms.serve")}
    assert all(v > 0 for v in got.values()), got
    assert got["decode_ms.serve"] >= got["decode_device_ms.serve"]
    whole = ctx.stages[0]["spans"]["tekken.encode_batch"]
    assert whole >= clock.times["tekken.encode_batch"]
    ids_ms = spec.load_module(os.path.join(
        REPO, "benchmark", "metrics", "public_ids_ms.corpus.py")).read(ctx)
    assert ids_ms == 1e3 * clock.times["public_ids"] > 0


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("rel", ["benchmark/core/decode_reference.py",
                                 "benchmark/entries/serve.py",
                                 "benchmark/generators/serve.py",
                                 "benchmark/control_serve.py"])
def test_serving_files_import_only_the_public_api(rel):
    mods = set(_imports(os.path.join(REPO, rel)))
    assert not {m.split(".")[0] for m in mods} & {"jax", "jaxlib", "flax",
                                                  "tekken_tpu"}
    program = {m for m in mods if m.split(".")[0] == "tekken_tpu_torch"}
    assert program <= {"tekken_tpu_torch", "tekken_tpu_torch.utils.timing"}
    if rel != "benchmark/entries/serve.py":
        assert not program
