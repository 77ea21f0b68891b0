"""PyTorch port: the verification tools (``tekken_tpu_torch/tools/``)
against the repo's ``tools/`` scripts, on the CPU.

``validate_model`` prints what ``tools/validate_model.py`` prints and
fails when the device disagrees; the soak and fuzz modules draw the same
texts as the JAX tools from the same seeds (the JAX tools run with their
engines stubbed, so only their draws run); a short seeded soak holds
every port engine against the oracle and the JAX ``PackedEncoder``; the
pretokenizer fuzz passes at its ``--smoke`` size; ``multichip_scale``
runs on two gloo ranks in spawned processes.  Integer outputs: the
tolerance is exact equality.

The spawned ranks import this module by name, so it imports neither jax
nor the JAX package at the top (each rank checks that its process holds
neither).
"""

import datetime
import importlib.util
import itertools
import os
import pickle
import random
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from tekken_tpu_torch.tools import (first_difference, fuzz_all_engines,
                                    fuzz_pretokenize, mismatch_line, soak,
                                    validate_model)

REPO = Path(__file__).resolve().parents[1]


def _jax_tool(name):
    """The repo's ``tools/<name>.py``, imported from its path."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def model(merged_tokenizer, tmp_path_factory):
    path = tmp_path_factory.mktemp("tools") / "tekken.json"
    merged_tokenizer.save(path)
    return str(path)


# --------------------------------------------------------------------- #
# validate
# --------------------------------------------------------------------- #

def test_validate_fails_on_a_device_difference(model, capsys, monkeypatch):
    """encode_batch drops the last id of the first probe: that probe is
    the one failure, and the CLI returns 1."""
    from tekken_tpu_torch.__main__ import main
    from tekken_tpu_torch.tekkenizer import Tekkenizer

    real = Tekkenizer.encode_batch

    def drop_one(self, texts, *a, **kw):
        out = real(self, texts, *a, **kw)
        return [ids[:-1] if t == validate_model.PROBE[0] else ids
                for t, ids in zip(texts, out)]

    monkeypatch.setattr(Tekkenizer, "encode_batch", drop_one)
    capsys.readouterr()
    rc = main(["validate", "--model", model, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 1
    assert out[-1] == "VALIDATION FAILED: 1 failures"
    assert sum(line.startswith("  [FAIL]") for line in out) == 1
    assert out[3].startswith("  [FAIL]") and "Hello, world!" in out[3]


def test_validate_without_a_model_prints_its_usage(capsys):
    assert validate_model.main([]) == 2
    assert "validate_model" in capsys.readouterr().out


# --------------------------------------------------------------------- #
# the same texts as the JAX tools
# --------------------------------------------------------------------- #

class _FakeTok:
    """Stands in for the JAX tools' tokenizer: ids are code points."""
    ranks = None

    def num_special_tokens(self):
        return 0

    def decode(self, ids, policy):
        return "".join(map(chr, ids))


class _Recorder:
    """Stands in for an engine: records each batch, returns code points."""

    def __init__(self, batches):
        self.batches = batches

    def encode_batch(self, texts):
        self.batches.append(list(texts))
        return [[ord(c) for c in t] for t in texts]


def _stub_engines(monkeypatch, mod, batches, merges):
    import tekken_tpu.native

    def build(num_merges, **kw):
        merges.append(num_merges)
        return _FakeTok()

    def no_native(tok):
        raise RuntimeError("stubbed out")

    monkeypatch.setattr(mod, "build_synthetic_tokenizer", build)
    monkeypatch.setattr(mod, "PackedEncoder",
                        lambda *a, **kw: _Recorder(batches))
    monkeypatch.setattr(mod, "encode_ranks",
                        lambda t, ranks: [ord(c) for c in t])
    monkeypatch.setattr(tekken_tpu.native, "NativeEncoder", no_native)


@pytest.mark.parametrize("seed", [20260817, 5])
def test_soak_draws_the_jax_soaks_texts(seed, monkeypatch, capsys):
    """Three vocabulary rounds of the JAX soak (its clock stubbed to count
    rounds, its generator seeded with ``seed``) against the port's."""
    jax_soak = _jax_tool("soak")
    batches, merges = [], []
    _stub_engines(monkeypatch, jax_soak, batches, merges)
    monkeypatch.setattr(jax_soak, "random", types.SimpleNamespace(
        Random=lambda _: random.Random(seed)))
    clock = itertools.count()
    monkeypatch.setattr(jax_soak, "time", types.SimpleNamespace(
        time=lambda: next(clock)))
    assert jax_soak.main(3.5 / 60) == 0          # rounds at clock 1, 2, 3

    rng = random.Random(seed)
    want_merges, want = [], []
    for _ in range(3):
        want_merges.append(rng.choice(soak.MERGE_CHOICES))
        want += [soak.draw_texts(rng) for _ in range(4)]
    assert merges == want_merges and batches == want
    assert soak.ALPHAS == jax_soak.ALPHAS
    assert soak.TRAIN_TEXTS == jax_soak.TRAIN_TEXTS
    assert capsys.readouterr().out.endswith(
        f"SOAK OK: {sum(map(len, want))} docs across 3 vocab rounds\n")


@pytest.mark.parametrize("seed", [0, 9])
def test_fuzz_draws_the_jax_fuzzs_texts(seed, monkeypatch):
    jax_fuzz = _jax_tool("fuzz_all_engines")
    batches, merges = [], []
    _stub_engines(monkeypatch, jax_fuzz, batches, merges)
    monkeypatch.setattr(jax_fuzz, "FlatEncoder",
                        lambda *a, **kw: _Recorder([]))
    assert jax_fuzz.main(6, seed) == 0
    rng = random.Random(seed)
    assert batches == [fuzz_all_engines.draw_batch(rng, b) for b in range(6)]
    assert merges == [fuzz_all_engines.N_MERGES]
    assert fuzz_all_engines.ALPHABETS == jax_fuzz.ALPHABETS


@pytest.mark.parametrize("seed", [0, 3])
def test_pretokenize_fuzz_draws_the_jax_fuzzs_texts(seed, monkeypatch):
    jax_fuzz = _jax_tool("fuzz_pretokenize")
    cases = []

    def record(t):
        cases.append(t)
        return jax_fuzz.pretokenize(t)

    monkeypatch.setattr(jax_fuzz, "pretokenize_vec", record)
    assert jax_fuzz.main(n_random=400, seed=seed) == 0
    assert cases == fuzz_pretokenize.draw_cases(400, seed)
    assert fuzz_pretokenize.HAND_CASES == jax_fuzz.HAND_CASES


# --------------------------------------------------------------------- #
# short runs of the tools
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("n_merges", [0, 200])
def test_short_seeded_soak(n_merges, monkeypatch):
    """Two batches of up to 8 docs of up to 256 chars (8 x 1024): the
    port's PackedEncoder, native engine and the decode round trip equal
    the oracle, and the JAX PackedEncoder gives the same ids.  The JAX
    encoder takes both batches in one call and routes it as a whole
    (``TEKKEN_TPU_GROUP_ROUTES=0``), so it compiles one program a
    vocabulary; a doc's ids do not depend on its batch or route."""
    from tekken_tpu.models import build_synthetic_tokenizer
    from tekken_tpu.ops.packed import PackedEncoder as JPackedEncoder

    monkeypatch.setenv("TEKKEN_TPU_GROUP_ROUTES", "0")

    rng = random.Random(31 + n_merges)
    tok, enc, batches, bad = soak.soak_vocab(
        n_merges, rng, seed=31, device="cpu", n_batches=2, rows=8,
        row_len=1024, max_chars=256)
    assert bad == []
    assert len(tok.ranks) == 256 + min(n_merges, 185)  # TRAIN_TEXTS' pairs
    jtok = build_synthetic_tokenizer(num_merges=n_merges,
                                     num_special_tokens=20,
                                     texts=soak.TRAIN_TEXTS)
    assert jtok.ranks == tok.ranks
    # both batches in one JAX call: one compiled program a vocabulary
    jenc = JPackedEncoder(jtok, rows=16, row_len=1024)
    assert ([d for texts in batches for d in enc.encode_batch(texts)]
            == jenc.encode_batch([t for texts in batches for t in texts]))


def test_soak_and_fuzz_report_a_mismatch(monkeypatch, capsys):
    """A device engine that drops an id: the soak prints the merge count,
    the seed, the doc and each engine's first differing index, and
    returns 1; so does the cross-engine fuzz."""
    from tekken_tpu_torch.ops.packed import PackedEncoder

    real = PackedEncoder.encode_batch

    def drop(self, texts, clock=None):
        return [ids[1:] if ids else ids for ids in real(self, texts)]

    monkeypatch.setattr(PackedEncoder, "encode_batch", drop)
    assert soak.main(seconds=60, seed=4, device="cpu") == 1  # round 1
    out = capsys.readouterr().out
    assert "MISMATCH merges=" in out and " seed=4 doc=" in out
    assert "first differing index: device 0, native -, decode -" in out
    assert "SOAK FAILED" in out
    assert fuzz_all_engines.main(1, seed=2, device="cpu") == 1
    out = capsys.readouterr().out
    assert "MISMATCH merges=400 seed=2 doc=" in out
    assert "packed 0, flat -, native -" in out


def test_first_difference():
    assert first_difference([1, 2, 3], [1, 2, 3]) is None
    assert first_difference([1, 5, 3], [1, 2, 3]) == 1
    assert first_difference([1, 2], [1, 2, 3]) == 2
    assert first_difference("ab", "abc") == 2
    assert mismatch_line(0, 1, "x", {"a": None, "b": 3}) == (
        "MISMATCH merges=0 seed=1 doc='x' first differing index: a -, b 3")


def test_fuzz_short_run_passes(capsys):
    assert fuzz_all_engines.main(2, seed=1, device="cpu") == 0
    assert " across 2 batches; bad 0" in capsys.readouterr().out


def test_pretokenize_fuzz_smoke_passes(capsys):
    assert fuzz_pretokenize.main(400, seed=0, device="cpu") == 0
    assert capsys.readouterr().out.endswith(
        f"checked {len(fuzz_pretokenize.HAND_CASES) + 400} bad 0\n")


def test_profile_loading_stages(model, capsys):
    from tekken_tpu_torch.tools import profile_loading

    assert profile_loading.main([model, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for stage in ("file read", "JSON parse + schema",
                  "Tekkenizer construction", "pair table (linear probe)",
                  "pair table (cuckoo)", "word map", "device tables upload",
                  "first encode (host engine)", "total"):
        assert f"\n{stage} " in out, stage


# --------------------------------------------------------------------- #
# multichip_scale on two gloo ranks
# --------------------------------------------------------------------- #

def _rank_main(rank, tmp, world):
    """One spawned rank: multichip_scale.run as torchrun would, saved."""
    assert "jax" not in sys.modules and "tekken_tpu" not in sys.modules
    import torch
    import torch.distributed as dist

    from tekken_tpu_torch.tools import multichip_scale

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = multichip_scale.run("synthetic", rows=8, row_len=256,
                                  device="cpu")
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def test_multichip_scale_on_two_gloo_ranks(tmp_path):
    """Both ranks pass parity and the counter checks (``run`` raises
    otherwise) and report both points of each sweep; the tokens equal the
    JAX oracle's on the same docs."""
    import torch.multiprocessing as mp

    from tekken_tpu.models import build_synthetic_tokenizer
    from tekken_tpu.oracle import encode_ranks
    from tekken_tpu_torch.models import bench_words, build_corpus
    from tekken_tpu_torch.models.bench import BENCH_SEED

    ctx = mp.start_processes(_rank_main, args=(str(tmp_path), 2), nprocs=2,
                             join=False, start_method="spawn")
    rng = random.Random(BENCH_SEED)
    docs = build_corpus(bench_words(rng), rng, n_docs=8, doc_len=256)
    jtok = build_synthetic_tokenizer(num_merges=400, num_special_tokens=20)
    want_tokens = sum(len(encode_ranks(d, jtok.ranks)) for d in docs)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the spawned ranks did not finish in 240 s")
    outs = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))

    for out in outs:
        assert out["devices"] == 2 and out["device_counts"] == [1, 2]
        assert out["bytes"] == sum(len(d.encode()) for d in docs)
        assert out["tokens"] == want_tokens
        assert out["parity"].startswith("ok") and out["counters"].startswith(
            "ok")
        assert [p["devices"] for p in out["dp_overhead"]["points"]] == [1, 2]
        assert out["dp_overhead"]["points"][0][
            "overhead_ratio_vs_single"] == 1.0
        assert [p["devices"] for p in out["scaling"]["points"]] == [1, 2]
        assert all(p["bytes_per_sec"] > 0 for p in out["scaling"]["points"])
        assert [r["rank"] for r in out["ranks"]] == [0, 1]
        assert all(r["card"] == "cpu" for r in out["ranks"])
    assert outs[0] == {**outs[1], "seconds": outs[0]["seconds"]}


# --------------------------------------------------------------------- #
# validate against the JAX tool (its subprocess started with the file)
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module", autouse=True)
def jax_validate(model):
    """``tools/validate_model.py`` on the model, as ``python -m tekken_tpu
    validate`` runs it: a subprocess, started before the file's first test
    so that its compiles overlap the other tests."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, str(REPO / "tools" /
                                                 "validate_model.py"), model],
                            stdout=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def test_validate_prints_what_the_jax_tool_prints(model, jax_validate,
                                                  capsys):
    got = (validate_model.main([model, "--device", "cpu"]),
           capsys.readouterr().out)
    out, _ = jax_validate.communicate(timeout=300)
    assert got == (jax_validate.returncode, out)
    assert got[0] == 0 and got[1].endswith("VALIDATION OK\n")
    assert "native engine parity: checked" in got[1]
    assert validate_model.PROBE == _jax_tool("validate_model").PROBE
