"""PyTorch port: the benchmark tools (``tekken_tpu_torch.tools.bench``,
``profile_packed_stages``, ``bench_batchscale``, ``bench_ab``,
``analyze_bench_load``) against the repo's ``bench.py`` and ``tools/``,
on the CPU.

The bench line keeps ``bench.py``'s keys (read from its source, not
imported); the route sweep's traffic routes as ``bench.py`` asserts, by
the JAX package's ``host_route`` and the port's; the CPU rehearsal passes
every parity check and prints every rate as null; nothing falls back
(no card raises, a failing section exits non-zero with no line, and no
new module has an ``except`` clause); the load analysis prints what the
JAX tool prints.  A small bench vocabulary (4,096 inner ranks) and 8-64
rows keep it quick.  Integer outputs: the tolerance is exact equality.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from tekken_tpu_torch.models import bench_tokenizer, bench_words, build_corpus
from tekken_tpu_torch.ops import packed
from tekken_tpu_torch.tools import (analyze_bench_load, bench, bench_ab,
                                    bench_batchscale, profile_packed_stages)

REPO = Path(__file__).resolve().parents[1]
RATE_KEYS = ("device_packed_path_bytes_per_sec",
             "host_dispatched_loop_bytes_per_sec",
             "device_decode_bytes_per_sec",
             "decode_batch_end_to_end_bytes_per_sec",
             "native_host_engine_bytes_per_sec", "route2_bytes_per_sec",
             "route3_bytes_per_sec", "mixed_1pct_nonascii_bytes_per_sec",
             "mixed_vs_route1_time_ratio")


@pytest.fixture(scope="module")
def words():
    return bench_words()


@pytest.fixture(scope="module")
def tok(words):
    return bench_tokenizer(words, "cpu", inner_vocab=4096)


def small_tokenizer(words, device):
    return bench_tokenizer(words, device, inner_vocab=4096)


def _jax_line_keys():
    """The keys of the dict literal in bench.py's ``json.dumps`` call: (its
    top level, its ``detail``)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            top = node.args[0]
            keys = [k.value for k in top.keys]
            detail = top.values[keys.index("detail")]
            return keys, [k.value for k in detail.keys]
    raise AssertionError("no json.dumps dict in bench.py")


@pytest.fixture(scope="module")
def rehearsal(tok, words):
    return bench.run(tok, words, rows=16, reps=2, iters=1, decode_reps=2,
                     decode_iters=1, device="cpu")


# --------------------------------------------------------------------- #
# the line
# --------------------------------------------------------------------- #

def test_line_keys_are_bench_py_keys(rehearsal):
    """(a) bench.py's keys, less vs_baseline, device_error and
    target_bytes_per_sec, plus shapes."""
    top, detail = _jax_line_keys()
    assert "vs_baseline" in top and "device_error" in detail
    assert list(rehearsal) == [k for k in top if k != "vs_baseline"]
    assert list(rehearsal["detail"]) == [
        k for k in detail if k not in ("device_error", "target_bytes_per_sec")
    ] + ["shapes"]
    assert set(RATE_KEYS) < set(detail)


def test_cpu_rehearsal_prints_no_rate(rehearsal, tok, words):
    """(c) every section and parity check ran (run raises otherwise) and
    every rate is null off the card; the decode section took the whole
    batch's ranks."""
    d = rehearsal["detail"]
    docs = build_corpus(words, bench.corpus_rng(), n_docs=16, doc_len=2048)
    assert rehearsal["metric"] == "encode_bytes_per_sec_per_chip"
    assert rehearsal["unit"] == "bytes/s" and rehearsal["value"] is None
    assert all(d[k] is None for k in RATE_KEYS)
    assert d["compile_seconds"] is None
    assert d["headline_variant"] == "device-packed"
    assert d["platform"] == "cpu (rehearsal: rates not measured)"
    assert d["shapes"]["rows"] == 16 and d["shapes"]["row_len"] == 2048
    assert d["shapes"]["route_rows"] == 16
    assert d["shapes"]["decode_tokens"] == sum(
        len(tok._host_ranks(t)) for t in docs)


def test_main_prints_one_line_last(words, monkeypatch, capsys):
    monkeypatch.setattr(bench, "bench_tokenizer", small_tokenizer)
    assert bench.main(["--rows", "8", "--reps", "1", "--iters", "1",
                       "--decode-reps", "1", "--decode-iters", "1",
                       "--no-routes", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    line = json.loads(out[-1])
    assert len(out) == 1 and line["value"] is None
    assert line["detail"]["shapes"]["route_rows"] is None
    assert line["detail"]["route2_bytes_per_sec"] is None


# --------------------------------------------------------------------- #
# the route sweep's traffic
# --------------------------------------------------------------------- #

def test_route_generators_route_as_bench_py_asserts(words):
    """(b) each batch of the sweep routes as asserted, by the JAX
    package's host_route and by the port's."""
    from tekken_tpu.ops.packed import host_route as jax_host_route

    docs = build_corpus(words, bench.corpus_rng(), n_docs=64, doc_len=2048)
    major, minor, rows3 = bench.mixed_docs(docs)
    assert (len(major), len(minor), rows3) == (63, 1, 8)
    assert all(d.endswith("中") for d in minor)
    for texts, rows, want in ((bench.route2_docs(docs), 64, 2),
                              (bench.route3_docs(docs), 64, 3),
                              (docs, 64, 1), (major, 64, 1),
                              (minor, rows3, 3)):
        buf, lens = bench.pack_docs(texts, rows)
        assert lens[:len(texts)].tolist() == [len(t.encode()) for t in texts]
        assert packed.host_route(buf) == jax_host_route(buf) == want


def test_bench_docs_are_bench_py_docs(words):
    """The corpus follows the words from one random.Random(1234), as in
    bench.py (its builders are the JAX package's copies' source)."""
    import random

    import bench as jax_bench

    rng = random.Random(1234)
    jwords = ["".join(rng.choice("abcdefghijklmnopqrstuvwxyz")
                      for _ in range(rng.randint(2, 11)))
              for _ in range(40_000)]
    assert jwords == words
    assert jax_bench.build_corpus(jwords, rng, 8, 2048) == build_corpus(
        words, bench.corpus_rng(), n_docs=8, doc_len=2048)


# --------------------------------------------------------------------- #
# no fallback
# --------------------------------------------------------------------- #

def test_cuda_without_a_card_raises(tok, words):
    """(d) the CPU-only torch here has no card: the bench raises."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(tok, words, rows=8, device="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "tekken_tpu_torch.tools.bench", "--rows", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_a_failing_section_prints_no_line(words, monkeypatch, capsys):
    """(d) packed_encode raising: main propagates it (the process exits
    non-zero) and prints nothing on stdout."""
    def broken(*a, **kw):
        raise RuntimeError("device fault")

    monkeypatch.setattr(bench, "bench_tokenizer", small_tokenizer)
    monkeypatch.setattr(packed, "packed_encode", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        bench.main(["--rows", "8", "--device", "cpu"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("path", [
    "tools/bench.py", "tools/profile_packed_stages.py",
    "tools/bench_batchscale.py", "tools/bench_ab.py",
    "tools/analyze_bench_load.py", "examples/__init__.py",
    "examples/basic_tokenizer_test.py", "examples/basic_usage.py",
    "examples/detailed_test.py", "examples/audio_tokenization_test.py",
    "examples/distributed_corpus.py"])
def test_no_except_clause(path):
    """(d) no new module catches an exception (so none turns a device
    fault into a host number)."""
    tree = ast.parse((REPO / "tekken_tpu_torch" / path).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]


# --------------------------------------------------------------------- #
# the host analysis and the sibling tools
# --------------------------------------------------------------------- #

def test_analyze_bench_load_prints_the_jax_tools_lines(capsys):
    """(e) host-only: the same stdout as tools/analyze_bench_load.py."""
    proc = subprocess.run([sys.executable, "tools/analyze_bench_load.py"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0
    assert analyze_bench_load.main() == 0
    assert capsys.readouterr().out == proc.stdout
    assert proc.stdout.startswith("docs=32 bytes=")


def _no_rate(out: str):
    assert "MB/s" not in out and "ms/iter" not in out and " in " not in out


@pytest.mark.parametrize("device_route", [False, True])
def test_profile_packed_stages_lists_the_stages(tok, words, capsys,
                                                device_route):
    """(f) the routed path's clocked stages, or the flat path's, each
    with no time off the card."""
    got = profile_packed_stages.run(tok, words, rows=8, reps=2,
                                    device_route=device_route, device="cpu")
    out = capsys.readouterr().out
    _no_rate(out)
    names = [ln.split()[0] for ln in out.splitlines()[2:]]
    stages = (["branch", "stage1", "probe_emit", "merge"] if device_route
              else ["stage1", "probe_emit", "p23", "merge"])
    assert out.splitlines()[0] == "card: cpu"
    assert f"route={None if device_route else 1}" in out.splitlines()[1]
    assert names == ["boundaries", *stages, "stage", "clocked", "full", "sum"]
    assert list(got["stages_ms"]) == stages
    assert got["full_ms"] is None and got["clock_ms"] is None
    assert got["clocked_ms"] is None


def test_bench_batchscale_times_sizes_in_turns(tok, words, capsys):
    got = bench_batchscale.run(tok, words, sizes=(8, 16), reps=1, samples=2,
                               device="cpu")
    out = capsys.readouterr().out.splitlines()
    _no_rate("\n".join(out))
    assert got == {"B=8": [], "B=16": []}
    assert [ln.split()[:3] for ln in out if ln.startswith("sample")] == [
        ["sample", "0", "B=8"], ["sample", "0", "B=16"],
        ["sample", "1", "B=8"], ["sample", "1", "B=16"]]
    assert out[out.index("---") + 1:] == [
        "       B=8 not measured (cpu): 2 samples of 1 calls",
        "      B=16 not measured (cpu): 2 samples of 1 calls"]


def test_bench_ab_routed_and_flat_agree(tok, words, capsys):
    """The two variants warm to the same token count (the flat path is
    exact too) and are timed in turns."""
    got = bench_ab.run(tok, words, rows=8, reps=1, samples=1, device="cpu")
    out = capsys.readouterr().out.splitlines()
    _no_rate("\n".join(out))
    assert got == {"routed": [], "flat": []}
    warm = [ln for ln in out if ln.startswith("warmed")]
    assert [ln.split()[1] for ln in warm] == ["routed", "flat"]
    assert len({ln.split("n_out ")[1] for ln in warm}) == 1


@pytest.mark.parametrize("tool,argv", [
    (profile_packed_stages, ["--rows", "8", "--reps", "1", "--device-route"]),
    (bench_batchscale, ["--sizes", "8", "--reps", "1", "--samples", "1"]),
    (bench_ab, ["--rows", "8", "--reps", "1", "--samples", "1"])])
def test_sibling_mains(tool, argv, monkeypatch, capsys):
    monkeypatch.setattr(tool, "bench_tokenizer", small_tokenizer)
    assert tool.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    _no_rate(out)
    assert out.startswith("card: cpu\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)

