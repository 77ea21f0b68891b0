"""PyTorch port: the examples (``tekken_tpu_torch.examples``) against the
repo's ``examples/*.py``, on the CPU.

Each JAX example runs as a script in a subprocess (all five started
together, each in a directory of its own); each port example runs in
this process with ``--device cpu`` on the same synthetic tokenizer.  The
printed ids, texts and counts are equal line for line, except the lines
that name the devices or a throughput (``distributed_corpus``'s, whose
JAX run is a virtual 8-device CPU mesh and the port's a world of one);
the audio example's JSON dump is equal too.  Integer outputs: the
tolerance is exact equality.
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
NAMES = ("basic_tokenizer_test", "basic_usage", "detailed_test",
         "audio_tokenization_test", "distributed_corpus")
# lines that name the devices or a time
DEVICE_LINES = ("devices:", "throughput:")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """name -> (stdout, working directory) of each JAX example."""
    procs = {}
    for name in NAMES:
        cwd = tmp_path_factory.mktemp(f"jax_{name}")
        procs[name] = (subprocess.Popen(
            [sys.executable, str(REPO / "examples" / f"{name}.py")],
            cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"}), cwd)
    out = {}
    for name, (proc, cwd) in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr
        out[name] = (stdout, cwd)
    return out


def _content(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if not ln.startswith(DEVICE_LINES)]


@pytest.mark.parametrize("name", NAMES)
def test_example_prints_the_jax_examples_tokens(name, jax_runs, tmp_path,
                                                monkeypatch, capsys):
    """(g) the same ids, texts and counts as the JAX example."""
    jax_out, jax_cwd = jax_runs[name]
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"tekken_tpu_torch.examples.{name}")
    assert mod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert _content(out) == _content(jax_out)
    assert len(_content(out)) >= 3
    if name == "audio_tokenization_test":
        got = json.loads((tmp_path / "audio_tokenization_results.json")
                         .read_text())
        want = json.loads((jax_cwd / "audio_tokenization_results.json")
                          .read_text())
        assert got == want
    if name == "distributed_corpus":
        assert out.splitlines()[0] == "devices: 1 x cpu"
        assert "throughput: not measured (cpu)" in out


def test_examples_load_a_model_file(merged_tokenizer, tmp_path, capsys):
    """Given a tekken.json, the examples load it (the JAX examples' first
    argument) and print the same ids as the JAX tokenizer."""
    from tekken_tpu import SpecialTokenPolicy

    from tekken_tpu_torch.examples import basic_tokenizer_test, detailed_test

    path = tmp_path / "tekken.json"
    merged_tokenizer.save(path)
    assert basic_tokenizer_test.main([str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    ids = merged_tokenizer.encode("Hello world!", True, True)
    assert out == [f"tokens: {ids}", "decoded: Hello world!", "ok"]
    assert merged_tokenizer.decode(ids, SpecialTokenPolicy.IGNORE) == (
        "Hello world!")
    assert detailed_test.main([str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for text in ("Hello, world!", "123 456 789"):
        n = len(merged_tokenizer.encode(text, False, False))
        assert f"[OK ] {n:3d} tokens  {text!r}" in out
