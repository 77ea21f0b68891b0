"""The result line: its keys, the checks last, and a run without a card
or without the port fails with no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.core import result

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_last_line_keys(capsys):
    checks = {"answers_wrong": {"value": 0, "limit": 0}}
    dev = {"platform": "gpu", "kind": "x", "count": 1,
           "memory_peak_bytes": 5}
    result.emit(True, 3, 0, {"m": {"value": 1.5, "unit": "s"}}, dev, checks,
                {"device_ops": [], "idle_gaps": []})
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == KEYS
    assert list(line)[-1] == "checks"
    assert line["breakdown"] == {"device_ops": [], "idle_gaps": []}
    assert err.strip().splitlines()[-1] == "check answers_wrong: 0 (limit 0)"


@pytest.mark.parametrize("value,limit,ok", [(0, 0, True), (1, 0, False),
                                            (3, 5, True)])
def test_is_correct(value, limit, ok):
    assert result.is_correct({"a": {"value": value, "limit": limit},
                              "b": {"value": 0, "limit": 0}}) is ok


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "corpus.multilingual",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120, env=env)


def _no_result(proc):
    assert proc.returncode != 0
    for ln in proc.stdout.splitlines():
        assert not ln.startswith('{"correct"')


def test_without_card_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _no_result(_run(REPO))


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    _no_result(_run(tmp_path, env))
