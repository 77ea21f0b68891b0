"""On the card: every cell of BENCHMARK.json runs short, untraced and
traced, and prints a correct result with its metrics.  Skips without a
CUDA device (decided in the fixture)."""

import json
import os
import subprocess

import pytest

from benchmark.core import spec

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = spec.load_json(os.path.join(REPO, "BENCHMARK.json"))


@pytest.fixture
def cards():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.cuda.device_count()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_card(cards, name, trace):
    w = [x for x in BENCH["workloads"] if x["name"] == name][0]
    if cards < w["chips"]:
        pytest.skip(f"{name} needs {w['chips']} cards")
    p = subprocess.run(BENCH["command"] + [
        "--workload", name, "--seed", "2147484500", "--seconds", "4",
        "--trace", str(trace)], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    e2e, layer = spec.metrics_of(BENCH, name)
    assert set(line["metrics"]) == {m["name"] for m in
                                    (layer if trace else e2e)}
    if trace:
        assert line["device"]["busy_s"] > 0
