"""No JAX, no JAX package: a run's modules compared by whole top-level
name, and the benchmark's own yardstick (core/, metrics/, generators/,
control.py) imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.core import result

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)


@pytest.mark.parametrize("mods,bad", [
    ({"tekken_tpu_torch": 0, "tekken_tpu_torch.ops": 0}, []),
    ({"tekken_tpu": 0}, ["tekken_tpu"]),
    ({"tekken_tpu.ops.packed": 0}, ["tekken_tpu"]),
    ({"jax._src": 0, "jaxlib": 0}, ["jax", "jaxlib"]),
    ({"jaxtyping": 0, "flax": 0, "tekken_tpu_torchx": 0}, ["flax"]),
])
def test_whole_name_match(mods, bad):
    assert result.forbidden_modules(mods) == bad


def test_tiny_run_loads_no_forbidden_module():
    code = (
        "import sys, json\n"
        "from benchmark.tests import tiny\n"
        "from benchmark.core import result\n"
        "for n in ('corpus.multilingual',):\n"
        "    c = tiny.cell(n)\n"
        "    ctx, *_ = tiny.run(n, c=c)\n"
        "    [c.readers[m['name']].read(ctx) for m in c.end_to_end]\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        "print(json.dumps(result.forbidden_modules()))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    top, bad = p.stdout.strip().splitlines()[-2:]
    assert "tekken_tpu_torch" in top
    assert bad == "[]"
    for name in ("jax", "jaxlib", "flax", "tekken_tpu"):
        assert f'"{name}"' not in top


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _files(*parts):
    base = os.path.join(HERE, *parts)
    if base.endswith(".py"):
        return [base]
    return [os.path.join(base, f) for f in sorted(os.listdir(base))
            if f.endswith(".py")]


@pytest.mark.parametrize("path", _files("core") + _files("metrics")
                         + _files("generators") + _files("control.py"))
def test_yardstick_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"tekken_tpu_torch", "tekken_tpu", "jax", "jaxlib",
                       "flax", "chip_smoke", "bench", "tools"}, path
