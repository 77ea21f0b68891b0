"""Cells are driven by data: a configuration, a traffic mix, its
generator and a metric are found by their names, so adding one takes new
files and entries only.  A copy of the folder gets a dummy of each, and
a tiny run drives the dummy generator's docs and reads the dummy
metric."""

import json
import os
import shutil

from benchmark.core import spec
from benchmark.tests import tiny

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(os.path.dirname(HERE), "BENCHMARK.json")


def test_every_name_has_its_file():
    bench = spec.load_json(BENCH)
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert c.config["name"] == w["config"]
        assert c.readers, w["name"]
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in e2e
    for conf in bench["configs"]:
        assert os.path.exists(os.path.join(os.path.dirname(HERE),
                                           conf["file"]))


def test_dummy_config_mix_and_metric(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.load(open(base / "configs" / "tekken_v7_corpus.json"))
    cfg["name"] = "dummy_config"
    (base / "configs" / "dummy_config.json").write_text(json.dumps(cfg))
    mix = json.load(open(base / "traffic" / "multilingual.json"))
    mix["replace"] = []
    mix["generator"] = "dummy_gen"
    (base / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (base / "generators" / "dummy_gen.py").write_text(
        "def pool(mix, words, is_token, seed, n_docs):\n"
        "    return [[' '.join(words[:3]) + f' {b}'] * n_docs\n"
        "            for b in range(mix['pool_batches'])]\n")
    (base / "metrics" / "calls_done.dummy.py").write_text(
        "def read(ctx):\n"
        "    return float(len(ctx.window.durations['encode']))\n")
    bench = spec.load_json(BENCH)
    bench["configs"].append({"name": "dummy_config", "source": "x",
                             "file": "benchmark/configs/dummy_config.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy.cell",
                               "config": "dummy_config",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "calls_done.dummy", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "encode_MBps",
                               "workloads": ["dummy.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "encode_MBps":
            m["workloads"].append("dummy.cell")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))

    c = spec.cell("dummy.cell", bench_path=str(path), base=str(base))
    assert [m["name"] for m in c.per_layer] == ["calls_done.dummy"]
    assert sorted(m["name"] for m in c.end_to_end) == ["encode_MBps",
                                                       "setup_s"]
    c.config.update(tiny.TINY_CONFIG)
    c.mix.update({k: v for k, v in tiny.TINY_MIX.items() if k in c.mix})
    ctx, checks, *_ = tiny.run("dummy.cell", c=c)
    assert checks["answers_wrong"]["value"] == 0
    assert ctx.pool[1][0].endswith(" 1")
    assert c.readers["calls_done.dummy"].read(ctx) >= 1
    assert c.readers["encode_MBps"].read(ctx) > 0
