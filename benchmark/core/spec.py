"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``configs/<config>.json``), traffic mix (``traffic/<mix>.json``), the
mix's generator (``generators/<generator>.py``, named by the mix), entry
point (``entries/<entry>.py``, named by the configuration) and metric
readers (``metrics/<metric>.py``), each found by its name."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path):
    """A module from a file path (metric files carry dots in their names,
    so they are not importable by name)."""
    name = "benchmark_file_" + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    generator: object     # the mix's generator module (``pool(...)``)
    end_to_end: list      # metric entries of BENCHMARK.json
    per_layer: list
    entry: object         # the entry module
    readers: dict         # metric name -> reader module


def metrics_of(bench: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics that ``cell`` reports: those
    that list it, or list no cells (a per-layer metric without a list
    goes with its end-to-end metric)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def cell(name: str, bench_path=None, base=HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    cfg = load_json(os.path.join(os.path.dirname(base), conf["file"]))
    mix = load_json(os.path.join(base, "traffic", w["traffic"] + ".json"))
    generator = load_module(os.path.join(base, "generators",
                                         mix["generator"] + ".py"))
    e2e, layer = metrics_of(bench, name)
    entry = importlib.import_module(f"{os.path.basename(base)}.entries."
                                    f"{cfg['entry']}")
    readers = {m["name"]: load_module(os.path.join(base, "metrics",
                                                   m["name"] + ".py"))
               for m in e2e + layer}
    return Cell(name, w, cfg, mix, generator, e2e, layer, entry,
                readers)
