"""The run's result: the device it ran on, the import check and the last
line."""

from __future__ import annotations

import json
import sys

# top-level module names that a run of the port may not load (compared
# whole: tekken_tpu_torch is the port, tekken_tpu the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "tekken_tpu")


def forbidden_modules(modules=None) -> list[str]:
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN))


def device(count: int, peak_bytes: int, trace=None) -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        out["busy_s"] = trace.busy_s
        out["window_s"] = trace.window_s
    return out


def is_correct(checks: dict) -> bool:
    """Every number compared within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def emit(correct, attempted, failed, metrics, dev, checks,
         breakdown=None) -> None:
    """The check lines last on stderr, the result last on stdout, its
    ``checks`` key last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    print(json.dumps(line), flush=True)
