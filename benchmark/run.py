"""Run one cell of the benchmark.

    python3 -m benchmark.run --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

Prints, as the last line of stdout, the result: ``correct``,
``attempted``, ``failed``, the cell's end-to-end metrics (``--trace 0``)
or per-layer metrics (``--trace 1``), the device, with ``--trace 1`` the
breakdown, and last the numbers compared with their limits (also the last
lines of stderr).  Exits non-zero, with no result, without enough CUDA
devices or when a forbidden module (JAX, the JAX package) is loaded once
the window has closed."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    from .core import load, result, spec

    cell = spec.cell(args.workload)
    import torch

    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx, checks, attempted, failed, peak = cell.entry.run(
        cell, args.seed, args.seconds, bool(args.trace), T_START)
    w = ctx.window
    for kind, d in w.durations.items():
        print(f"[window] {kind}: {len(d)} calls in {w.seconds:.3f} s "
              f"(CPU {w.cpu_s:.3f} s), ms a call: "
              f"{[round(x * 1e3, 1) for x in d]}", file=sys.stderr)
    bad = result.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = cell.readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    docs = cell.entry.described(ctx)
    print(json.dumps({"traffic": load.describe(docs, ctx.reference.ranks)}),
          flush=True)
    if args.trace:
        from .entries.common import power_limit

        print(json.dumps({"card": power_limit()}), flush=True)
    result.emit(result.is_correct(checks), attempted, failed, metrics,
                result.device(need, peak, ctx.trace),
                checks, ctx.trace.breakdown() if ctx.trace else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
