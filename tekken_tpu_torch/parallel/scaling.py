"""Data-parallel scaling-efficiency report.

Sharded corpus, data-parallel encode over a process group, tables copied
to every rank, all-reduced token counts, and a bytes/s scaling report with
the >= 80% 1 -> N efficiency target.

Each device count n is the subgroup of ranks 0..n-1 (``make_dp_mesh(n)``):
every rank of the default group calls these functions together, the ranks
of the subgroup measure, and the others wait at a barrier.  The report is
complete on rank 0 (a rank holds the points of the subgroups it is in).
Without a process group only n = 1 is possible.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch.distributed as dist

from .encode import DistributedEncoder
from .mesh import make_dp_mesh


@dataclass
class ScalingPoint:
    n_devices: int
    bytes_per_sec: float          # mean over samples
    total_bytes: int
    total_tokens: int
    samples: list = field(default_factory=list)  # bytes/s per repeat

    def spread(self) -> dict:
        s = np.asarray(self.samples if self.samples
                       else [self.bytes_per_sec])
        return {"mean": round(float(s.mean()), 1),
                "min": round(float(s.min()), 1),
                "max": round(float(s.max()), 1),
                "rel_spread": round(float((s.max() - s.min())
                                          / max(s.mean(), 1e-9)), 3)}


@dataclass
class ScalingReport:
    points: list = field(default_factory=list)

    def efficiency(self) -> float:
        """bytes/s/device at max mesh vs single device (means)."""
        if len(self.points) < 2:
            return 1.0
        base = self.points[0]
        last = self.points[-1]
        per_dev_base = base.bytes_per_sec / base.n_devices
        per_dev_last = last.bytes_per_sec / last.n_devices
        return per_dev_last / per_dev_base

    def summary(self) -> dict:
        return {
            "points": [
                {"devices": p.n_devices,
                 "bytes_per_sec": round(p.bytes_per_sec, 1),
                 **p.spread()}
                for p in self.points
            ],
            "scaling_efficiency": round(self.efficiency(), 4),
        }


def _sync(x) -> int:
    return int(x)  # scalar readback = real synchronization


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _words(rng):
    return ["".join(rng.choice("abcdefghijklmnopqrstuvwxyz")
                    for _ in range(rng.randint(2, 10)))
            for _ in range(2000)]


def _docs(rng, words, n_docs, row_len):
    docs = []
    for _ in range(n_docs):
        parts: list[str] = []
        size = 0
        while size < row_len - 12:
            w = rng.choice(words)
            parts.append(w)
            size += len(w) + 1
        docs.append(" ".join(parts)[:row_len])
    return docs


def _buffer(docs, rows, row_len):
    buf = np.zeros((rows, row_len), dtype=np.uint8)
    lengths = np.zeros(rows, dtype=np.int32)
    for i, t in enumerate(docs):
        d = t.encode("utf-8")
        buf[i, :len(d)] = np.frombuffer(d, dtype=np.uint8)
        lengths[i] = len(d)
    return buf, lengths


def measure_dp_overhead(tokenizer, device_counts, rows: int = 128,
                        row_len: int = 2048, iters: int = 2,
                        rng_seed: int = 0, repeats: int = 4) -> dict:
    """Fixed-TOTAL-work sharding-overhead measurement: the SAME ``rows`` x
    ``row_len`` buffer runs on meshes of increasing size, and
    t_mesh / t_single shows what the sharding adds (the split of the rows,
    the all-reduce); on separate GPUs each rank's share of the work also
    shrinks, so the ratio falls below 1 as far as the work is the device's
    and the rank's own host work."""
    import random

    rng = random.Random(rng_seed)
    docs = _docs(rng, _words(rng), rows, row_len)
    buf, lengths = _buffer(docs, rows, row_len)
    total_bytes = int(lengths.sum())

    from ..ops.packed import host_route
    route = host_route(buf)

    points = []
    for n in device_counts:
        mesh = make_dp_mesh(n, device=tokenizer._device)
        if mesh.member:
            enc = DistributedEncoder(tokenizer, mesh=mesh, rows=rows,
                                     row_len=row_len)
            out = enc.encode_step(buf, lengths, route=route)
            _sync(out[-2])  # warmup
            samples = []
            for _ in range(max(1, repeats)):
                t0 = time.time()
                for _ in range(iters):
                    out = enc.encode_step(buf, lengths, route=route)
                _sync(out[-1])
                samples.append((time.time() - t0) / iters)
            points.append({"devices": n,
                           "seconds_mean": round(float(np.mean(samples)), 4),
                           "seconds_min": round(float(np.min(samples)), 4),
                           "seconds_max": round(float(np.max(samples)), 4),
                           "samples": [round(s, 4) for s in samples]})
        _barrier()
    base = points[0]["seconds_mean"]
    for p in points:
        p["overhead_ratio_vs_single"] = round(p["seconds_mean"] / base, 4)
    return {
        "total_bytes": total_bytes,
        "route": route,
        "points": points,
        "max_overhead_ratio": max(p["overhead_ratio_vs_single"]
                                  for p in points),
    }


def measure_scaling(tokenizer, device_counts, rows_per_device: int = 16,
                    row_len: int = 1024, iters: int = 4,
                    rng_seed: int = 0, repeats: int = 3) -> ScalingReport:
    """Measure distributed-encode throughput at each mesh size.

    The per-device workload is constant (weak scaling): ``rows_per_device``
    documents of ``row_len`` bytes per device.  Each point is sampled
    ``repeats`` times and reported as mean with min/max spread.  Its
    bytes and tokens are the step's all-reduced ``total_bytes`` and
    ``total_tokens`` (the JAX package reads the two counters after them,
    ``total_tokens`` and ``overflow_rows``, in their place).
    """
    import random

    from ..ops.packed import host_route

    rng = random.Random(rng_seed)
    words = _words(rng)
    report = ScalingReport()
    for n in device_counts:
        mesh = make_dp_mesh(n, device=tokenizer._device)
        rows = rows_per_device * n
        # every rank draws the docs, so the generator stays in step
        buf, lengths = _buffer(_docs(rng, words, rows, row_len), rows,
                               row_len)
        if mesh.member:
            enc = DistributedEncoder(tokenizer, mesh=mesh, rows=rows,
                                     row_len=row_len)
            route = host_route(buf)   # routed, like production
            out = enc.encode_step(buf, lengths, route=route)
            total_bytes = _sync(out[6])  # warmup
            samples = []
            total_tokens = 0
            for _ in range(max(1, repeats)):
                t0 = time.time()
                for _ in range(iters):
                    out = enc.encode_step(buf, lengths, route=route)
                total_tokens = _sync(out[7])
                dt = (time.time() - t0) / iters
                samples.append(total_bytes / dt)
            report.points.append(ScalingPoint(
                n_devices=n,
                bytes_per_sec=float(np.mean(samples)),
                total_bytes=total_bytes,
                total_tokens=total_tokens,
                samples=samples,
            ))
        _barrier()
    return report
