"""The port's tools, run as modules: the counterparts of the repo's
``tools/`` scripts that hold the engines to the oracle, and of
``bench.py`` and the ``tools/`` scripts that measure the encode.

    python -m tekken_tpu_torch.tools.validate_model tekken.json [--device cpu]
    python -m tekken_tpu_torch.tools.soak [seconds] [--seed S] [--device cpu]
    python -m tekken_tpu_torch.tools.fuzz_all_engines [n_batches] [--device cpu]
    python -m tekken_tpu_torch.tools.fuzz_pretokenize [--smoke] [--device cpu]
    torchrun --nproc_per_node=N -m tekken_tpu_torch.tools.multichip_scale
    python -m tekken_tpu_torch.tools.profile_loading [tekken.json] [--device cpu]
    python -m tekken_tpu_torch.tools.bench [--rows 4096] ... [--device cpu]
    python -m tekken_tpu_torch.tools.profile_packed_stages [--device-route] [--device cpu]
    python -m tekken_tpu_torch.tools.bench_batchscale [--sizes 128,512,1024] [--device cpu]
    python -m tekken_tpu_torch.tools.bench_ab [--device cpu]
    python -m tekken_tpu_torch.tools.analyze_bench_load

Each runs on the card by default (``cuda``, ``cuda:LOCAL_RANK`` under
``torchrun``); ``--device cpu`` runs the kernels' plain versions, and the
measuring tools then print no rate.  A mismatch prints the vocabulary's
merge count, the seed, the doc and each engine's first differing index,
and the run exits 1.
"""

from __future__ import annotations

import os
import subprocess

import torch


def first_difference(got, want):
    """The first index at which the sequences ``got`` and ``want`` differ
    (the shorter one's length when one is a prefix of the other), or None
    when they are equal."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))


def mismatch_line(n_merges: int, seed: int, doc: str, diffs: dict) -> str:
    """One line for a doc that some engine got wrong: ``diffs`` maps each
    engine to its first differing index (None where it agrees)."""
    where = ", ".join(f"{name} {'-' if i is None else i}"
                      for name, i in diffs.items())
    return (f"MISMATCH merges={n_merges} seed={seed} doc={doc!r} "
            f"first differing index: {where}")


def card(device) -> str:
    """``nvidia-smi``'s name and power limit of ``device``'s card (as
    ``--query-gpu=name,power.limit --format=csv,noheader`` prints them), or
    the device's name off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible:
        index = visible.split(",")[index]
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
