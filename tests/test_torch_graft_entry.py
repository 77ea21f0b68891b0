"""PyTorch port: ``graft_entry`` (the counterpart of ``__graft_entry__.py``)
and the bench builders of ``models/bench.py``.

``entry()``'s step equals the JAX package's jitted step output for
output; ``dryrun_multichip`` passes over two gloo ranks in spawned
processes, each building the 130,872-rank bench vocabulary.  The spawned
ranks import this module by name, so it imports neither jax nor the JAX
package at the top (each rank checks that its process holds neither).
"""

import datetime
import hashlib
import io
import os
import pickle
import random
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from tekken_tpu_torch import graft_entry
from tekken_tpu_torch.models import bench_words, build_bench_vocab, build_corpus


def test_entry_step_matches_jax():
    """The unrouted packed step on the toy tokenizer at (8, 128): every
    output equals the JAX package's jitted step's."""
    import jax

    import __graft_entry__ as jax_entry

    jfn, jargs = jax_entry.entry()
    want = [np.asarray(x) for x in jax.jit(jfn)(*jargs)]
    fn, args = graft_entry.entry(device="cpu")
    assert args[0].shape == (8, 128) and args[0].device.type == "cpu"
    assert np.array_equal(args[0].numpy(), np.asarray(jargs[0]))
    got = fn(*args)
    assert int(got[1]) == int(want[1]) > 0
    for k in (0, 2, 3, 5):          # tok, fb_start, fb_len, row_bad
        assert np.array_equal(got[k].cpu().numpy(), want[k]), k
    assert int(got[4]) == int(want[4])


def test_main_runs_entry_without_a_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    out = io.StringIO()
    with redirect_stdout(out):
        assert graft_entry.main(["--device", "cpu"]) == 0
    assert out.getvalue().startswith("entry(): ran on cpu, n_out = ")


def test_dryrun_refuses_another_world_size():
    with pytest.raises(ValueError, match=r"dryrun_multichip\(2\) in a "
                                         r"process group of 1 ranks"):
        graft_entry.dryrun_multichip(2, device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        graft_entry.entry()


def test_bench_builders_match_bench_py():
    """models/bench.py's word list, vocabulary and corpus are bench.py's:
    the same 130,872 tokens (by a hash of their sorted bytes) and the same
    docs from the same seed."""
    import bench

    words = bench_words()
    rng = random.Random(1234)
    assert words == ["".join(rng.choice("abcdefghijklmnopqrstuvwxyz")
                             for _ in range(rng.randint(2, 11)))
                     for _ in range(40_000)]

    def digest(vocab):
        h = hashlib.sha256()
        for t in sorted(v.token_bytes for v in vocab):
            h.update(t.encode() + b"\n")
        return len(vocab), h.hexdigest(), [v.rank for v in vocab]

    assert digest(build_bench_vocab(words)) == digest(
        bench.build_bench_vocab(words))
    assert build_corpus(words, random.Random(5), 6, 300) == \
        bench.build_corpus(words, random.Random(5), 6, 300)


def _rank_main(rank, tmp, world):
    """One spawned gloo rank: the dryrun over the group, saved."""
    assert "jax" not in sys.modules and "tekken_tpu" not in sys.modules
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = graft_entry.dryrun_multichip(world, device="cpu")
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip_two_gloo_ranks(tmp_path):
    """2 spawned gloo ranks: every doc and both counters equal the oracle
    on each rank (checked inside the dryrun), and both ranks report the
    same counts."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=(str(tmp_path), 2), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the spawned ranks did not finish in 240 s")
    outs = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    assert outs[0] == outs[1]
    assert outs[0]["docs"] == 4 and outs[0]["ranks"] == 130_872
    assert outs[0]["tokens"] > 0 and outs[0]["bytes"] > 4 * 24
