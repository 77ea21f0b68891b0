"""PyTorch port: the data-parallel layer (parallel/) and the timing meters.

``DistributedEncoder`` as a world of one equals the JAX package's on a
1-device mesh; with 2 gloo ranks (spawned processes, CPU) it equals the
JAX package's on a 2-device virtual CPU mesh shard for shard;
``CorpusEncoder`` writes the JAX package's JSONL byte for byte.

The spawned ranks import this module by name, so it imports neither jax
nor the JAX package at the top: the JAX side is imported inside the
tests, and each rank checks that its process holds neither.  Shapes and
capacities repeat from test to test so that the JAX package compiles few
programs.
"""

import datetime
import json
import os
import pickle
import random
import string
import sys
import time

import numpy as np
import pytest
import torch

import tekken_tpu_torch as tt
from tekken_tpu_torch.parallel.corpus import CorpusEncoder, find_shards
from tekken_tpu_torch.parallel.encode import DistributedEncoder
from tekken_tpu_torch.parallel.mesh import dp_sharded, make_dp_mesh
from tekken_tpu_torch.utils.timing import Meter, StageTimer

R = 256


def _word(rng, lo, hi):
    return "".join(rng.choice(string.ascii_lowercase)
                   for _ in range(rng.randint(lo, hi)))


def _route1(rng, n, n_qx):
    """Single-spaced lowercase prose (route 1) with misses of every length
    class, after ``n_qx`` rows of 85 2-3-byte misses each: they overflow
    a capacity below 85 * n_qx."""
    docs = ["qx " * 85] * n_qx
    docs += [" ".join(_word(rng, 9, 14) if rng.random() < 0.1
                      else _word(rng, 1, 8) for _ in range(40))[:R]
             for _ in range(n - n_qx)]
    return docs


def _route2(rng, n):
    return [(" ".join(_word(rng, 1, 8) for _ in range(20)) + "  x 123456")[:R]
            for _ in range(n - 2)] + ["tabs\t\tand\n\nlines", "   "]


def _pack(texts, B):
    buf = np.zeros((B, R), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, t in enumerate(texts):
        d = t.encode("utf-8")
        buf[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return buf, lens


def _mixed(rng):
    """8 route-1 docs (4 overflowing a 256-span capacity) and 8 route-2
    docs, interleaved."""
    a, b = _route1(rng, 8, 4), _route2(rng, 8)
    return [x for pair in zip(a, b) for x in pair]


def _np(step):
    """encode_step's outputs as numpy / ints."""
    return [x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in step]


def _same_shard(got, want, s, n):
    """Port rank s's encode_step outputs against the JAX step's shard s
    (its global arrays are the shards' concatenation)."""
    for k in (0, 2, 3, 5):          # tok, fb_start, fb_len, row_bad
        w = np.asarray(want[k])
        per = w.shape[0] // n
        assert np.array_equal(got[k], w[s * per:(s + 1) * per]), k
    for k in (1, 4):                # n_out, overflow: one per shard
        assert int(got[k]) == int(np.asarray(want[k])[s]), k
    for k in (6, 7, 8):             # the all-reduced counters
        assert int(got[k]) == int(want[k]), k


@pytest.fixture(scope="module")
def toks(merged_tokenizer):
    md = tt.ModelData.from_json(merged_tokenizer.to_model_data().to_json())
    return merged_tokenizer, tt.Tekkenizer.from_model_data(md, device="cpu")


def _jax_encoder(tok, n, **kw):
    from tekken_tpu.parallel.encode import DistributedEncoder as JEncoder
    from tekken_tpu.parallel.mesh import make_dp_mesh as jmesh

    return JEncoder(tok, mesh=jmesh(n), row_len=R, **kw)


@pytest.mark.parametrize("merge", ["device", "host"])
def test_world1_matches_jax(toks, merge):
    """World of one (no process group) against a 1-device mesh: steps on
    routes 1 and None (overflowing), and a mixed batch of two 8-row route
    groups, equal output for output and doc for doc."""
    tok, port = toks
    rng = random.Random(3)
    penc = DistributedEncoder(port, mesh=make_dp_mesh(device="cpu"),
                              rows=16, row_len=R, np_cap=256, merge=merge)
    jenc = _jax_encoder(tok, 1, rows=16, np_cap=256, merge=merge)
    assert penc.mesh.size == 1 and penc.mesh.group is None
    for route in (1, None):
        buf, lens = _pack(_route1(rng, 8, 4), 8)
        got = _np(penc.encode_step(buf, lens, route=route))
        _same_shard(got, jenc.encode_step(buf, lens, route=route), 0, 1)
        # 255 misses fit in rows 0-2; row 3's spill over
        assert got[4] == 1 and got[5][3] == 1 and not got[5][:3].any()

    from tekken_tpu.oracle import encode_ranks

    texts = _mixed(rng)
    got = penc.encode_batch(texts)
    assert got == jenc.encode_batch(texts)
    assert penc.last_overflow_rows == jenc.last_overflow_rows > 0
    assert got[0] == [encode_ranks(t, tok.ranks) for t in texts]


def test_refusals(toks):
    _, port = toks
    mesh = make_dp_mesh(device="cpu")
    with pytest.raises(ValueError, match="merge must be"):
        DistributedEncoder(port, mesh=mesh, rows=8, row_len=R, merge="x")
    enc = DistributedEncoder(port, mesh=mesh, rows=8, row_len=R)
    with pytest.raises(ValueError, match="exceed 8 rows"):
        enc.encode_batch(["a"] * 9)
    with pytest.raises(ValueError, match="exceeds row"):
        enc.encode_batch(["a" * (R + 1)])
    with pytest.raises(ValueError, match="process group"):
        make_dp_mesh(2, device="cpu")
    assert dp_sharded(mesh, np.arange(6).reshape(3, 2)).shape == (3, 2)


# --------------------------------------------------------------------- #
# two gloo ranks
# --------------------------------------------------------------------- #

def _rank_main(rank, tmp, world):
    """One spawned rank: encode as the test asks, save what it got."""
    assert "jax" not in sys.modules and "tekken_tpu" not in sys.modules
    import torch.distributed as dist

    from tekken_tpu_torch.parallel.scaling import (measure_dp_overhead,
                                                   measure_scaling)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        port = tt.Tekkenizer.from_file(os.path.join(tmp, "tekken.json"),
                                       device="cpu")
        mesh = make_dp_mesh(device="cpu")
        assert (mesh.rank, mesh.size) == (rank, world)
        buf, lens, texts = _spawn_inputs()
        out = {}
        for merge in ("device", "host"):
            enc = DistributedEncoder(port, mesh=mesh, rows=8, row_len=R,
                                     merge=merge)
            step = _np(enc.encode_step(buf, lens, route=1))
            docs, n_bytes, n_tokens = enc.encode_batch(texts)
            out[merge] = (step, docs, n_bytes, n_tokens,
                          enc.last_overflow_rows)
            # the spans merge in the native engine, in both modes
            out[merge + "_merge_fn"] = enc._merge_fn.__qualname__
        out["scaling"] = measure_scaling(port, [1, 2], rows_per_device=4,
                                         row_len=R, iters=2).summary()
        out["overhead"] = measure_dp_overhead(port, [1, 2], rows=8,
                                              row_len=R, iters=1, repeats=2)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn_inputs():
    """A 4-row route-1 step (2 rows a rank; rank 0's overflow the shard
    capacity of 128) and an 8-doc batch of a 4-doc route-1 group and a
    4-doc route-2 group (4-row steps): one shape."""
    rng = random.Random(11)
    texts = _route1(rng, 4, 2)
    buf, lens = _pack(texts, 4)
    batch = [x for pair in zip(texts, _route2(rng, 4)) for x in pair]
    return buf, lens, batch


def test_two_gloo_ranks_match_jax(toks, tmp_path):
    """2 spawned gloo ranks against the JAX encoder on a 2-device mesh, in
    both merge modes: each rank's step equals the JAX step's shard, and
    every rank's docs, bytes, tokens and overflow rows equal the JAX
    batch's.  The scaling sweeps run at [1, 2]."""
    import torch.multiprocessing as mp

    tok, port = toks
    port.save(tmp_path / "tekken.json")
    ctx = mp.start_processes(_rank_main, args=(str(tmp_path), 2), nprocs=2,
                             join=False, start_method="spawn")
    # the JAX side while the ranks run
    buf, lens, texts = _spawn_inputs()
    jax_out = {}
    for merge in ("device", "host"):
        jenc = _jax_encoder(tok, 2, rows=8, merge=merge)
        jax_out[merge] = (jenc.encode_step(buf, lens, route=1),
                          jenc.encode_batch(texts), jenc.last_overflow_rows)
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

    for merge in ("device", "host"):
        want, jdocs, jovf = jax_out[merge]
        for s, out in enumerate(outs):
            step, docs, n_bytes, n_tokens, ovf = out[merge]
            _same_shard(step, want, s, 2)
            assert (docs, n_bytes, n_tokens) == jdocs
            assert ovf == jovf > 0
            assert out[merge + "_merge_fn"] == "NativeEncoder.merge_spans"
        assert outs[0][merge][0][4] == 1          # rank 0's rows overflow

    scaling = outs[0]["scaling"]
    assert [p["devices"] for p in scaling["points"]] == [1, 2]
    assert all(p["bytes_per_sec"] > 0 for p in scaling["points"])
    over = outs[0]["overhead"]
    assert [p["devices"] for p in over["points"]] == [1, 2]
    assert over["points"][0]["overhead_ratio_vs_single"] == 1.0
    assert over["total_bytes"] > 0
    # rank 1 is outside the 1-rank subgroup: it measured only n = 2
    assert [p["devices"] for p in outs[1]["scaling"]["points"]] == [2]


# --------------------------------------------------------------------- #
# corpus
# --------------------------------------------------------------------- #

def _corpus(tmp_path):
    """4 shard files of route-1 docs: short ones, 3-5-row ones (piece-safe
    segments across batch edges) and one 2000-byte piece (host merged)."""
    rng = random.Random(17)
    words = [_word(rng, 2, 9) for _ in range(300)]
    docs = [f"document {i}: it's sample text {i * 7}" for i in range(21)]
    docs += [" ".join(rng.choice(words) for _ in range(rng.randint(130, 220)))
             for _ in range(4)]
    docs.append("x" * 2000)
    rng.shuffle(docs)
    root = tmp_path / "corpus"
    root.mkdir()
    for k in range(4):
        (root / f"shard{k}.txt").write_text(
            "\n".join(docs[k::4]) + "\n", encoding="utf-8")
    return find_shards(str(root)), docs


def test_corpus_jsonl_matches_jax(toks, tmp_path):
    from tekken_tpu.parallel.corpus import CorpusEncoder as JCorpus
    from tekken_tpu.parallel.mesh import make_dp_mesh as jmesh

    tok, port = toks
    shards, docs = _corpus(tmp_path)
    got = CorpusEncoder(port, mesh=make_dp_mesh(device="cpu"), rows=8,
                        row_len=R).encode_files_to_jsonl(
                            shards, str(tmp_path / "port.jsonl"))
    want = JCorpus(tok, mesh=jmesh(1), rows=8, row_len=R).encode_files_to_jsonl(
        shards, str(tmp_path / "jax.jsonl"))
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "jax.jsonl").read_bytes()
    timed = ("seconds", "bytes_per_sec", "tokens_per_sec")
    assert {k: v for k, v in got.items() if k not in timed} == \
        {k: v for k, v in want.items() if k not in timed}
    assert got["oversized_documents"] == 5
    lines = (tmp_path / "port.jsonl").read_text().splitlines()
    assert len(lines) == got["documents"] == 26
    shard_docs = [d for s in shards for d in open(s).read().splitlines()]
    for line, d in zip(lines, shard_docs):
        assert json.loads(line) == tok.encode(d, False, False)


def test_piece_safe_segments_match_jax(merged_tokenizer):
    """The oversize-doc splitter's segments (ops.packed.piece_safe_segments,
    which CorpusEncoder and Tekkenizer.encode_batch share) equal the JAX
    package's on
    tests/test_corpus_chunking.py's cases, whitespace-heavy ones included,
    and re-encode to the doc's exact ids."""
    from tekken_tpu.oracle import byte_pair_merge, encode_ranks
    from tekken_tpu.parallel.corpus import CorpusEncoder as JCorpus

    from tekken_tpu_torch.ops.packed import piece_safe_segments

    ranks = merged_tokenizer.ranks
    jenc = JCorpus.__new__(JCorpus)
    jenc._row_len = 64
    rng = random.Random(21)
    docs = [
        " ".join("word%d" % i for i in range(200)),
        ("ab  " * 100) + ("\x0c\r\x0c " * 40) + "end",
        "  " * 300,
        "z" * 500,
        "".join(rng.choice(" \t\n\r\x0bab12!?ü中ſ'") for _ in range(2000)),
    ]
    for doc in docs:
        segs = piece_safe_segments(doc, 64)
        assert segs == jenc._piece_safe_segments(doc)
        cat = []
        for kind, val in segs:
            if kind == "d":
                assert len(val.encode("utf-8")) <= 64
                cat.extend(encode_ranks(val, ranks))
            else:
                for p in ([val] if kind == "h" else val):
                    cat.extend(byte_pair_merge(p.encode("utf-8"), ranks))
        assert cat == encode_ranks(doc, ranks), doc[:50]


# --------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------- #

def test_meter_and_stage_timer():
    m = Meter()
    with m.measure(n_bytes=1000, n_tokens=100):
        time.sleep(0.01)
    assert (m.bytes_total, m.tokens_total) == (1000, 100)
    assert m.seconds >= 0.01 and m.bytes_per_sec > 0
    s = m.summary()
    assert s["bytes"] == 1000 and s["tokens"] == 100
    assert set(s) == {"bytes", "tokens", "seconds", "bytes_per_sec",
                      "tokens_per_sec"}
    t = StageTimer()
    with t.stage("a"):
        time.sleep(0.005)
    with t.stage("b"):
        pass
    rep = t.report()
    assert "a" in rep and "b" in rep and "total" in rep
    assert [n for n, _ in t.stages] == ["a", "b"]
