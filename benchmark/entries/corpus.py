"""Entry ``corpus``: ``Tekkenizer.encode_batch`` over batches of
documents, ids out as Python lists.

Set-up builds the vocabulary, the tokenizer and the traffic pool from the
seed and runs every pool batch once.  The window cycles through the pool.
With ``--trace 1`` the window is cut in three: half untraced, a quarter
under the profiler, a quarter with the program's stage clock
(``ops.packed.StageClock``, which synchronizes at every mark).  The
window makes at least one pass over the pool, so the check sees every
batch."""

from __future__ import annotations

import gc
import time

from ..core import vocab
from ..core.check import Keeper, judge
from ..core.context import Context, Laps, Window, cycle
from ..core.reference import Reference
from ..core.trace import profiled
from . import common

# answers of each call after the pool's first pass that the check reads
SAMPLED = 8
# launch-counter name -> the kernel's name in the trace
KERNELS = {"stage1_compact": "stage1_compact_kernel",
           "merge_rows": "merge_buckets_kernel"}


def span_targets():
    """The program's layers that the profiled stretch marks on the host."""
    import tekken_tpu_torch as tt
    from tekken_tpu_torch.ops import packed

    return [(tt.Tekkenizer, "encode_batch"),
            (packed.PackedEncoder, "pack"), (packed, "doc_routes"),
            (packed, "packed_encode"), (packed, "splice_host_merges"),
            (packed, "oracle_merge_fn")]


def described(ctx):
    """The docs whose merge work the run's traffic line describes."""
    return ctx.pool[0]


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", program=common.tokenizer):
    """(Context, checks, attempted, failed, peak bytes).  ``program(cfg,
    token_bytes, device)`` makes what the window drives: the port's
    Tekkenizer, or a control in its place."""
    from tekken_tpu_torch.ops.packed import StageClock

    cfg, mix = cell.config, cell.mix
    lap = Laps(t_start)
    lap("imports")
    words, token_bytes = vocab.build(cfg, seed)
    ref = Reference(token_bytes, cfg["default_num_special_tokens"])
    lap("vocabulary")
    common.build_kernels(device)
    lap("kernels")
    tok = program(cfg, token_bytes, device)
    lap("tokenizer")
    tok.device_tables()
    lap("tables")
    pool = cell.generator.pool(mix, words, ref.ranks.__contains__, seed,
                               cfg["batch_docs"])
    nbytes = [sum(len(t.encode("utf-8")) for t in b) for b in pool]
    lap("traffic")
    bos, eos = cfg["add_bos"], cfg["add_eos"]
    keeper = Keeper(seed, "encode", SAMPLED)

    # warm-up: the pool's shapes, and enough calls that the host's
    # allocator reaches its steady state (the first calls of a process
    # run 15-25% slower)
    for _ in range(mix["warmup_passes"]):
        for b in range(len(pool)):
            tok.encode_batch(pool[b], bos, eos)
    common.sync(device)
    gc.collect()
    lap("warm-up")
    setup_s = time.perf_counter() - t_start
    common.note(f"[setup] {lap.laps}")

    win = Window()
    cur = [win]

    def step(b, clock=None):
        t = time.perf_counter()
        out = tok.encode_batch(pool[b], bos, eos, clock=clock)
        cur[0].add("encode", time.perf_counter() - t, nbytes[b])
        keeper.keep(b, out, len(pool[b]))

    ctx = Context(setup_s, win, cfg, mix, pool=pool)
    if not trace:
        win.seconds, _ = cycle(step, len(pool), seconds,
                               min_calls=len(pool), win=win)
    else:
        win.seconds, k = cycle(step, len(pool), seconds / 2,
                               min_calls=len(pool), win=win)
        nxt = [k]

        def traced():
            done = []
            cur[0] = Window()

            def pstep(b):
                step(b)
                done.append(b)
            with common.host_spans(span_targets()):
                _, nxt[0] = cycle(pstep, len(pool), seconds / 4, nxt[0])
            return done
        ctx.trace = profiled(traced, KERNELS, common.launches())

        def clocked(b):
            clock = StageClock()
            step(b, clock)
            ctx.stages.append(dict(clock.times))
        cur[0] = Window()
        cycle(clocked, len(pool), seconds / 4, nxt[0])
    peak = common.peak_bytes(device)
    del tok
    gc.collect()

    def expected(b, j):
        return ref.encode(pool[b][j], cfg["bos_id"] if bos else None,
                          cfg["eos_id"] if eos else None)
    compared, wrong = judge(keeper, expected)
    ctx.reference = ref
    common.note(f"[check] {compared} docs compared, {wrong} wrong")
    checks = {"answers_wrong": {"value": wrong, "limit": 0}}
    return ctx, checks, keeper.attempted, wrong, peak
