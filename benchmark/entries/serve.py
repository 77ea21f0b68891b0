"""Entry ``serve``: an LLM server's tokenizer worker.  A step encodes the
step's prompts (``Tekkenizer.encode_batch(prompts, add_bos, add_eos)``)
and decodes its finished completions (``Tekkenizer.decode_batch(
completions, policy)``), ids and texts out as Python lists.

Set-up builds the vocabulary, the tokenizer and the pool of steps from
the seed and runs every step ``warmup_passes`` times.  The window cycles
through the pool, at least once through it, so the check sees every
answer of the first pass.  With ``--trace 1`` the window is cut as in
``entries/corpus.py``: half untraced, a quarter under the profiler, a
quarter with the program's stage clock, of which each step keeps the
clock's times (``ctx.stages``: the stage marks and each span's self
time, as the corpus entry keeps them) and, under ``"spans"``, each
``tekken.*`` span name's whole duration."""

from __future__ import annotations

import gc
import inspect
import time

from ..core import vocab
from ..core.check import Keeper, judge
from ..core.context import Context, Laps, Window, cycle
from ..core.decode_reference import DecodeReference, special_strings
from ..core.reference import Reference
from ..core.trace import profiled
from . import common

# answers of each kind of each step after the pool's first pass that the
# check reads
SAMPLED = 8
# launch-counter name -> the kernel's name in the trace
KERNELS = {"stage1_compact": "stage1_compact_kernel",
           "merge_rows": "merge_buckets_kernel",
           "decode_store": "decode_store_kernel"}


def described(ctx):
    """The prompts whose merge work the run's traffic line describes."""
    return [p for s in ctx.pool[:4] for p in s["prompts"]]


def span_totals(clock) -> dict:
    """Seconds of each span name on ``clock``, whole durations."""
    out: dict = {}
    for r in clock.spans:
        out[r.name] = out.get(r.name, 0.0) + (r.end_ns - r.start_ns) * 1e-9
    return out


def check_program(program) -> None:
    """The cell reads the program's decode spans: a program whose
    ``decode_batch`` takes no clock cannot run it."""
    if program is common.tokenizer:
        import tekken_tpu_torch as tt

        if "clock" not in inspect.signature(
                tt.Tekkenizer.decode_batch).parameters:
            raise SystemExit("serve: this program's Tekkenizer.decode_batch "
                             "takes no clock; the cell needs its spans")


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", program=common.tokenizer):
    """(Context, checks, attempted, failed, peak bytes).  ``program(cfg,
    token_bytes, device)`` makes what the window drives: the port's
    Tekkenizer, or a control in its place."""
    from tekken_tpu_torch import SpecialTokenPolicy
    from tekken_tpu_torch.utils.timing import StageClock

    check_program(program)
    cfg, mix = cell.config, cell.mix
    ns = cfg["default_num_special_tokens"]
    lap = Laps(t_start)
    lap("imports")
    words, token_bytes = vocab.build(cfg, seed)
    ref = Reference(token_bytes, ns)
    dref = DecodeReference(token_bytes, special_strings(ns))
    lap("vocabulary")
    common.build_kernels(device)
    lap("kernels")
    tok = program(cfg, token_bytes, device)
    lap("tokenizer")
    tok.device_tables()
    lap("tables")
    pool = cell.generator.pool(mix, words, ref, seed, cfg)
    prompts = [s["prompts"] for s in pool]
    completions = [s["completions"] for s in pool]
    nbytes = [sum(len(t.encode("utf-8")) for t in b) for b in prompts]
    lap("traffic")
    bos, eos = cfg["add_bos"], cfg["add_eos"]
    policy = SpecialTokenPolicy[cfg["decode_policy"]]
    kept = {"prompts": Keeper(seed, "prompt", SAMPLED),
            "completions": Keeper(seed, "completion", SAMPLED)}

    for _ in range(mix["warmup_passes"]):
        for b in range(len(pool)):
            tok.encode_batch(prompts[b], bos, eos)
            tok.decode_batch(completions[b], policy)
    common.sync(device)
    gc.collect()
    lap("warm-up")
    setup_s = time.perf_counter() - t_start
    common.note(f"[setup] {lap.laps}")

    win = Window()
    cur = [win]

    def step(b, clock=None):
        t0 = time.perf_counter()
        ids = tok.encode_batch(prompts[b], bos, eos, clock=clock)
        t1 = time.perf_counter()
        texts = tok.decode_batch(completions[b], policy, clock=clock)
        t2 = time.perf_counter()
        cur[0].add("encode", t1 - t0, nbytes[b])
        cur[0].add("decode", t2 - t1)
        kept["prompts"].keep(b, ids, len(prompts[b]))
        kept["completions"].keep(b, texts, len(completions[b]))

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
            _, nxt[0] = cycle(pstep, len(pool), seconds / 4, nxt[0])
            return done
        ctx.trace = profiled(traced, KERNELS, common.launches())

        def clocked(b):
            clock = StageClock()
            step(b, clock)
            ctx.stages.append(dict(clock.times, spans=span_totals(clock)))
        cur[0] = Window()
        cycle(clocked, len(pool), seconds / 4, nxt[0])
    peak = common.peak_bytes(device)
    del tok
    gc.collect()

    expected = {
        "prompts": lambda b, j: ref.encode(
            prompts[b][j], cfg["bos_id"] if bos else None,
            cfg["eos_id"] if eos else None),
        "completions": lambda b, j: dref.decode(completions[b][j],
                                                cfg["decode_policy"])}
    wrong = {}
    for kind, keeper in kept.items():
        compared, wrong[kind] = judge(keeper, expected[kind])
        common.note(f"[check] {kind}: {compared} compared, {wrong[kind]} "
                    f"wrong")
    ctx.reference = ref
    ctx.memo["wrong"] = wrong
    n_wrong = sum(wrong.values())
    checks = {"answers_wrong": {"value": n_wrong, "limit": 0}}
    attempted = sum(k.attempted for k in kept.values())
    return ctx, checks, attempted, n_wrong, peak
