"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels
from this checkout, holds each against its plain PyTorch version, drives
Tekkenizer.encode_batch, the unrouted flat encode,
Tekkenizer.decode_batch, the data-parallel and corpus encoders and the
audio ops at the full width of Tekken V7, and checks the results against
the oracle and float64 references.

    python3 chip_smoke.py

Phases:
1. the card's name and power limit; path E's host resampler references
   start in two spawned processes (they end before phase 4, so the timed
   paths have the host to themselves); nvcc builds of the four kernels, in
   parallel, beside the g++ build of the native engine (timed), and a
   check that ptxas gives the merge kernel's 4- and 8-lane instantiations
   no stack frame;
2. the full-width configuration: 130,872 inner ranks + 1,000 specials
   from prefix chains over 40,000 random words
   (``tekken_tpu_torch.models.bench``, copies of bench.py's builders;
   checked by its rank count and a hash of its sorted token bytes), its
   device tables, and the flat engine's tables (pair table, piece table,
   padded token rows), each build timed;
3. each kernel against its plain version, bit for bit, on the card:
   stage 1 with rules simple / general / external at (1024, 2048) and a
   long-row case at R = 2^16; the merge's matrix entry at P = 4, 8, 32
   and 64, fixed and looped;
   the fused stage 1 for n_words 0, 3 and 6 at (1024, 2048) and on rows
   of 2^16 (one that is one piece, empty ones, lengths no multiple of the
   tile); the decode store at T = 65,536 for 65,536, 65,535, 1 and 0
   tokens of random ranks over the whole vocabulary, over all out_cap
   bytes;
4. the main path: encode_batch on a route-1 batch (4096 x 2048, the
   bench shape, with out-of-vocabulary words so the P=4 and P=8 merge
   buckets and the host splice run), a route-2 and a route-3 batch
   (1024 x 2048 each) and a mixed batch with 1% non-ASCII docs.  The
   launch counts are zeroed just before and read just after; a sample
   of 64 docs per batch is held against the oracle; throughput, the
   device time and a per-stage breakdown (each stage the median of 5
   clocked calls) are printed;
   path B, the unrouted flat encode (PackedEncoder._encode_buffer with
   route None) on the route-1 batch (the simple branch: the fused stage 1)
   and the route-2 and route-3 batches (the general and UTF-8 branches),
   64 docs per batch held against the oracle and every doc against the
   routed result; path A, decode_batch over the route-1 batch's token
   lists with BOS/EOS (~1.6 M tokens, ~25 chunks of 2^16): every doc
   round-trips to its text and 64 docs equal the host decode under KEEP
   and IGNORE.  Each path zeroes the launch counts just before it and
   reads them just after, and each encode call's merge buckets must take
   one launch; MB/s is the median of 5 calls after a warm-up;
   path C, parallel.DistributedEncoder (4096 x 2048) on an NCCL process
   group of one rank on cuda:0: encode_batch on the route-1 and mixed
   batches, every doc held against encode_batch's and 64 against the
   oracle, and the unrouted encode_step on the route-1 batch held against
   path B;
   path D, parallel.CorpusEncoder (1024 x 2048) writing JSONL from 4 shard
   files of the route-1 docs and 8 docs of 3-5 rows (piece-safe
   segments), the oversize docs and 64 lines held against
   Tekkenizer.encode, and its stats; path E, audio at V7's constants:
   the log and linear mel spectrograms of 32 clips of 30 s against a
   float64 numpy reference (log-mel atol 1e-4; power rtol 1e-4 plus 1e-6
   of the clip's peak), resample_poly_batched of 16 clips of 10 s from
   44.1 to 16 kHz against resample_poly_host on the first 2 s of two of
   them (atol 2e-4), and encode_audio_batch of 32 clips, 16 of them at
   44.1 kHz; path F, the native engine: NativeEncoder.encode and
   encode_batch against the oracle on 64 docs of each batch and
   encode_batch of the route-1 batch against the card's (timed);
   PackedEncoder(merge="host") on the route-1 batch (no merge launch)
   with merge_spans held against the oracle's merge on every span, its
   stages and rate beside one clocked call with the oracle's merge;
   DistributedEncoder(merge="host") on the route-1 batch; a ~3 MiB doc
   through encode_batch on the card against NativeEncoder.encode; the
   card's decode bytes of the route-1 rank stream against decode_ranks,
   both timed; ``python -m tekken_tpu_torch`` (``__main__.main``) on the
   bench model saved to a file: encode-file with the device and native
   engines over 512 lines, info and validate; the flagship step of
   ``graft_entry.entry()`` (the unrouted packed encode on the synthetic
   tokenizer of 200 merges, at (8, 128)) on the card against the oracle;
   path G, the differential engines, none of which may launch a kernel:
   ``FlatEncoder`` (64 x 1024) on 64 docs of each of route1_bench,
   route2 and route3 clipped to 1,024 bytes, every doc against the oracle
   and encode_batch, launch counts zeroed before and read after (all 0),
   its merge rounds and median time; ``probe_pairs`` on 100,000 pairs
   against a numpy probe of the pair table; ``merge_bucket_fn(16)`` on
   ~1,000 out-of-vocabulary pieces against ``byte_pair_merge``;
   ``pretokenize_vec`` on the first 256 bytes of 500 docs against
   ``oracle.pretokenize``; ``byte_boundaries_via_chars`` on the route-3
   batch against ``byte_boundaries``; ``graft_entry.dryrun_multichip(1)``
   in an NCCL group of one;
   phase H, the verification tools (``tekken_tpu_torch.tools``) with the
   launch counts zeroed once before and read once after, each of the four
   kernels launched at least once: a fixed-count soak (synthetic
   vocabularies of 0, 50, 200 and 1,200 merges asked, 4 batches of up to
   16 docs of the soak's alphabets each, PackedEncoder 16 x 4096, seed
   20260817) against the native engine and the oracle, with the card's
   decode_batch (RAISE) and the unrouted flat encode of the same docs,
   and the routed and flat encode of 16 joined docs past the 2,048-lane
   tile and of 16 simple-ASCII docs of ~4 KB; ``fuzz_all_engines`` for 5
   batches; ``tests/golden/synthetic_v1.json`` through the oracle, the
   native engine, encode_batch, PackedEncoder, FlatEncoder and decode on
   cuda:0; ``validate_model`` on the bench model saved to a file.  Any
   mismatch fails it;
   phase I, the benchmark tools (``tekken_tpu_torch.tools.bench``,
   ``bench_ab``, ``bench_batchscale``) on the bench tokenizer built in
   phase 2, with the launch counts zeroed once before and read once
   after, each of the four kernels launched at least once:
   ``bench.run`` at 1,024 rows (reps 4, iters 2, decode reps 4, decode
   iters 2: every parity check of the bench, and a rate for every key of
   its line), one sample of ``bench_ab`` (routed against flat, 128 rows)
   and of ``bench_batchscale`` at 128 and 1,024 rows;
5. the kernels at the paths' own inputs: time, plain time, bound, and one
   JSON line ``{"kernels": [...]}`` for all four.  stage1_compact is timed
   at each of its launches on the routed encode path (one ``[kernel]``
   line each); its ``ms``, ``plain_ms`` and ``bound_ms`` in the JSON line
   are the sums over those launches.  The bucket merge is held against
   ``merge_buckets_reference`` and timed at every launch of both encode
   paths (one line each, with its device time from a profiler trace); its
   JSON numbers are the means a launch.  The decode store's ``ms`` is a
   call through ``decode_bytes_compact``; its line also gives the launch
   alone and the kernel's device time from a profiler trace;
6. the last line: ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  Without a GPU the script exits
non-zero before printing anything.
"""

import contextlib
import hashlib
import json
import os
import random
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
             "False); this script runs only on a GPU")

import tekken_tpu_torch as tt  # noqa: E402
from tekken_tpu_torch import _build, graft_entry  # noqa: E402
from tekken_tpu_torch.models import (  # noqa: E402
    bench_words, build_bench_vocab, build_corpus, build_synthetic_model_data)
from tekken_tpu_torch.native import build as native_build  # noqa: E402
from tekken_tpu_torch.oracle import encode_ranks  # noqa: E402
from tekken_tpu_torch.ops import decode as decode_mod  # noqa: E402
from tekken_tpu_torch.ops import flat as flat_mod  # noqa: E402
from tekken_tpu_torch.ops import packed as packed_mod  # noqa: E402
from tekken_tpu_torch.ops.bpe import INF, merge_rows_compact  # noqa: E402
from tekken_tpu_torch.ops.decode import (  # noqa: E402
    DeviceDecoder, decode_bytes_compact, decode_bytes_compact_reference)
from tekken_tpu_torch.ops.merge import (  # noqa: E402
    merge_buckets, merge_buckets_reference, merge_rows_compact_fused)
from tekken_tpu_torch.ops.pretokenize import byte_boundaries  # noqa: E402
from tekken_tpu_torch.ops.stage1 import (  # noqa: E402
    stage1_compact, stage1_compact_reference, stage1_fused,
    stage1_fused_reference)
from tekken_tpu_torch.special_tokens import (  # noqa: E402
    SpecialTokenInfo, SpecialTokenPolicy, get_deprecated_special_tokens)

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
N_SPECIAL = 1000
# the configuration's scale: bench.py's shape (B_MAIN x ROW bytes) and
# vocabulary (its count and the sha256 of its sorted token bytes, each
# prefixed by its 2-byte little-endian length, as bench.py's builders give
# them); the route-2/3 batches and the parity cases take B_SIDE rows
INNER_VOCAB = 130_872
VOCAB_SHA256 = ("798fb96e14e120f9c1f9b8cfd0ee4ad8"
                "f5308a9ea822df9b91f99a664f56caf3")
B_MAIN, B_SIDE, ROW, LONG_ROW = 4096, 1024, 2048, 1 << 16
# path D's corpus batch; path E's clips: 32 of 30 s for the mel
# spectrogram, 16 of 10 s at 44.1 kHz for the resampler
B_CORPUS = 1024
SAMPLE_RATE, N_MEL_CLIPS, MEL_SECONDS = 16_000, 32, 30
N_RES_CLIPS, RES_SECONDS, RES_RATE = 16, 10, 44_100
# the host resampler's references: the first REF_SECONDS of clips 0-1; the
# batched output agrees with them up to REF_MARGIN output samples before
# their end (the filter reaches 32 output samples across)
REF_SECONDS, REF_MARGIN = 2, 64
# path G's time aim, seconds (its tables are built in phase 2); phase H's,
# and the synthetic vocabularies of its soak (merges asked: TRAIN_TEXTS
# train at most 185, so 200 and 1,200 give one vocabulary)
PATH_G_AIM_S = 15
PATH_H_AIM_S = 20
PATH_I_AIM_S = 25
H_MERGES = (0, 50, 200, 1200)

KERNELS = {
    "stage1_compact": ("tekken_tpu_torch/csrc/stage1_compact.cu",
                       "tekken_tpu/ops/pallas_stage1.py:152"),
    "merge_rows": ("tekken_tpu_torch/csrc/merge_rows.cu",
                   "tekken_tpu/ops/pallas_merge.py:52"),
    "stage1_fused": ("tekken_tpu_torch/csrc/stage1_fused.cu",
                     "tekken_tpu/ops/pallas_stage1.py:77"),
    "decode_store": ("tekken_tpu_torch/csrc/decode_store.cu",
                     "tekken_tpu/ops/decode.py:82"),
}
# the stages of the encode paths that run on the card (StageClock names)
DEVICE_STAGES = ("utf8_flags", "branch", "stage1", "probe_emit", "p23",
                 "merge")


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------- #
# main-path traffic
# --------------------------------------------------------------------- #

def oov_word(rng, ranks, lo, hi):
    """A lowercase word whose space-prefixed piece is not a vocab token."""
    while True:
        w = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz")
                    for _ in range(rng.randint(lo, hi)))
        if (" " + w).encode() not in ranks and w.encode() not in ranks:
            return w


def clip_bytes(doc, n):
    return doc.encode("utf-8")[:n].decode("utf-8", "ignore")


def pack_rows(texts, R):
    """(B, R) uint8 rows of the texts (each of at most R bytes) and their
    lengths, on the card."""
    buf, lens = packed_mod.pack_rows(texts, len(texts), R)
    return torch.from_numpy(buf).to(DEV), torch.from_numpy(lens).to(DEV)


def route1_batch(words, rng, ranks, B, R):
    """Bench corpus with ~2% of the words replaced by out-of-vocabulary
    words of 3-8 letters (4-9-byte misses: the P=4 and P=8 buckets) and
    ~0.2% by words of 9-14 letters (10-15-byte misses: the P=32 bucket)."""
    out = []
    for d in build_corpus(words, rng, B, R):
        ws = d.split(" ")
        for i in range(len(ws)):
            x = rng.random()
            if x < 0.02:
                ws[i] = oov_word(rng, ranks, 3, 8)
            elif x < 0.022:
                ws[i] = oov_word(rng, ranks, 9, 14)
        out.append(" ".join(ws)[:R])
    return out


def route2_batch(words, rng, B, R):
    out = []
    for d in build_corpus(words, rng, B, R - 64):
        ws = d.split(" ")
        for i in range(0, len(ws), 9):
            ws[i] += "  " if rng.random() < 0.5 else f" {rng.randint(1000, 9999999)}"
        out.append(" ".join(ws)[:R])
    return out


UTF8_WORDS = ["café", "naïve", "über", "中文", "日本語", "😀", "Ελληνικά",
              "Русский", "mañana", "한국어", "🚀🎉"]


def route3_batch(words, rng, B, R):
    out = []
    for d in build_corpus(words, rng, B, R):
        ws = d.split(" ")
        for i in range(len(ws)):
            if rng.random() < 0.1:
                ws[i] = rng.choice(UTF8_WORDS)
        out.append(clip_bytes(" ".join(ws), R))
    return out


def configuration():
    """The full-width configuration from seed 1234: (corpus words, the
    tokenizer on the card), with V7's audio constants (16 kHz, 12.5
    frames/s, 80 mels, hop 160, window 400) and its two audio specials."""
    words = bench_words()
    vocab = build_bench_vocab(words)
    specials = get_deprecated_special_tokens()
    specials += [SpecialTokenInfo(rank=len(specials) + k, token_str=s,
                                  is_control=True)
                 for k, s in enumerate(("[AUDIO]", "[BEGIN_AUDIO]"))]
    audio = tt.AudioConfig(SAMPLE_RATE, 12.5,
                           tt.AudioSpectrogramConfig(80, 160, 400))
    return words, tt.Tekkenizer(
        vocab=vocab, special_tokens=specials,
        pattern=".*", vocab_size=len(vocab) + N_SPECIAL,
        num_special_tokens=N_SPECIAL, version=tt.TokenizerVersion.V7,
        audio_config=audio, device="cuda")


def traffic(words, ranks):
    """The main path's batches from seed 99, by name."""
    rng = random.Random(99)
    batches = {
        "route1_bench": route1_batch(words, rng, ranks, B_MAIN, ROW),
        "route2": route2_batch(words, rng, B_SIDE, ROW),
        "route3": route3_batch(words, rng, B_SIDE, ROW),
    }
    mixed = route1_batch(words, rng, ranks, B_MAIN, ROW)
    n_utf8 = max(1, B_MAIN // 100)
    utf8 = route3_batch(words, rng, n_utf8, ROW)
    for k, i in enumerate(rng.sample(range(B_MAIN), n_utf8)):
        mixed[i] = utf8[k]
    batches["mixed_1pct_utf8"] = mixed
    return batches


# --------------------------------------------------------------------- #
# measurement helpers
# --------------------------------------------------------------------- #

def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls after one warm-up, by CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, kernel, reps=20, traces=3):
    """Mean device time per fn() call of the CUDA kernels whose name holds
    ``kernel``, from a torch.profiler trace of reps calls after a
    warm-up.  A trace that holds no such kernel is taken again, up to
    ``traces`` in all: torch.profiler has returned such a window without
    its device events on the H100, between traces that held them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for k in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
                 for e in prof.key_averages() if kernel in e.key)
        if us:
            return us / reps / 1e3
        log(f"[kernel] trace {k + 1} of {traces} held no {kernel} kernel")
    raise AssertionError(f"the profiler saw no {kernel} kernel in {traces} "
                         f"traces")


def max_abs_err(got, want):
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return err


def check_equal(name, got, want):
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max abs err {err})")
    return err


def stage1_bound_ms(byts, n_words, rules):
    B, R = byts.shape
    nw = max(n_words, 1)
    moved = B * R * (2 if rules == "external" else 1) + 4 * B   # in
    moved += (3 + nw) * B * R * 4 + 4 * B                        # out
    # ~64 integer operations per byte for the rules, scans and records
    ops = 64 * B * R
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def fused_bound_ms(byts, n_words):
    B, R = byts.shape
    moved = B * R + 4 * B                                         # in
    moved += (2 + n_words if n_words else 1) * B * R * 4          # out
    ops = 64 * B * R        # ~64 integer operations a byte: rules, hash
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def decode_bound_ms(n_tokens, total, out_cap):
    # what the function needs: each live token's id and its table length
    # read once, each output byte's int32 table lane read once, every
    # out_cap byte written once (the offsets are the wrapper's own
    # intermediate); a handful of operations a byte
    moved = 8 * n_tokens + 4 * total + out_cap
    ops = 8 * total
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def median_s(fn, reps=5, warm=True):
    """(median, min, max) host seconds of fn() over reps calls after one
    warm-up (``warm``), each ended by a synchronize."""
    if warm:
        fn()
        torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    walls.sort()
    return walls[len(walls) // 2], walls[0], walls[-1]


def clocked_stages(fn, reps=5):
    """Per-stage median ms over reps clocked calls fn(clock) (each stage
    mark synchronizes, so these calls are separate from the timed ones).
    The stage marks only: the clock's span self times (``tekken.*``)
    cover the same wall time again."""
    runs = []
    for _ in range(reps):
        clock = packed_mod.StageClock()
        fn(clock)
        runs.append(clock.times)
    return {k: sorted(r.get(k, 0.0) for r in runs)[reps // 2] * 1e3
            for k in runs[0] if not k.startswith("tekken.")}


def merge_bound_ms(tok, w, byte_rank, plen, tiers, tables, start=None):
    """Bound of one bucket merge call, from what this call's rows need:
    each tier row's 8-byte word; for each live row its geometry, its lane
    bytes (int64 ranks) and the first round's dense-table reads; two
    16-byte cuckoo rows a merge; each token written.  The merges and the
    tokens are counted by running each tier's plain version on its own."""
    N = byte_rank.shape[0]
    flat_plen = plen.reshape(-1)
    moved = ops = 0
    for lo, rows, P, fixed in tiers:
        wv = w[lo:lo + rows]
        jj = (wv >> 2).clamp(0, N - 1)
        keep = (wv & 3) == 1
        if start is not None:
            keep &= start.reshape(-1)[jj] >= 0
        L = torch.where(keep, flat_plen[jj].to(torch.int64), 0)
        lanes = L.clamp(max=P)
        mark = torch.full_like(tok, -7)
        merge_buckets_reference(mark, w, byte_rank, plen, [(lo, rows, P,
                                                           fixed)],
                                tables, start)
        written = int((mark[:N] >= 0).sum())
        merges = int(L.sum()) - written
        live = int(keep.sum())
        moved += (8 * rows + live * (8 if start is not None else 4)
                  + 8 * int(lanes.sum()) + 4 * int((lanes - 1).clamp(min=0)
                                                   .sum())
                  + 32 * merges + 4 * written)
        ops += merges * (4 * P + 40)  # argmin over P lanes, hashes, shifts
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def stack_frames(ptxas):
    """(entry function, stack frame bytes) from nvcc's ptxas -v lines."""
    out, fn = [], None
    for ln in ptxas.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "bytes stack frame" in ln and fn is not None:
            out.append((fn, int(ln.split("bytes stack frame")[0].split()[-1])))
            fn = None
    return out


class Capture:
    """Records the inputs the main path passes to a kernel wrapper and
    calls the real wrapper (the launch is counted there, once).  With
    ``clone_first`` it records a copy of the first argument, which the
    wrapper updates in place."""

    def __init__(self, module, name, clone_first=False):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.clone_first = clone_first
        self.calls = []

    def __enter__(self):
        def spy(*args, **kw):
            rec = ((args[0].clone(),) + args[1:] if self.clone_first
                   else args)
            self.calls.append((rec, kw))
            return self.real(*args, **kw)
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def one_launch_a_call(what, counts, merge_calls):
    """Every bucket merge call (one an encode call at most) is one
    launch."""
    if counts["merge_rows"] != len(merge_calls):
        raise AssertionError(f"{what}: {counts['merge_rows']} merge launches "
                             f"for {len(merge_calls)} bucket merge calls")


def mb_per_s(what, nbytes, fn):
    """Log and return the median-of-5 end-to-end rate of fn(), which the
    caller has just run once (the warm-up)."""
    e2e, lo_, hi_ = median_s(fn, warm=False)
    log(f"{what}: end to end median of 5 {e2e * 1e3:.1f} ms (min "
        f"{lo_ * 1e3:.1f}, max {hi_ * 1e3:.1f}) = {nbytes / e2e / 1e6:.2f} "
        f"MB/s")
    return {"e2e_s": e2e, "e2e_MB_per_s": nbytes / e2e / 1e6,
            "e2e_min_max_s": [lo_, hi_]}


# --------------------------------------------------------------------- #
# paths C-E: the data-parallel encode, the corpus stream, audio
# --------------------------------------------------------------------- #

@contextlib.contextmanager
def world_of_one():
    """An NCCL process group of one rank (a ``file://`` store in a
    temporary directory) and its data-parallel mesh on cuda:0."""
    import tempfile

    import torch.distributed as dist

    from tekken_tpu_torch.parallel.mesh import make_dp_mesh

    with tempfile.TemporaryDirectory() as pg_dir:
        dist.init_process_group("nccl", init_method=f"file://{pg_dir}/pg",
                                rank=0, world_size=1)
        try:
            mesh = make_dp_mesh()
            if (dist.get_backend(mesh.group) != "nccl" or mesh.size != 1
                    or mesh.device != torch.device("cuda", 0)):
                raise AssertionError(f"dp mesh {mesh}")
            yield mesh
        finally:
            dist.destroy_process_group()


def dp_encode(tok, mesh, merge, names, batches, routed_out, res):
    """DistributedEncoder(merge=...) encode_batch on the named batches:
    its launches, every doc against encode_batch's, 64 against the oracle,
    its counters, and its rate (into ``res``).  Returns the docs by
    batch."""
    from tekken_tpu_torch.parallel.encode import DistributedEncoder

    denc = DistributedEncoder(tok, mesh=mesh, rows=B_MAIN, row_len=ROW,
                              merge=merge)
    # its spans merge in the native engine, in both modes
    if denc._merge_fn != tok._get_native_encoder().merge_spans:
        raise AssertionError(f"[dp] merge={merge}: merge_fn {denc._merge_fn}")
    out = {}
    for name in names:
        what = f"[dp] merge={merge} {name}"
        texts = batches[name]
        nbytes = sum(len(t.encode("utf-8")) for t in texts)
        with Capture(packed_mod, "stage1_compact") as c1, \
                Capture(packed_mod, "merge_buckets") as c2:
            _build.reset_launches()
            docs, n_bytes, n_tokens = denc.encode_batch(texts)
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
        one_launch_a_call(what, counts, c2.calls)
        if (not c1.calls or counts["stage1_compact"] != len(c1.calls)
                or len(c2.calls) > len(c1.calls)
                or (merge == "host") != (not c2.calls)):
            raise AssertionError(f"{what}: launches {counts} for "
                                 f"{len(c1.calls)} encode calls")
        want = routed_out[name]
        for i, (a, b) in enumerate(zip(docs, want)):
            if [r + N_SPECIAL for r in a] != b:
                raise AssertionError(f"{what}: doc {i} differs from "
                                     f"encode_batch")
        if len(docs) != len(want):
            raise AssertionError(f"{what}: {len(docs)} docs")
        for i in random.Random(3).sample(range(len(texts)), 64):
            if docs[i] != encode_ranks(texts[i], tok.ranks):
                raise AssertionError(f"{what}: doc {i} differs from the "
                                     f"oracle")
        if (n_bytes, n_tokens) != (nbytes, sum(len(d) for d in docs)):
            raise AssertionError(f"{what}: counters {n_bytes} {n_tokens}")
        log(f"{what}: {len(texts)} docs, {nbytes} bytes, {n_tokens} tokens "
            f"in {len(c1.calls)} encode calls; launches {counts}; overflow "
            f"rows {denc.last_overflow_rows}; every doc equals encode_batch, "
            f"64-doc oracle sample identical")
        res[f"dp_{merge}_{name}"] = {
            "bytes": nbytes, "launches": counts,
            **mb_per_s(what, nbytes, lambda: denc.encode_batch(texts))}
        out[name] = docs
    return out


def path_c(tok, batches, routed_out, flat_out):
    """DistributedEncoder on an NCCL process group of one rank (cuda:0):
    encode_batch in device-merge mode against the routed encode_batch and
    the oracle, the gather alone, and the unrouted encode_step against the
    flat path (host-merge mode runs in path F)."""
    import torch.distributed as dist

    from tekken_tpu_torch.parallel.encode import DistributedEncoder

    res = {}
    with world_of_one() as mesh:
        docs = dp_encode(tok, mesh, "device", ("route1_bench",
                                               "mixed_1pct_utf8"),
                         batches, routed_out, res)

        # encode_batch's one collective that carries data, alone: the
        # gather of the route-1 batch's (flat, cuts)
        gather_docs = docs["route1_bench"]
        part = (np.concatenate([np.asarray(d, np.int32)
                                for d in gather_docs]),
                np.cumsum([0] + [len(d) for d in gather_docs]))
        parts = [None]
        g_s, g_lo, g_hi = median_s(lambda: dist.all_gather_object(
            parts, part, group=mesh.group))
        log(f"[dp] all_gather_object of the route-1 batch's "
            f"{len(gather_docs)} docs' flat ranks: median of 5 "
            f"{g_s * 1e3:.1f} ms (min {g_lo * 1e3:.1f}, max "
            f"{g_hi * 1e3:.1f})")
        res["dp_all_gather_route1_bench"] = {
            "e2e_s": g_s, "e2e_min_max_s": [g_lo, g_hi]}

        # the unrouted step through encode_step(route=None)
        denc = DistributedEncoder(tok, mesh=mesh, rows=B_MAIN, row_len=ROW)
        texts = batches["route1_bench"]
        nbytes = sum(len(t.encode("utf-8")) for t in texts)
        buf, lens = packed_mod.pack_rows(texts, B_MAIN, ROW)
        _build.reset_launches()
        docs = packed_mod.split_ids(*denc._encode_buffer(buf, lens,
                                                         len(texts), None))
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        if (counts["stage1_fused"] != 1 or counts["stage1_compact"]
                or counts["merge_rows"] != 1):
            raise AssertionError(f"[dp] route=None: launches {counts}")
        if docs != flat_out["route1_bench"]:
            raise AssertionError("[dp] route=None: the docs differ from the "
                                 "flat path's")
        log(f"[dp] encode_step(route=None) route1_bench: launches {counts}; "
            f"every doc equals the flat path's")
        res["dp_flat_route1_bench"] = {
            "bytes": nbytes, "launches": counts,
            **mb_per_s("[dp] route=None route1_bench", nbytes,
                       lambda: denc._encode_buffer(buf, lens, len(texts),
                                                   None))}
    return res


def path_d(tok, words, batches):
    """CorpusEncoder.encode_files_to_jsonl over 4 shard files: the route-1
    batch's docs and 8 docs of 3-5 rows, which run as piece-safe
    segments."""
    import tempfile

    from tekken_tpu_torch.parallel.corpus import CorpusEncoder

    rng = random.Random(41)
    big = []
    for k in range(8):
        ws = build_corpus(words, rng, 1, (3 + k % 3) * ROW)[0].split(" ")
        for i in range(0, len(ws), 7):   # whitespace runs: unsafe cuts
            ws[i] += rng.choice(("  ", "\t", " \t "))
        big.append(" ".join(ws))
    docs = list(batches["route1_bench"])
    for k, d in enumerate(big):
        docs.insert(rng.randrange(len(docs) + 1), d)
    nbytes = sum(len(d.encode("utf-8")) for d in docs)
    with tempfile.TemporaryDirectory() as root:
        shards = []
        per = -(-len(docs) // 4)
        for s in range(4):
            path = f"{root}/shard{s}.txt"
            with open(path, "w", encoding="utf-8") as f:
                f.write("\n".join(docs[s * per:(s + 1) * per]) + "\n")
            shards.append(path)
        cenc = CorpusEncoder(tok, rows=B_CORPUS, row_len=ROW)
        with Capture(packed_mod, "merge_buckets") as c2:
            _build.reset_launches()
            t0 = time.perf_counter()
            stats = cenc.encode_files_to_jsonl(shards, f"{root}/out.jsonl")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(_build.LAUNCHES)
        with open(f"{root}/out.jsonl", encoding="utf-8") as f:
            lines = f.read().splitlines()
    one_launch_a_call("[corpus]", counts, c2.calls)
    if not counts["stage1_compact"] or not counts["merge_rows"]:
        raise AssertionError(f"[corpus] launches {counts}")
    if len(lines) != len(docs):
        raise AssertionError(f"[corpus] {len(lines)} lines for {len(docs)} "
                             f"docs")
    check = [docs.index(d) for d in big]
    check += random.Random(4).sample(range(len(docs)), 64)
    for i in check:
        if json.loads(lines[i]) != tok.encode(docs[i], False, False):
            raise AssertionError(f"[corpus] line {i} differs from encode")
    n_tokens = sum(len(json.loads(ln)) for ln in lines)
    want = {"documents": len(docs), "oversized_documents": len(big),
            "bytes": nbytes, "tokens": n_tokens}
    if {k: stats[k] for k in want} != want:
        raise AssertionError(f"[corpus] stats {stats}, expected {want}")
    log(f"[corpus] {len(shards)} shards, {len(docs)} docs ({len(big)} of 3-5 "
        f"rows), {nbytes} bytes, {n_tokens} tokens; launches {counts}; the "
        f"oversize docs and 64 sampled lines equal Tekkenizer.encode; stats "
        f"{json.dumps(stats)}")
    log(f"[corpus] end to end {wall * 1e3:.1f} ms = {nbytes / wall / 1e6:.2f} "
        f"MB/s (one call)")
    return {"corpus": {"bytes": nbytes, "tokens": n_tokens,
                       "launches": counts, "e2e_s": wall,
                       "e2e_MB_per_s": nbytes / wall / 1e6, "stats": stats}}


def tones(g, n, rate, n_samples):
    """n clips of three random tones and noise, float32."""
    t = np.arange(n_samples) / rate
    f = g.uniform(80, 4000, (n, 3))
    x = sum(0.2 * np.sin(2 * np.pi * f[:, k, None] * t) for k in range(3))
    return (x + 0.05 * g.standard_normal((n, n_samples))).astype(np.float32)


def mel_reference(x, cfg, rate):
    """float64 numpy mel power and whisper log-mel: reflect pad, periodic
    Hann frames, |rfft|^2 without the last frame, the Slaney bank."""
    win, hop = cfg.window_size, cfg.hop_length
    xp = np.pad(x.astype(np.float64), ((0, 0), (win // 2, win // 2)),
                mode="reflect")
    n_frames = x.shape[1] // hop + 1
    frames = np.lib.stride_tricks.sliding_window_view(
        xp, win, axis=-1)[:, ::hop][:, :n_frames]
    w = 0.5 * (1 - np.cos(2 * np.pi * np.arange(win) / win))
    spec = np.abs(np.fft.rfft(frames * w, axis=-1)) ** 2
    mel = spec[:, :-1] @ tt.mel_filter_bank(win // 2 + 1, cfg.num_mel_bins,
                                           0.0, rate / 2, rate)
    lm = np.log10(np.maximum(mel, 1e-10))
    lm = np.maximum(lm, lm.max(axis=(1, 2), keepdims=True) - 8.0)
    return mel, (lm + 4.0) / 4.0


def audio_tokens(n, rate, cfg):
    """The [BEGIN_AUDIO] + [AUDIO] count of an n-sample clip at ``rate``
    (the reference's frame math, src/audio.rs:555-591)."""
    if rate != cfg.sampling_rate:
        n = -(-n * cfg.sampling_rate // rate)
    n = max(n, cfg.audio_encoding_config.window_size)
    hop = cfg.audio_encoding_config.hop_length
    frames = n // hop if n % hop == 0 else int(np.ceil(n / hop - 1.0))
    return 1 + int(np.ceil(frames / cfg.audio_length_per_tok()))


def resample_refs():
    """Path E's clips for the batched resampler, and the host resampler's
    output for the first REF_SECONDS of clips 0-1 (numpy FFTs of 2^25
    points, ~2 s each) started in two spawned processes: (clips, executor,
    futures).  Started at the top of the run, they overlap the builds and
    the configuration."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from tekken_tpu_torch.ops.resample import resample_poly_host

    x = tones(np.random.default_rng(2025), N_RES_CLIPS, RES_RATE,
              RES_RATE * RES_SECONDS)
    pool = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
        "spawn"))
    return x, pool, [pool.submit(resample_poly_host,
                                 x[i, :RES_RATE * REF_SECONDS], RES_RATE,
                                 SAMPLE_RATE) for i in range(2)]


def path_e(tok, x_res, want):
    """Audio on the card: the log and linear mel spectrograms of 32 clips
    of 30 s against float64, the batched resampler on 16 clips of 10 s at
    44.1 kHz and on the first REF_SECONDS of clips 0-1 against the host
    resampler's output ``want`` for those (``resample_refs``; the 10-s
    outputs up to REF_MARGIN samples before the references' end), and
    encode_audio_batch."""
    from tekken_tpu_torch.ops.resample import resample_poly_batched

    cfg = tok.audio_config()
    spec_cfg = cfg.audio_encoding_config
    enc = tok._audio_encoder
    g = np.random.default_rng(2024)
    res = {}
    x = tones(g, N_MEL_CLIPS, SAMPLE_RATE, SAMPLE_RATE * MEL_SECONDS)
    xg = torch.from_numpy(x).to(DEV)
    logmel = enc.mel_spectrogram(xg)
    lin = enc.mel_spectrogram(xg, log=False)
    torch.cuda.synchronize()
    want_lin, want_log = mel_reference(x, spec_cfg, SAMPLE_RATE)
    n_frames = SAMPLE_RATE * MEL_SECONDS // spec_cfg.hop_length
    shape = (N_MEL_CLIPS, n_frames, spec_cfg.num_mel_bins)
    if tuple(logmel.shape) != shape or tuple(lin.shape) != shape:
        raise AssertionError(f"[audio] mel shapes {tuple(logmel.shape)} "
                             f"{tuple(lin.shape)}, expected {shape}")
    lin = lin.cpu().numpy().astype(np.float64)
    logmel = logmel.cpu().numpy().astype(np.float64)
    peak = want_lin.max(axis=(1, 2), keepdims=True)
    # linear: rtol 1e-4 plus 1e-6 of the clip's peak; log: atol 1e-4
    lin_err = np.abs(lin - want_lin)
    if not np.all(lin_err <= 1e-4 * np.abs(want_lin) + 1e-6 * peak):
        raise AssertionError("[audio] the mel power is outside its "
                             "tolerance")
    log_err = float(np.abs(logmel - want_log).max())
    if not log_err <= 1e-4:
        raise AssertionError(f"[audio] log-mel max abs err {log_err}")
    mel_ms = cuda_ms(lambda: enc.mel_spectrogram(xg), 5)
    lin_ms = cuda_ms(lambda: enc.mel_spectrogram(xg, log=False), 5)
    log(f"[audio] mel_spectrogram {shape} of {N_MEL_CLIPS} x "
        f"{MEL_SECONDS} s: max abs err {log_err:.3g} log-mel (atol 1e-4),"
        f" {float((lin_err / peak).max()):.3g} of the peak linear (rtol "
        f"1e-4 + 1e-6 of the peak) against float64; {mel_ms:.3f} ms log,"
        f" {lin_ms:.3f} ms linear")
    res["mel"] = {"shape": shape, "log_max_abs_err": log_err,
                  "ms_log": mel_ms, "ms_linear": lin_ms}

    xr = torch.from_numpy(x_res).to(DEV)
    y = resample_poly_batched(xr, RES_RATE, SAMPLE_RATE)
    torch.cuda.synchronize()
    n_out = -(-x_res.shape[1] * SAMPLE_RATE // RES_RATE)
    if tuple(y.shape) != (N_RES_CLIPS, n_out):
        raise AssertionError(f"[audio] resample shape {tuple(y.shape)}")
    res_ms = cuda_ms(lambda: resample_poly_batched(xr, RES_RATE,
                                                   SAMPLE_RATE), 3)
    y = y.cpu().numpy()
    keep = len(want[0]) - REF_MARGIN
    short = resample_poly_batched(
        torch.from_numpy(x_res[:2, :RES_RATE * REF_SECONDS]).to(DEV),
        RES_RATE, SAMPLE_RATE).cpu().numpy()
    res_err = max(max(float(np.abs(y[i, :keep] - w[:keep]).max()),
                      float(np.abs(short[i] - w).max()))
                  for i, w in enumerate(want))
    if short.shape[1] != len(want[0]) or not res_err <= 2e-4:
        raise AssertionError(f"[audio] resample max abs err {res_err}")
    log(f"[audio] resample_poly_batched {N_RES_CLIPS} x {RES_SECONDS} s "
        f"{RES_RATE} -> {SAMPLE_RATE} Hz: {res_ms:.3f} ms; clips 0-1 (their "
        f"first {REF_SECONDS} s, and the first {keep} samples of their 10-s "
        f"outputs) max abs err {res_err:.3g} against resample_poly_host "
        f"(atol 2e-4)")
    res["resample"] = {"clips": N_RES_CLIPS, "seconds": RES_SECONDS,
                       "max_abs_err": res_err, "ms": res_ms}

    # encode_audio_batch: 16 clips at 16 kHz of 1-30 s, lengths off the
    # hop too; 16 at 44.1 kHz of 0.05-0.25 s, resampled on the host
    lens = [SAMPLE_RATE * int(g.integers(1, 31)) + int(g.integers(0, 2)) *
            int(g.integers(1, 160)) for _ in range(16)]
    lens44 = [int(g.integers(RES_RATE // 20, RES_RATE // 4))
              for _ in range(16)]
    audios = [tt.Audio.new(tones(g, 1, SAMPLE_RATE, n)[0], SAMPLE_RATE)
              for n in lens]
    audios += [tt.Audio.new(tones(g, 1, RES_RATE, n)[0], RES_RATE)
               for n in lens44]
    clip44 = audios[16].audio_array.copy()
    t0 = time.perf_counter()
    encs = tok.encode_audio_batch(audios)
    enc_ms = (time.perf_counter() - t0) * 1e3
    begin = tok.get_control_token("[BEGIN_AUDIO]")
    audio_id = tok.get_control_token("[AUDIO]")
    for i, (e, n) in enumerate(zip(encs, lens + lens44)):
        rate = SAMPLE_RATE if i < 16 else RES_RATE
        if (e.tokens[0] != begin or set(e.tokens[1:]) != {audio_id}
                or len(e.tokens) != audio_tokens(n, rate, cfg)
                or e.audio.sampling_rate != SAMPLE_RATE):
            raise AssertionError(f"[audio] encode_audio_batch clip {i}: "
                                 f"{len(e.tokens)} tokens")
    on_card = resample_poly_batched(clip44[None], RES_RATE, SAMPLE_RATE,
                                    device=DEV)
    err44 = float(np.abs(on_card[0].cpu().numpy()
                         - encs[16].audio.audio_array).max())
    if not err44 <= 2e-4:
        raise AssertionError(f"[audio] host vs card resample err {err44}")
    n_tok = sum(len(e.tokens) for e in encs)
    log(f"[audio] encode_audio_batch of 32 clips (16 at {RES_RATE} Hz): "
        f"{n_tok} tokens, [BEGIN_AUDIO] + [AUDIO] x n as the frame math "
        f"gives; {enc_ms:.1f} ms (host resample and frame math)")
    res["encode_audio_batch"] = {"clips": 32, "tokens": n_tok, "ms": enc_ms}
    return res


def path_f(tok, words, batches, routed_out):
    """The native C++ host engine (native/, built in phase 1): NativeEncoder
    against the oracle; host-merge mode through PackedEncoder and
    DistributedEncoder with its merge_spans; a ~3 MiB doc through
    encode_batch; the decode bytes of the card against decode_ranks; the
    command line; graft_entry's flagship step on the card."""
    import io
    import tempfile

    from tekken_tpu_torch.__main__ import main as cli
    from tekken_tpu_torch.native import NativeEncoder

    ranks = tok.ranks
    res = {}
    native = tok._get_native_encoder()
    t0 = time.perf_counter()
    NativeEncoder(tok)
    create_s = time.perf_counter() - t0
    if not isinstance(native, NativeEncoder):
        raise AssertionError(f"[native] the tokenizer's host engine {native}")

    # encode and encode_batch against the oracle on 64 docs a batch, and
    # encode_batch of the whole route-1 batch against encode_batch's
    for name, texts in batches.items():
        sample = [texts[i] for i in
                  random.Random(len(name) + 7).sample(range(len(texts)), 64)]
        want = [encode_ranks(t, ranks) for t in sample]
        if [native.encode(t) for t in sample] != want:
            raise AssertionError(f"[native] encode {name} differs from the "
                                 f"oracle")
        if native.encode_batch(sample) != want:
            raise AssertionError(f"[native] encode_batch {name} differs "
                                 f"from the oracle")
    texts = batches["route1_bench"]
    nbytes = sum(len(t.encode("utf-8")) for t in texts)
    got = native.encode_batch(texts)
    if [[r + N_SPECIAL for r in d] for d in got] != routed_out["route1_bench"]:
        raise AssertionError("[native] encode_batch route1_bench differs "
                             "from the card's encode_batch")
    log(f"[native] NativeEncoder made in {create_s:.2f} s; encode and "
        f"encode_batch equal the oracle on 64 docs of each of "
        f"{len(batches)} batches; encode_batch of route1_bench ({len(texts)} "
        f"docs) equals the card's encode_batch")
    res["native_encode_batch_route1_bench"] = {
        "create_s": create_s,
        **mb_per_s("[native] encode_batch route1_bench (threads: one a "
                   "core)", nbytes, lambda: native.encode_batch(texts))}

    # host-merge mode: every miss a span, merged by merge_spans
    henc = packed_mod.PackedEncoder(tok, rows=B_MAIN, row_len=ROW,
                                    device=DEV, merge="host")
    if henc._merge_fn != native.merge_spans:
        raise AssertionError(f"[native] host mode merge_fn {henc._merge_fn}")
    with Capture(packed_mod, "splice_host_merges") as cs, \
            Capture(packed_mod, "merge_buckets") as c2:
        _build.reset_launches()
        out = henc.encode_batch(texts)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
    if counts["stage1_compact"] < 1 or counts["merge_rows"] or c2.calls:
        raise AssertionError(f"[native] host merge: launches {counts}")
    if [[r + N_SPECIAL for r in d] for d in out] != routed_out["route1_bench"]:
        raise AssertionError("[native] host merge: the docs differ from "
                             "encode_batch's")
    n_spans = 0
    oracle_fn = packed_mod.oracle_merge_fn(ranks)
    for (_, _, flat, fb_start, fb_len, _), _ in cs.calls:
        sel = fb_start >= 0
        starts, lens = fb_start[sel], fb_len[sel]
        n_spans += int(sel.sum())
        for a, b in zip(native.merge_spans(flat, starts, lens),
                        oracle_fn(flat, starts, lens)):
            if not np.array_equal(a, b):
                raise AssertionError("[native] merge_spans differs from the "
                                     "oracle's merge")
    stages = clocked_stages(
        lambda clock: henc.encode_batch(texts, clock=clock), reps=3)
    log(f"[native] PackedEncoder(merge='host') route1_bench: launches "
        f"{counts}; {n_spans} spans, merge_spans equal to the oracle's "
        f"merge on all of them; every doc equals encode_batch; stages ms "
        f"(median of 3 clocked calls) "
        + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    host = mb_per_s("[native] host merge route1_bench", nbytes,
                    lambda: henc.encode_batch(texts))
    # the same encoder with the oracle's merge, in this run, for comparison
    henc._merge_fn = oracle_fn
    o_stages = clocked_stages(
        lambda clock: henc.encode_batch(texts, clock=clock), reps=1)
    o_s = sum(o_stages.values()) / 1e3
    log(f"[native] the same with the oracle's merge (one clocked call): "
        f"splice {o_stages['splice']:.1f} ms, all stages {o_s * 1e3:.1f} ms "
        f"= {nbytes / o_s / 1e6:.2f} MB/s")
    res["host_merge_route1_bench"] = {
        "fb_spans": n_spans, "launches": counts, "stages_ms": stages, **host,
        "oracle_merge": {"stages_ms": o_stages,
                         "e2e_MB_per_s": nbytes / o_s / 1e6}}

    # data-parallel host mode
    with world_of_one() as mesh:
        dp_encode(tok, mesh, "host", ("route1_bench",), batches, routed_out,
                  res)

    # one doc of ~3 MiB: cut at piece-safe points, its segments rows of
    # one encode_batch call on the card
    big = route1_batch(words, random.Random(77), ranks, 1, 3 << 20)[0]
    docs = [texts[0], big, batches["route2"][0]]
    _build.reset_launches()
    t0 = time.perf_counter()
    got = tok.encode_batch(docs)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    if tok.engine_used != "packed-device" or counts["stage1_compact"] < 1:
        raise AssertionError(f"[native] oversize doc: {tok.engine_used}, "
                             f"launches {counts}")
    for i, d in enumerate(docs):
        if got[i] != [r + N_SPECIAL for r in native.encode(d)]:
            raise AssertionError(f"[native] oversize batch: doc {i} differs "
                                 f"from NativeEncoder.encode")
    big_bytes = len(big.encode("utf-8"))
    log(f"[native] encode_batch of a {big_bytes}-byte doc between two "
        f"others: {len(got[1])} tokens, equal to NativeEncoder.encode; "
        f"engine_used {tok.engine_used}; launches {counts}; one call "
        f"{big_s * 1e3:.1f} ms")
    res["oversize_doc"] = {"bytes": big_bytes, "tokens": len(got[1]),
                           "launches": counts, "e2e_s": big_s}

    # decode_batch's bytes on the card against decode_ranks on the host,
    # for the route-1 batch's rank stream
    stream = np.concatenate([np.asarray(d, np.int32) for d in
                             routed_out["route1_bench"]]) - N_SPECIAL
    dec = tok._get_device_decoder()
    _build.reset_launches()
    on_card = dec.decode_stream(stream, dec.byte_ends(stream))
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    on_host = native.decode_ranks(stream)
    if on_card != on_host or on_host != "".join(texts).encode("utf-8"):
        raise AssertionError("[native] decode bytes: card and decode_ranks "
                             "differ")
    if counts["decode_store"] < 1:
        raise AssertionError(f"[native] decode bytes: launches {counts}")
    card_s = median_s(lambda: dec.decode_stream(stream,
                                                dec.byte_ends(stream)))
    host_s = median_s(lambda: native.decode_ranks(stream))
    log(f"[native] the bytes of {stream.size} ranks ({len(on_host)} bytes): "
        f"the card's decode_stream {card_s[0] * 1e3:.1f} ms "
        f"({counts['decode_store']} launches), decode_ranks "
        f"{host_s[0] * 1e3:.1f} ms (medians of 5); equal bytes")
    res["decode_bytes_route1_bench"] = {
        "ranks": int(stream.size), "bytes": len(on_host),
        "card_s": card_s, "decode_ranks_s": host_s}

    # the command line, on the bench model saved to a file
    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        if rc != 0:
            raise AssertionError(f"[cli] {argv[0]}: exit code {rc}")
        return buf.getvalue()

    lines = texts[:512]
    if any("\n" in ln for ln in lines):
        raise AssertionError("[cli] a route-1 doc holds a newline")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        model, path = f"{root}/tekken.json", f"{root}/docs.txt"
        tok.save(model)
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        _build.reset_launches()
        by_card = run(["encode-file", "--model", model, "--engine", "device",
                       path])
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        by_native = run(["encode-file", "--model", model, "--engine",
                         "native", path])
        info = json.loads(run(["info", "--model", model]))
        valid = run(["validate", "--model", model])
    want = "".join(json.dumps(d) + "\n" for d in routed_out["route1_bench"]
                   [:512])
    if by_card != want or by_native != want:
        raise AssertionError("[cli] encode-file: device and native JSONL "
                             "differ from each other or from encode_batch")
    if counts["stage1_compact"] < 1:
        raise AssertionError(f"[cli] encode-file device: launches {counts}")
    if (info["vocab_size"], info["num_special_tokens"]) != (
            tok.vocab_size(), N_SPECIAL) or not valid.endswith(
                "native engine parity: checked\nVALIDATION OK\n"):
        raise AssertionError(f"[cli] info {info}, validate {valid!r}")
    cli_s = time.perf_counter() - t0
    log(f"[cli] encode-file --engine device (launches {counts}) and "
        f"--engine native over {len(lines)} route-1 lines: equal JSONL, "
        f"equal to encode_batch; info {json.dumps(info)}; validate "
        f"{valid.strip().splitlines()[-1]}; {cli_s:.1f} s with the model "
        f"file's save and four loads")
    res["cli"] = {"lines": len(lines), "launches": counts, "s": cli_s}

    # graft_entry's flagship step: the unrouted packed encode on the
    # synthetic tokenizer at (8, 128)
    synth = graft_entry.toy_tokenizer(DEV)
    samples = [s.decode() for s in graft_entry.SAMPLES]
    fn, args = graft_entry.entry(DEV)
    _build.reset_launches()
    tok_, n_out, fb_start, fb_len, overflow, _ = fn(*args)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    flat = tok_.cpu().numpy()
    pos = np.flatnonzero(flat >= 0)
    out, pos = packed_mod.splice_host_merges(
        flat[pos], pos, args[0].cpu().numpy().reshape(-1),
        fb_start.cpu().numpy(), fb_len.cpu().numpy(),
        packed_mod.oracle_merge_fn(synth.ranks))
    got = [out[pos // 128 == i].tolist() for i in range(len(samples))]
    if (got != [encode_ranks(s, synth.ranks) for s in samples]
            or int(overflow) or counts["merge_rows"] != 1
            or counts["stage1_compact"] or counts["stage1_fused"]):
        raise AssertionError(f"[synthetic] graft_entry.entry() at (8, 128) "
                             f"differs from the oracle (launches {counts})")
    if synth.encode_batch(samples, True, True) != [
            synth.encode(s, True, True) for s in samples]:
        raise AssertionError("[synthetic] encode_batch differs from encode")
    log(f"[synthetic] build_synthetic_tokenizer(num_merges=200, "
        f"num_special_tokens=20): {synth.vocab_size()} ids; "
        f"graft_entry.entry()'s step (8, 128) on the card: n_out "
        f"{int(n_out)}, {int((fb_start >= 0).sum())} host-merged spans, "
        f"equals the oracle, launches {counts}; encode_batch equals encode")
    return res


def path_g(tok, batches):
    """The differential engines on the card, which launch none of the four
    kernels: FlatEncoder on 64 docs of three batches against the oracle and
    encode_batch, probe_pairs and the bucket merge against numpy and the
    oracle, pretokenize_vec and byte_boundaries_via_chars against the
    oracle and byte_boundaries, and graft_entry.dryrun_multichip(1) in an
    NCCL group of one."""
    from tekken_tpu_torch.oracle import byte_pair_merge, pretokenize
    from tekken_tpu_torch.ops.bpe import merge_bucket_fn, probe_pairs
    from tekken_tpu_torch.ops.pretokenize import (byte_boundaries_via_chars,
                                                  pretokenize_vec)
    from tekken_tpu_torch.vocab import pair_hash

    ranks = tok.ranks
    res = {}

    def no_launch(what, counts):
        if any(counts.values()):
            raise AssertionError(f"{what}: kernels launched {counts}")

    fenc = flat_mod.FlatEncoder(tok, rows=64, row_len=1024, device=DEV)
    for name in ("route1_bench", "route2", "route3"):
        texts = [clip_bytes(d, 1024) for d in batches[name][:64]]
        nbytes = sum(len(t.encode("utf-8")) for t in texts)
        routed = tok.encode_batch(texts)
        with Capture(flat_mod, "_seg_lexmin_suffix") as rounds:
            _build.reset_launches()
            got = fenc.encode_batch(texts)
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
        no_launch(f"[flat engine] {name}", counts)
        for i, (t, g) in enumerate(zip(texts, got)):
            if g != encode_ranks(t, ranks):
                raise AssertionError(f"[flat engine] {name}: doc {i} differs "
                                     f"from the oracle")
            if [r + N_SPECIAL for r in g] != routed[i]:
                raise AssertionError(f"[flat engine] {name}: doc {i} differs "
                                     f"from encode_batch")
        med, lo_, hi_ = median_s(lambda: fenc.encode_batch(texts))
        log(f"[flat engine] FlatEncoder(64, 1024) {name}: 64 docs, {nbytes} "
            f"bytes, {sum(len(g) for g in got)} tokens in "
            f"{len(rounds.calls)} merge rounds; launches {counts}; every doc "
            f"equals the oracle and encode_batch; median of 5 "
            f"{med * 1e3:.1f} ms (min {lo_ * 1e3:.1f}, max {hi_ * 1e3:.1f})")
        res[f"flat_engine_{name}"] = {
            "docs": 64, "bytes": nbytes, "rounds": len(rounds.calls),
            "launches": counts, "e2e_s": med, "e2e_min_max_s": [lo_, hi_]}

    # the pair table's linear probe on 100,000 pairs, half of them keys
    pt = tok.pair_table()
    g = np.random.default_rng(12)
    pick = g.choice(np.flatnonzero(pt.key_left >= 0), 50_000)
    left = np.concatenate([pt.key_left[pick], g.integers(
        -1, len(ranks), 50_000)]).astype(np.int32)
    right = np.concatenate([pt.key_right[pick], g.integers(
        -1, len(ranks), 50_000)]).astype(np.int32)
    table = [torch.from_numpy(a).to(DEV)
             for a in (pt.key_left, pt.key_right, pt.values)]
    _build.reset_launches()
    got = probe_pairs(torch.from_numpy(left).to(DEV),
                      torch.from_numpy(right).to(DEV), *table,
                      pt.max_probes).cpu().numpy()
    want = np.full(left.shape, INF, np.int64)
    done = (left < 0) | (right < 0)
    slot = pair_hash(left, right, pt.size)
    for _ in range(pt.max_probes + 1):          # lookup_host's walk
        kl = pt.key_left[slot]
        hit = ~done & (kl == left) & (pt.key_right[slot] == right)
        want[hit] = pt.values[slot[hit]]
        done |= hit | (kl < 0)
        slot = (slot + 1) & (pt.size - 1)
    sample = g.choice(left.size, 1000)
    if not np.array_equal(got, want) or any(
            pt.lookup_host(int(left[i]), int(right[i])) != (
                want[i] if want[i] < INF else -1)
            for i in sample if left[i] >= 0 and right[i] >= 0):
        raise AssertionError("[probe_pairs] differs from the pair table's "
                             "host probe")

    # the bucket merge on out-of-vocabulary pieces of 4-16 bytes
    rng = random.Random(21)
    pieces = [(" " + oov_word(rng, ranks, 3, 15)).encode()
              for _ in range(1024)]
    r0 = np.zeros((len(pieces), 16), np.int32)
    lens = np.zeros(len(pieces), np.int32)
    for i, p in enumerate(pieces):
        r0[i, :len(p)] = np.frombuffer(p, np.uint8)
        lens[i] = len(p)
    out, n = merge_bucket_fn(16, pt.max_probes)(
        torch.from_numpy(r0).to(DEV), torch.from_numpy(lens).to(DEV), *table)
    out, n = out.cpu().numpy(), n.cpu().numpy()
    for i, p in enumerate(pieces):
        if out[i, :n[i]].tolist() != byte_pair_merge(p, ranks):
            raise AssertionError(f"[merge_bucket_fn] piece {p!r} differs "
                                 f"from byte_pair_merge")

    # the boundary formulations
    docs = (batches["route1_bench"][:200] + batches["route2"][:150]
            + batches["route3"][:150])
    t0 = time.perf_counter()
    for d in docs:
        d = clip_bytes(d, 256)
        if pretokenize_vec(d, device=DEV) != pretokenize(d):
            raise AssertionError(f"[pretokenize_vec] {d[:40]!r}... differs "
                                 f"from oracle.pretokenize")
    pv_s = time.perf_counter() - t0
    b, ln = pack_rows(batches["route3"], ROW)
    flags = byte_boundaries_via_chars(b, ln)
    if not torch.equal(flags, byte_boundaries(b, ln)):
        raise AssertionError("[boundaries] byte_boundaries_via_chars differs "
                             "from byte_boundaries on route3")
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    no_launch("[probe/merge/boundaries]", counts)
    log(f"[probe_pairs] {left.size} pairs ({int((got < INF).sum())} in the "
        f"table, max_probes {pt.max_probes}) equal the numpy probe; "
        f"[merge_bucket_fn] P=16 on {len(pieces)} out-of-vocabulary pieces "
        f"of {int(lens.min())}-{int(lens.max())} bytes equals byte_pair_merge"
        f" ({int(n.sum())} tokens); [pretokenize_vec] {len(docs)} docs of "
        f"<= 256 bytes equal oracle.pretokenize ({pv_s:.2f} s); "
        f"[byte_boundaries_via_chars] route3 {tuple(b.shape)}: "
        f"{int(flags.sum())} flags, equal to byte_boundaries; launches "
        f"{counts}")
    res["differential_pieces"] = {
        "probe_pairs": int(left.size), "merge_pieces": len(pieces),
        "pretokenize_vec_docs": len(docs), "pretokenize_vec_s": pv_s,
        "via_chars_flags": int(flags.sum())}

    # graft_entry's multi-chip dryrun in an NCCL group of one
    t0 = time.perf_counter()
    with world_of_one():
        dry = graft_entry.dryrun_multichip(1, device=DEV)
    res["dryrun_multichip_1"] = {**dry, "s": time.perf_counter() - t0}
    log(f"[graft] dryrun_multichip(1) in an NCCL group of one: {dry}; "
        f"{res['dryrun_multichip_1']['s']:.1f} s with the bench tokenizer's "
        f"build")
    return res


# --------------------------------------------------------------------- #
# phase H: the verification tools on the card
# --------------------------------------------------------------------- #

def path_h(tok):
    """The port's verification tools (``tekken_tpu_torch.tools``) on the
    card, all four kernels between one zeroing of the launch counts and
    one reading: a fixed-count soak (vocabularies of H_MERGES merges, 4
    batches of 16 x 4096 each, seed ``soak.SEED``) with decode_batch
    (RAISE) and the unrouted flat encode of the same texts, and the
    routed and the flat encode of a batch of joined docs past the
    2,048-lane tile and of a simple-ASCII batch; fuzz_all_engines for 5
    batches; the golden corpus through every engine; validate on the
    bench model saved to a file.
    Fails on any mismatch and unless each kernel launched."""
    import io
    import tempfile

    from tekken_tpu_torch.ops.flat import FlatEncoder
    from tekken_tpu_torch.ops.packed import PackedEncoder
    from tekken_tpu_torch.tools import fuzz_all_engines, soak, validate_model

    def quiet(fn, *a):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(*a)
        return rc, buf.getvalue()

    res = {}
    _build.reset_launches()
    t_h = time.perf_counter()

    # the soak's vocabularies: every doc through PackedEncoder(16, 4096),
    # the native engine and the oracle, and back through the host decode
    # (soak.soak_vocab), then through the card's decode and the flat encode
    rng = random.Random(soak.SEED)
    words = [w for t in soak.TRAIN_TEXTS for w in t.split() if w.isascii()]
    r_ascii = random.Random(8)
    ascii_batch = []
    for _ in range(16):
        doc = r_ascii.choice(words)
        while len(doc) < 4000:
            doc += " " + r_ascii.choice(words)
        ascii_batch.append(doc[:4096].rstrip())
    soak_docs = bad = long_docs = 0
    vocab_sizes = []
    for n_merges in H_MERGES:
        stok, enc, batches_h, lines = soak.soak_vocab(
            n_merges, rng, soak.SEED, DEV, n_batches=4, rows=16,
            row_len=4096)
        texts = [t for b in batches_h for t in b]
        # the soak's docs stay under 2,400 bytes: 16 docs of its texts
        # joined to 2,500-4,096 bytes cross the 2,048-lane tile
        long_batch = []
        for k in range(16):
            doc = ""
            for t in texts[k:] + texts[:k]:
                if len(doc.encode()) > 2500:
                    break
                doc += t
            long_batch.append(clip_bytes(doc, 4096))
        shift = stok.num_special_tokens()
        want = {t: encode_ranks(t, stok.ranks)
                for t in texts + ascii_batch + long_batch}
        # the routed encode of the long and the ASCII batches
        for b in (long_batch, ascii_batch):
            lines += [f"MISMATCH merges={n_merges} seed={soak.SEED} "
                      f"doc={t!r} routed encode" for t, o in zip(
                          b, enc.encode_batch(b)) if o != want[t]]
        # decode_batch on the card, RAISE: the oracle's ids round-trip
        back = stok.decode_batch([[r + shift for r in want[t]]
                                  for t in texts], SpecialTokenPolicy.RAISE)
        lines += [f"MISMATCH merges={n_merges} seed={soak.SEED} doc={t!r} "
                  f"decode_batch" for t, b_ in zip(texts, back) if b_ != t]
        # the unrouted flat encode of the same batches, the long and the
        # ASCII batch
        for b in batches_h + [long_batch, ascii_batch]:
            buf, lens = enc.pack(b)
            out = packed_mod.split_ids(*enc._encode_buffer(buf, lens, len(b),
                                                           None))
            lines += [f"MISMATCH merges={n_merges} seed={soak.SEED} "
                      f"doc={t!r} flat encode" for t, o in zip(b, out)
                      if o != want[t]]
        for ln in lines:
            log(f"[tools] {ln}")
        bad += len(lines)
        soak_docs += len(texts)
        long_docs += sum(len(t.encode()) > 2048 for t in long_batch)
        vocab_sizes.append((n_merges, len(stok.ranks),
                            tuple(stok.device_tables().packed.shape)))
    torch.cuda.synchronize()
    soak_s = time.perf_counter() - t_h
    log(f"[tools] soak: vocabularies (merges asked, ranks, cuckoo table) "
        f"{vocab_sizes}: {soak_docs} docs through PackedEncoder(16, 4096), "
        f"the native engine, the oracle, decode_batch (RAISE) and the flat "
        f"encode; a batch of 16 joined docs ({long_docs} over 2,048 bytes "
        f"in all) and one of {len(ascii_batch)} simple-ASCII docs of ~4 KB "
        f"a vocabulary through the routed and the flat encode; "
        f"{bad} mismatches; {soak_s:.1f} s")

    # the cross-engine fuzz: 5 batches, seed 0
    t0 = time.perf_counter()
    rc, out = quiet(fuzz_all_engines.main, 5, 0, DEV)
    log(f"[tools] fuzz_all_engines 5 batches on {DEV}: rc {rc}, "
        f"{out.strip().splitlines()[-1]}; {time.perf_counter() - t0:.1f} s")
    if rc:
        log(out)
        bad += 1

    # the golden corpus: the oracle, the native engine, encode_batch,
    # PackedEncoder, FlatEncoder and decode under IGNORE, on cuda:0
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "golden", "synthetic_v1.json")) as f:
        golden = json.load(f)
    cfg = golden["tokenizer"]
    md = build_synthetic_model_data(
        num_merges=cfg["num_merges"],
        num_special_tokens=cfg["num_special_tokens"])
    gtok = tt.Tekkenizer.from_model_data(md, device="cuda:0")
    otok = tt.Tekkenizer.from_model_data(md, device="cuda:0", native=False)
    texts = [e["text"] for e in golden["entries"]]
    ids = [e["ids"] for e in golden["entries"]]
    gs = gtok.num_special_tokens()

    def full(ranks):
        return [gtok.bos_id()] + [r + gs for r in ranks] + [gtok.eos_id()]

    engines = {
        "oracle": [otok.encode(t, True, True) for t in texts],
        "native": [gtok.encode(t, True, True) for t in texts],
        "encode_batch": gtok.encode_batch(texts, True, True),
        "PackedEncoder": [full(r) for r in PackedEncoder(
            gtok, rows=len(texts), row_len=256,
            device="cuda:0").encode_batch(texts)],
        "FlatEncoder": [full(r) for r in FlatEncoder(
            gtok, rows=len(texts), row_len=256,
            device="cuda:0").encode_batch(texts)],
    }
    golden_bad = [k for k, v in engines.items() if v != ids]
    if [gtok.decode(i, SpecialTokenPolicy.IGNORE) for i in ids] != texts:
        golden_bad.append("decode")
    log(f"[tools] golden synthetic_v1.json ({len(texts)} entries) on cuda:0: "
        f"{', '.join(engines)} and decode (IGNORE) "
        f"{'differ: ' + str(golden_bad) if golden_bad else 'reproduce it'}")
    bad += len(golden_bad)

    # validate on the bench model
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        tok.save(f"{root}/tekken.json")
        rc, out = quiet(validate_model.main, [f"{root}/tekken.json"])
    log(f"[tools] validate_model on the bench model: rc {rc}, "
        f"{out.strip().splitlines()[-1]}; {time.perf_counter() - t0:.1f} s")
    if rc or not out.endswith("VALIDATION OK\n"):
        log(out)
        bad += 1

    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    h_s = time.perf_counter() - t_h
    log(f"[tools] phase H launches {counts}; mismatches {bad}; {h_s:.1f} s "
        f"({'within' if h_s <= PATH_H_AIM_S else 'over'} its "
        f"{PATH_H_AIM_S} s aim)")
    if bad:
        raise AssertionError(f"phase H: {bad} mismatches")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"phase H: kernels {missing} not launched")
    res["tools"] = {"soak_docs": soak_docs, "long_docs": long_docs,
                    "vocabularies": vocab_sizes, "mismatches": bad,
                    "launches": counts, "s": h_s, "soak_s": soak_s}
    return res


# --------------------------------------------------------------------- #
# phase I: the benchmark tools on the card
# --------------------------------------------------------------------- #

def path_i(tok, words):
    """The port's benchmark tools on the card with the bench tokenizer,
    all four kernels between one zeroing of the launch counts and one
    reading: ``tools.bench.run`` at 1,024 rows (its parity checks: two
    docs and the whole batch's device stream against the oracle, no
    overflow, decode_batch on every doc), one sample of ``bench_ab`` and
    of ``bench_batchscale`` at 128 and 1,024 rows.  Fails unless every
    rate of the bench line is measured and each kernel launched."""
    from tekken_tpu_torch.tools import bench, bench_ab, bench_batchscale

    _build.reset_launches()
    t_i = time.perf_counter()
    line = bench.run(tok, words, rows=1024, reps=4, iters=2, decode_reps=4,
                     decode_iters=2, device=DEV)
    log(f"[bench] tools.bench.run at 1,024 rows: {json.dumps(line)}")
    ab = bench_ab.run(tok, words, rows=128, samples=1, device=DEV)
    scale = bench_batchscale.run(tok, words, sizes=(128, 1024), samples=1,
                                 device=DEV)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    i_s = time.perf_counter() - t_i
    log(f"[bench] phase I launches {counts}; {i_s:.1f} s "
        f"({'within' if i_s <= PATH_I_AIM_S else 'over'} its "
        f"{PATH_I_AIM_S} s aim)")
    d = line["detail"]
    unmeasured = [k for k, v in d.items() if k.endswith(("_per_sec",
                                                         "_ratio"))
                  and v is None]
    if line["value"] is None or unmeasured or not d["compile_seconds"]:
        raise AssertionError(f"phase I: the bench line lacks {unmeasured}")
    if not all(ab.values()) or not all(scale.values()):
        raise AssertionError(f"phase I: unmeasured samples {ab} {scale}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"phase I: kernels {missing} not launched")
    return {"bench": {"line": line, "bench_ab_MB_per_s": ab,
                      "bench_batchscale_MB_per_s": scale,
                      "launches": counts, "s": i_s}}


# --------------------------------------------------------------------- #

def main():
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    res_refs = resample_refs()

    # ---- 1. build the kernels in parallel, and the native engine beside ----
    t0 = time.perf_counter()
    native_cached = os.path.exists(native_build.lib_path())
    with ThreadPoolExecutor(1) as pool:
        native_fut = pool.submit(
            lambda: (native_build.build(), time.perf_counter() - t0))
        built = _build.build()
        log(f"[build] {len(built)} kernels in "
            f"{time.perf_counter() - t0:.2f} s")
        native_lib, native_s = native_fut.result()
    log(f"[build] native engine (g++ {' '.join(native_build.CXX_FLAGS)}): "
        f"{native_s:.2f} s cached={native_cached} "
        f"{os.path.relpath(native_lib)}")
    for name, info in built.items():
        log(f"[build] {name}: {info['seconds']:.2f} s "
            f"cached={info['cached']}")
        for ln in info["ptxas"].splitlines():
            log(f"[build]   {ln.strip()}")
    # the merge rows of 4 and 8 lanes live in registers: no stack frame
    frames = [(fn, b) for fn, b in stack_frames(built["merge_rows"]["ptxas"])
              if any(k in fn for k in ("merge_buckets_kernelILi8E",
                                       "merge_rows_kernelILi4E",
                                       "merge_rows_kernelILi8E"))]
    if not built["merge_rows"]["cached"]:
        if len(frames) != 3 or any(b for _, b in frames):
            raise AssertionError(f"merge_rows: P<=8 stack frames {frames}")
        log(f"[build] merge_rows P=4/P=8 instantiations: stack frames "
            f"{[b for _, b in frames]} bytes")

    # ---- 2. full-width configuration ----
    t0 = time.perf_counter()
    words, tok = configuration()
    ranks = tok.ranks
    t1 = time.perf_counter()
    tabs = tok.device_tables()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"[config] vocab {len(ranks)} inner ranks + {N_SPECIAL} specials "
        f"in {t1 - t0:.1f} s; device tables in {t2 - t1:.1f} s: cuckoo "
        f"{tuple(tabs.packed.shape)}, word map {tuple(tabs.word_rows.shape)}")
    digest = hashlib.sha256()
    for t in sorted(ranks):
        digest.update(len(t).to_bytes(2, "little") + t)
    log(f"[config] vocab check: {len(ranks)} ranks, sha256 of the sorted "
        f"token bytes {digest.hexdigest()} (expected {INNER_VOCAB}, "
        f"{VOCAB_SHA256})")
    if (len(ranks), digest.hexdigest()) != (INNER_VOCAB, VOCAB_SHA256):
        raise AssertionError("the bench vocabulary differs from bench.py's")
    flat_build = {}
    for name, build in (("pair_table", tok.pair_table),
                        ("piece_table", tok.piece_table),
                        ("padded_rows", tok.decode_table.padded_rows)):
        t0_ = time.perf_counter()
        got_ = build()
        flat_build[name] = time.perf_counter() - t0_
        shape = got_.shape if name == "padded_rows" else (
            got_.key_left.shape if name == "pair_table" else got_.packed.shape)
        log(f"[config] {name} {tuple(shape)} built in "
            f"{flat_build[name]:.2f} s")
    batches = traffic(words, ranks)
    log(f"[config] traffic built; total {time.perf_counter() - t0:.1f} s")

    # ---- 3. kernels against their plain versions on the card ----
    t_phase = time.perf_counter()

    nw_main = tabs.n_words
    wsize = tabs.word_rows.shape[0]
    long_txt = " ".join(batches["route1_bench"][:40])
    long_utf8 = " ".join(batches["route3"][:40])
    r1 = batches["route1_bench"]
    s1_cases = [
        ("simple", pack_rows(r1[:B_SIDE], ROW), nw_main),
        ("general", pack_rows(batches["route2"], ROW), nw_main),
        ("external", pack_rows(batches["route3"], ROW), nw_main),
        ("simple", pack_rows(r1[B_SIDE:2 * B_SIDE], ROW), 6),
        ("simple", pack_rows([long_txt[:LONG_ROW - 7 * k] for k in range(16)],
                        LONG_ROW), nw_main),
        ("external", pack_rows([clip_bytes(long_utf8, LONG_ROW - 5 * k)
                           for k in range(16)], LONG_ROW), nw_main),
    ]
    for rules, (b, ln), nw in s1_cases:
        kw = {"boundary": byte_boundaries(b, ln)} if rules == "external" else {}
        got = stage1_compact(b, ln, nw, wsize, tabs.wseed, rules, **kw)
        want = stage1_compact_reference(b, ln, nw, wsize, tabs.wseed, rules,
                                        **kw)
        torch.cuda.synchronize()
        check_equal(f"stage1 {rules} {tuple(b.shape)}", got, want)
        log(f"[parity] stage1_compact rules={rules} (B,R)={tuple(b.shape)} "
            f"n_words={nw}: identical, {int(got[-1].sum())} pieces")

    g = np.random.default_rng(5)
    for P in (4, 8, 32, 64):
        B2 = 2 * B_MAIN
        n0 = g.integers(0, P + 1, B2).astype(np.int32)
        letters = np.frombuffer(b"etaoinshrdlucmwfgypbvkjxqz ", np.uint8)
        rank = g.choice(letters, size=(B2, P)).astype(np.int32)
        rank[np.arange(P)[None, :] >= n0[:, None]] = -1
        r = torch.from_numpy(rank).to(DEV)
        n = torch.from_numpy(n0).to(DEV)
        right = torch.cat([r[:, 1:], torch.full_like(r[:, :1], -1)], 1)
        lanes = torch.arange(P, device=DEV)[None, :]
        q_ok = (lanes + 1 < n[:, None]) & (r >= 0) & (right >= 0)
        pr = torch.where(q_ok, tabs.dense[torch.where(q_ok, r * 256 + right,
                                                      0)], INF).to(torch.int32)
        for fixed in (P - 1, None):
            got = merge_rows_compact_fused(r, pr, n, tabs.packed, tabs.seed1,
                                           tabs.seed2, fixed_rounds=fixed)
            want = merge_rows_compact(r, pr, n, tabs.packed, tabs.seed1,
                                      tabs.seed2, fixed_rounds=fixed)
            torch.cuda.synchronize()
            check_equal(f"merge P={P} fixed={fixed}", got, want)
            log(f"[parity] merge_rows P={P} rows={B2} fixed_rounds={fixed}: "
                f"identical, {int((n - got[1]).sum())} merges")

    long_rows = ["a" * LONG_ROW, "", "b" * (LONG_ROW - 513)] + [
        long_txt[:LONG_ROW - 7 * k - 1] for k in range(5)]
    f_cases = [(pack_rows(r1[:B_SIDE], ROW), nw) for nw in (0, 3, 6)]
    f_cases.append((pack_rows(long_rows, LONG_ROW), nw_main))
    for (b, ln), nw in f_cases:
        ws_, sd_ = (wsize, tabs.wseed) if nw else (1, 0)
        got = stage1_fused(b, ln, nw, ws_, sd_)
        want = stage1_fused_reference(b, ln, nw, ws_, sd_)
        torch.cuda.synchronize()
        check_equal(f"stage1_fused {tuple(b.shape)} n_words={nw}", got, want)
        log(f"[parity] stage1_fused (B,R)={tuple(b.shape)} n_words={nw}: "
            f"{len(got)} planes identical at every lane, "
            f"{int((got[0] > 0).sum())} pieces")
    if int(got[0][0, 0]) != LONG_ROW:
        raise AssertionError("stage1_fused: the one-piece row lost its piece")

    dec = DeviceDecoder(tok, device="cuda")
    g = np.random.default_rng(6)
    for n_tok in (65536, 65535, 1, 0):
        ranks_np = g.integers(0, dec._n_ranks, 65536, dtype=np.int32)
        t_ = torch.from_numpy(ranks_np).to(DEV)
        cap_ = dec.out_cap_for(ranks_np[:n_tok])
        got = decode_bytes_compact(t_, n_tok, dec._bytes32, dec._lentab, cap_)
        want = decode_bytes_compact_reference(t_, n_tok, dec._bytes32,
                                              dec._lentab, cap_)
        torch.cuda.synchronize()
        check_equal(f"decode_store n_tokens={n_tok}", got, want)
        log(f"[parity] decode_store T=65536 n_tokens={n_tok} sw4={dec._sw4}:"
            f" all {cap_} bytes identical, total {int(got[1])}")

    # the host resampler's references end before the timed paths start
    t0 = time.perf_counter()
    x_res, pool, futs = res_refs
    res_want = [f.result() for f in futs]
    pool.shutdown()
    log(f"[audio] host resampler references for path E ready, "
        f"{time.perf_counter() - t0:.1f} s waited")

    log(f"[phase 3] {time.perf_counter() - t_phase:.1f} s")

    # ---- 4. the main path ----
    t_phase = time.perf_counter()
    launches = {k: 0 for k in _build.LAUNCHES}
    captured = {}
    results = {}
    routed_out = {}
    for name, texts in batches.items():
        nbytes = sum(len(t.encode("utf-8")) for t in texts)
        with Capture(packed_mod, "stage1_compact") as c1, \
                Capture(packed_mod, "merge_buckets", clone_first=True) as c2:
            _build.reset_launches()
            out = tok.encode_batch(texts)
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
        captured[name] = (c1.calls, c2.calls)
        one_launch_a_call(f"{name}", counts, c2.calls)
        routed_out[name] = out
        for k, v in counts.items():
            launches[k] += v
        stats = tok.last_batch_stats
        if len(out) != len(texts):
            raise AssertionError(f"{name}: {len(out)} results for "
                                 f"{len(texts)} docs")
        sample = random.Random(len(name)).sample(range(len(texts)), 64)
        for i in sample:
            want = [r + N_SPECIAL for r in encode_ranks(texts[i], ranks)]
            if out[i] != want:
                raise AssertionError(f"{name}: doc {i} differs from the "
                                     f"oracle")
        n_tok = sum(len(x) for x in out)

        # end to end (host pack + device + readback + host splice)
        e2e, lo_, hi_ = median_s(lambda: tok.encode_batch(texts))
        stages = clocked_stages(
            lambda clock: tok.encode_batch(texts, clock=clock))
        dev_ms = sum(stages.get(k, 0.0) for k in DEVICE_STAGES)
        results[name] = {
            "docs": len(texts), "bytes": nbytes, "tokens": n_tok,
            "launches": counts, "overflow_rows": stats["overflow_rows"],
            "fb_spans": stats["fb_spans"], "e2e_s": e2e,
            "e2e_MB_per_s": nbytes / e2e / 1e6, "e2e_min_max_s":
            [lo_, hi_], "device_ms": dev_ms, "stages_ms": stages,
        }
        log(f"[main] {name}: {len(texts)} docs, {nbytes} bytes, {n_tok} "
            f"tokens; launches {counts}; overflow rows "
            f"{stats['overflow_rows']}, fb spans {stats['fb_spans']}; "
            f"64-doc oracle sample identical")
        log(f"[main] {name}: end to end median of 5 {e2e * 1e3:.1f} ms "
            f"(min {lo_ * 1e3:.1f}, max {hi_ * 1e3:.1f}) = "
            f"{nbytes / e2e / 1e6:.2f} MB/s; device path {dev_ms:.2f} ms; "
            "stages ms " + json.dumps(
                {k: round(v, 3) for k, v in stages.items()}))
    log(f"[main] launches over the routed encode path: {launches}")
    for k in ("stage1_compact", "merge_rows"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 f"routed encode path")

    log(f"[phase 4] {time.perf_counter() - t_phase:.1f} s")

    # ---- path B: the unrouted flat encode ----
    t_phase = time.perf_counter()
    flat_calls = {}
    flat_out = {}
    flat_launches = {k: 0 for k in _build.LAUNCHES}
    for name in ("route1_bench", "route2", "route3"):
        texts = batches[name]
        nbytes = sum(len(t.encode("utf-8")) for t in texts)
        enc = tok._get_packed_encoder(texts)

        def flat_run(clock=None, texts=texts, enc=enc):
            buf, lens = enc.pack(texts)
            return packed_mod.split_ids(*enc._encode_buffer(
                buf, lens, len(texts), None, clock))

        with Capture(packed_mod, "stage1_fused") as c1, \
                Capture(packed_mod, "merge_buckets", clone_first=True) as c2:
            _build.reset_launches()
            out = flat_run()
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
        flat_calls[name] = (c1.calls, c2.calls)
        flat_out[name] = out
        one_launch_a_call(f"flat {name}", counts, c2.calls)
        for k, v in counts.items():
            flat_launches[k] += v
        want_fused = 1 if name == "route1_bench" else 0
        if counts["stage1_fused"] != want_fused or counts["stage1_compact"]:
            raise AssertionError(f"flat {name}: stage-1 launches {counts}")
        routed = routed_out[name]
        for i, (a, b) in enumerate(zip(out, routed)):
            if [r + N_SPECIAL for r in a] != b:
                raise AssertionError(f"flat {name}: doc {i} differs from the "
                                     f"routed encode_batch")
        sample = random.Random(len(name) + 1).sample(range(len(texts)), 64)
        for i in sample:
            if out[i] != encode_ranks(texts[i], ranks):
                raise AssertionError(f"flat {name}: doc {i} differs from the "
                                     f"oracle")
        e2e, lo_, hi_ = median_s(flat_run)
        stages = clocked_stages(flat_run)
        dev_ms = sum(stages.get(k, 0.0) for k in DEVICE_STAGES)
        results[f"flat_{name}"] = {
            "docs": len(texts), "bytes": nbytes, "launches": counts,
            "e2e_s": e2e, "e2e_MB_per_s": nbytes / e2e / 1e6,
            "e2e_min_max_s": [lo_, hi_], "device_ms": dev_ms,
            "stages_ms": stages}
        log(f"[flat] {name}: {len(texts)} docs, {nbytes} bytes; launches "
            f"{counts}; every doc equals the routed result, 64-doc oracle "
            f"sample identical")
        log(f"[flat] {name}: end to end median of 5 {e2e * 1e3:.1f} ms "
            f"(min {lo_ * 1e3:.1f}, max {hi_ * 1e3:.1f}) = "
            f"{nbytes / e2e / 1e6:.2f} MB/s; device path {dev_ms:.2f} ms; "
            "stages ms " + json.dumps(
                {k: round(v, 3) for k, v in stages.items()}))
    log(f"[flat] launches over the flat encode path: {flat_launches}")
    for k in ("stage1_fused", "merge_rows"):
        if flat_launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the flat "
                                 f"encode path")

    log(f"[path B] {time.perf_counter() - t_phase:.1f} s")

    # ---- path A: decode_batch ----
    t_phase = time.perf_counter()
    texts = batches["route1_bench"]
    bos, eos = tok.bos_id(), tok.eos_id()
    ids = [[bos] + x + [eos] for x in routed_out["route1_bench"]]
    n_ids = sum(len(x) for x in ids)
    with Capture(decode_mod, "decode_bytes_compact") as c3, \
            Capture(decode_mod, "_decode_store") as c4:
        _build.reset_launches()
        got = tok.decode_batch(ids, SpecialTokenPolicy.IGNORE)
        torch.cuda.synchronize()
        dec_launches = dict(_build.LAUNCHES)
    dec_calls, store_calls = c3.calls, c4.calls
    log(f"[decode] launches over the decode path: {dec_launches}")
    if dec_launches["decode_store"] <= 0:
        raise AssertionError("kernel decode_store was not launched on the "
                             "decode path")
    if got != texts:
        bad = next(i for i, (a, b) in enumerate(zip(got, texts)) if a != b)
        raise AssertionError(f"decode_batch: doc {bad} does not round-trip")
    keep = tok.decode_batch(ids, SpecialTokenPolicy.KEEP)
    for i in random.Random(5).sample(range(len(ids)), 64):
        for pol, have in ((SpecialTokenPolicy.KEEP, keep),
                          (SpecialTokenPolicy.IGNORE, got)):
            if have[i] != tok.decode(ids[i], pol):
                raise AssertionError(f"decode_batch {pol.name}: doc {i} "
                                     f"differs from the host decode")
    out_bytes = sum(len(t.encode("utf-8")) for t in texts)
    d_e2e, d_lo, d_hi = median_s(
        lambda: tok.decode_batch(ids, SpecialTokenPolicy.IGNORE))
    results["decode_route1_bench"] = {
        "docs": len(ids), "tokens": n_ids, "bytes_out": out_bytes,
        "launches": dec_launches, "e2e_s": d_e2e,
        "e2e_MB_per_s": out_bytes / d_e2e / 1e6, "e2e_min_max_s": [d_lo, d_hi]}
    log(f"[decode] route1_bench: {len(ids)} docs, {n_ids} tokens with "
        f"BOS/EOS, {out_bytes} bytes out in {len(dec_calls)} chunks; every "
        f"doc round-trips, 64 docs equal the host decode under KEEP and "
        f"IGNORE")
    log(f"[decode] route1_bench: end to end median of 5 {d_e2e * 1e3:.1f} ms "
        f"(min {d_lo * 1e3:.1f}, max {d_hi * 1e3:.1f}) = "
        f"{out_bytes / d_e2e / 1e6:.2f} MB/s")

    log(f"[path A] {time.perf_counter() - t_phase:.1f} s")

    # ---- paths C-I: data-parallel encode, corpus stream, audio, the
    # native engine, the differential engines, the verification and the
    # benchmark tools ----
    for name, run in (("C", lambda: path_c(tok, batches, routed_out,
                                            flat_out)),
                      ("D", lambda: path_d(tok, words, batches)),
                      ("E", lambda: path_e(tok, x_res, res_want)),
                      ("F", lambda: path_f(tok, words, batches,
                                           routed_out)),
                      ("G", lambda: path_g(tok, batches)),
                      ("H", lambda: path_h(tok)),
                      ("I", lambda: path_i(tok, words))):
        t0 = time.perf_counter()
        results.update(run())
        log(f"[path {name}] {time.perf_counter() - t0:.1f} s")
        if name == "G":
            within = time.perf_counter() - t0 <= PATH_G_AIM_S
            log(f"[path G] {'within' if within else 'over'} its "
                f"{PATH_G_AIM_S} s aim")

    # ---- 5. the kernels at the main path's own inputs ----
    t_phase = time.perf_counter()
    # stage 1 at every launch of the routed encode path, each with its bound
    ms1 = plain1 = bound1 = 0.0
    err1 = n1 = 0
    by1 = "bytes"
    for name in batches:
        for k, ((b, ln, nw, ws_, wseed_), kw) in enumerate(captured[name][0]):
            rules = kw.get("rules", "simple")
            got = stage1_compact(b, ln, nw, ws_, wseed_, **kw)
            want = stage1_compact_reference(b, ln, nw, ws_, wseed_, **kw)
            err1 = max(err1, check_equal(f"stage1 {name} call {k}", got,
                                         want))
            ms = cuda_ms(lambda: stage1_compact(b, ln, nw, ws_, wseed_, **kw),
                         20)
            pm = cuda_ms(lambda: stage1_compact_reference(b, ln, nw, ws_,
                                                          wseed_, **kw), 3)
            bnd, by = stage1_bound_ms(b, nw, rules)
            ms1, plain1, bound1 = ms1 + ms, plain1 + pm, bound1 + bnd
            n1 += 1
            by1 = by if by == "operations" else by1
            log(f"[kernel] stage1_compact {name} call {k} at {tuple(b.shape)} "
                f"rules={rules}: {ms:.4f} ms, plain {pm:.3f} ms, bound "
                f"{bnd:.4f} ms ({by}), {int(got[-1].sum())} pieces")
    if n1 != launches["stage1_compact"]:
        raise AssertionError(f"{n1} captured stage-1 calls for "
                             f"{launches['stage1_compact']} launches")
    log(f"[kernel] stage1_compact over its {n1} launches: {ms1:.4f} ms, "
        f"plain {plain1:.3f} ms, bound {bound1:.4f} ms")

    # the bucket merge at every call of both encode paths: parity on each
    # batch's captured inputs, and times of each call
    m_calls = [(name, c) for name in batches for c in captured[name][1]]
    m_calls += [(f"flat_{name}", c) for name in flat_calls
                for c in flat_calls[name][1]]
    if not captured["route1_bench"][1] or not flat_calls["route1_bench"][1]:
        raise AssertionError("the route-1 batch launched no merge")
    tot_ms = tot_plain = tot_bound = tot_dev = 0.0
    err2 = 0
    by_max = (0.0, "bytes")
    for name, ((tok0, *margs), kw) in m_calls:
        N = margs[1].shape[0]
        got = merge_buckets(tok0.clone(), *margs, **kw)
        want = merge_buckets_reference(tok0.clone(), *margs, **kw)
        err2 = max(err2, check_equal(f"merge_buckets {name}", (got[:N],),
                                     (want[:N],)))
        work = tok0.clone()
        ms = cuda_ms(lambda: merge_buckets(work, *margs, **kw), 20)
        dev_ = device_ms(lambda: merge_buckets(work, *margs, **kw),
                         "merge_buckets_kernel")
        pm = cuda_ms(lambda: merge_buckets_reference(work, *margs, **kw), 3)
        bnd, by2 = merge_bound_ms(tok0, *margs, **kw)
        tot_ms, tot_plain, tot_bound = tot_ms + ms, tot_plain + pm, tot_bound + bnd
        tot_dev += dev_
        by_max = max(by_max, (bnd, by2))
        tiers = margs[3]
        log(f"[kernel] merge_buckets {name} tiers (rows, P) "
            f"{[(t[1], t[2]) for t in tiers]}: {ms:.4f} ms a call of the "
            f"wrapper, {dev_:.4f} ms of device time, plain {pm:.3f} ms, "
            f"bound {bnd:.5f} ms ({by2}), {int((got[:N] != tok0[:N]).sum())} "
            f"token slots changed; identical to the plain version")
    k = len(m_calls)
    log(f"[kernel] merge_rows over its {k} launches: {tot_ms / k:.4f} ms a "
        f"call of the wrapper, {tot_dev / k:.4f} ms of device time, plain "
        f"{tot_plain / k:.3f} ms, bound {tot_bound / k:.5f} ms a launch")

    f_calls = flat_calls["route1_bench"][0]
    (b, ln, nw, ws_, wseed_), _ = f_calls[0]
    got = stage1_fused(b, ln, nw, ws_, wseed_)
    want = stage1_fused_reference(b, ln, nw, ws_, wseed_)
    err4 = check_equal("stage1_fused main path", got, want)
    ms4 = cuda_ms(lambda: stage1_fused(b, ln, nw, ws_, wseed_), 20)
    plain4 = cuda_ms(lambda: stage1_fused_reference(b, ln, nw, ws_, wseed_), 3)
    bound4, by4 = fused_bound_ms(b, nw)
    log(f"[kernel] stage1_fused at {tuple(b.shape)} n_words={nw}: "
        f"{ms4:.4f} ms, plain {plain4:.3f} ms, bound {bound4:.4f} ms ({by4})")

    tot3 = plain3 = bound3 = 0.0
    err3 = 0
    by3 = "bytes"
    for (t_, n_tok, b32, lt, cap_), _ in dec_calls:
        got = decode_bytes_compact(t_, n_tok, b32, lt, cap_)
        want = decode_bytes_compact_reference(t_, n_tok, b32, lt, cap_)
        err3 = max(err3, check_equal("decode_store main path", got, want))
        tot3 += cuda_ms(lambda: decode_bytes_compact(t_, n_tok, b32, lt,
                                                     cap_), 20)
        plain3 += cuda_ms(lambda: decode_bytes_compact_reference(
            t_, n_tok, b32, lt, cap_), 3)
        bnd, by3 = decode_bound_ms(n_tok, int(got[1]), cap_)
        bound3 += bnd
    k3 = len(dec_calls)
    # the launch alone, without the wrapper's checks, and the kernel's
    # device time
    alone3 = sum(cuda_ms(lambda: decode_mod._decode_store(*a), 20)
                 for a, _ in store_calls) / len(store_calls)
    # one trace of every chunk's launch, not one trace a chunk
    dev3 = device_ms(lambda: [decode_mod._decode_store(*a)
                              for a, _ in store_calls],
                     "decode_store") / len(store_calls)
    log(f"[kernel] decode_store over {k3} chunks (T={dec_calls[0][0][0].shape[0]},"
        f" sw4={dec_calls[0][0][2].shape[1]}): {tot3 / k3:.4f} ms a call of "
        f"the wrapper, {alone3:.4f} ms the launch alone, {dev3:.4f} ms of "
        f"device time, plain {plain3 / k3:.3f} ms, bound {bound3 / k3:.5f} ms "
        f"({by3})")

    line = {"kernels": [
        {"name": "stage1_compact", "route": "cuda",
         "source": KERNELS["stage1_compact"][0],
         "replaces": KERNELS["stage1_compact"][1],
         "launches": launches["stage1_compact"], "max_abs_err": err1,
         "ms": ms1, "plain_ms": plain1, "bound_ms": bound1, "bound_by": by1,
         "library_ms": None},
        {"name": "merge_rows", "route": "cuda",
         "source": KERNELS["merge_rows"][0],
         "replaces": KERNELS["merge_rows"][1],
         "launches": launches["merge_rows"] + flat_launches["merge_rows"],
         "max_abs_err": err2, "ms": tot_ms / k, "plain_ms": tot_plain / k,
         "bound_ms": tot_bound / k, "bound_by": by_max[1],
         "library_ms": None},
        {"name": "decode_store", "route": "cuda",
         "source": KERNELS["decode_store"][0],
         "replaces": KERNELS["decode_store"][1],
         "launches": dec_launches["decode_store"], "max_abs_err": err3,
         "ms": tot3 / k3, "plain_ms": plain3 / k3, "bound_ms": bound3 / k3,
         "bound_by": by3, "library_ms": None},
        {"name": "stage1_fused", "route": "cuda",
         "source": KERNELS["stage1_fused"][0],
         "replaces": KERNELS["stage1_fused"][1],
         "launches": flat_launches["stage1_fused"], "max_abs_err": err4,
         "ms": ms4, "plain_ms": plain4, "bound_ms": bound4, "bound_by": by4,
         "library_ms": None},
    ]}
    log(f"[phase 5] {time.perf_counter() - t_phase:.1f} s")
    log("[main] per-batch summary " + json.dumps(results))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(f"{smi}")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
