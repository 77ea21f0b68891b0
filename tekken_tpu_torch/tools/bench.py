"""Throughput benchmark of the packed encode on one card: the counterpart
of the repo's ``bench.py``, on the same configuration and traffic.

    python -m tekken_tpu_torch.tools.bench [--rows 4096] [--reps 16]
        [--iters 8] [--decode-reps 32] [--decode-iters 4] [--no-routes]
        [--device cuda]

The bench tokenizer (``models.bench``: seed 1234, 130,872 inner ranks +
1,000 specials, pattern ``.*``, V7) encodes ``rows`` x 2048-byte docs of
its corpus.  The sections, in ``bench.py``'s order:

1. parity: two docs through ``PackedEncoder.encode_batch`` against the
   oracle; after a warm-up call (which must not overflow a merge bucket),
   the whole batch's device stream, spliced with the oracle's merge of the
   long misses, against the oracle over every doc (untimed);
2. ``device_packed_path_bytes_per_sec``, the headline: ``reps`` calls of
   ``ops.packed.packed_encode`` on tensors on the card, the route chosen
   by ``host_route``, the lengths one byte shorter every other call,
   nothing read back between calls and one synchronize at the end, timed
   by CUDA events.  ``packed_encode`` reads its tier counts back in the
   middle of a call, so every call includes its host issue and those
   synchronizes; ``bench.py`` repeats the kernel inside one jitted loop;
3. ``host_dispatched_loop_bytes_per_sec``: ``iters`` calls timed by the
   host clock to one synchronize after the last (nearly item 2 here);
4. the route sweep at ``min(rows, 1024)`` rows (``--no-routes`` skips
   it): general-ASCII (``route2_docs``), UTF-8 (``route3_docs``) and a
   corpus with 1% non-ASCII docs (``mixed_docs``), each batch's route
   asserted and two docs held against the oracle, timed as item 2;
5. decode: ``decode_batch`` (IGNORE) of the spliced stream equals every
   doc; ``device_decode_bytes_per_sec``, ``decode-reps`` calls of the
   decode store over the whole stream in one launch (CUDA events);
   ``decode_batch_end_to_end_bytes_per_sec``, ``decode-iters`` calls of
   ``decode_batch`` (host clock);
6. ``native_host_engine_bytes_per_sec``: ``NativeEncoder.encode_batch``
   of the batch, one thread a core;
7. one JSON line, last: ``metric``, ``value`` (the headline), ``unit``
   and ``detail`` with ``bench.py``'s keys, less ``device_error`` and
   ``target_bytes_per_sec`` (there is no degraded run, and no speed
   target comes from the TPU), plus ``shapes``; ``platform`` is the
   card's ``nvidia-smi`` name and power limit.

Nothing falls back: ``--device cuda`` without a card raises, and a
failure in any section propagates, so the process exits non-zero and
prints no line.  ``--device cpu`` is a rehearsal: every section and check
runs on the kernels' plain versions, and every rate is printed as null.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

import numpy as np
import torch

from .. import _build
from ..models import bench_tokenizer, bench_words, build_corpus
from ..models.bench import BENCH_SEED
from ..native import NativeEncoder
from ..ops import packed
from ..ops.decode import _bucket, decode_bytes_compact, decode_bytes_impl
from ..oracle import encode_ranks
from ..special_tokens import SpecialTokenPolicy
from . import card

ROW_LEN = 2048
ROUTE_ROWS = 1024            # the route sweep's rows at most
CPU_PLATFORM = "cpu (rehearsal: rates not measured)"


def log(msg: str) -> None:
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def bench_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device on a machine without a
    card raises (there is no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device}: no CUDA device (torch.cuda."
                           f"is_available() is False); pass --device cpu "
                           f"for a rehearsal")
    return device


def corpus_rng() -> random.Random:
    """The bench's generator as it stands after drawing the corpus words
    (``bench.py`` draws the words, then the docs, from one
    ``random.Random(1234)``)."""
    rng = random.Random(BENCH_SEED)
    bench_words(rng)
    return rng


def loop_seconds(fn, reps: int, device) -> float | None:
    """Seconds a call of ``fn(i)`` for i in 0..reps-1, issued back to back
    with one synchronize after the last, by CUDA events on the card.  Off
    the card the calls run (a rehearsal) and the result is None."""
    if device.type != "cuda":
        for i in range(reps):
            fn(i)
        return None
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / reps


def host_seconds(fn, n: int, device) -> float | None:
    """Seconds a call of ``fn(i)`` for i in 0..n-1 by the host clock, to
    one synchronize after the last; None off the card (the calls run)."""
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / n


def rate(nbytes: int, seconds: float | None) -> float | None:
    return None if seconds is None else round(nbytes / seconds, 1)


def pack_docs(texts, rows: int, row_len: int = ROW_LEN):
    """(rows, row_len) uint8 buffer of the docs' UTF-8 bytes and their
    lengths (int32), as ``bench.py``'s route sweep packs them."""
    return packed.pack_rows(texts, rows, row_len)


def encoder_loop(byts, lens, tables, route, np_cap):
    """``fn(i)``: one ``packed_encode`` call of the buffer, its lengths one
    byte shorter for odd i (``bench.py``'s perturbation)."""
    alt = (lens, (lens - 1).clamp(min=0))

    def fn(i):
        return packed.packed_encode(byts, alt[i & 1], tables, route, np_cap)
    return fn


def interleaved(variants: dict, reps: int, samples: int, device) -> dict:
    """Warm each variant, then time them in turns, ``samples`` rounds of
    ``reps`` calls each (``loop_seconds``), printing a line a sample and a
    summary a variant.  ``variants``: name -> (``fn(i)``, bytes a call).
    Returns name -> MB/s of each sample (empty off the card)."""
    on_card = device.type == "cuda"
    for name, (fn, nbytes) in variants.items():
        t0 = time.perf_counter()
        n = int(fn(0)[1])
        took = f" in {time.perf_counter() - t0:.2f} s" if on_card else ""
        print(f"warmed {name} ({nbytes} bytes, n_out {n}){took}", flush=True)
    results = {name: [] for name in variants}
    for s in range(samples):
        for name, (fn, nbytes) in variants.items():
            dt = loop_seconds(fn, reps, device)
            if dt is None:
                print(f"sample {s} {name:>10s} not measured ({device})",
                      flush=True)
                continue
            results[name].append(nbytes / dt / 1e6)
            print(f"sample {s} {name:>10s} {nbytes / dt / 1e6:9.1f} MB/s "
                  f"({dt * 1e3:.3f} ms/iter)", flush=True)
    print("---")
    for name, v in results.items():
        if v:
            print(f"{name:>10s} mean {sum(v) / len(v):9.1f}  min "
                  f"{min(v):9.1f}  max {max(v):9.1f} MB/s", flush=True)
        else:
            print(f"{name:>10s} not measured ({device}): {samples} samples "
                  f"of {reps} calls", flush=True)
    return results


# --------------------------------------------------------------------- #
# the route sweep's traffic (bench.py:312-349, the same seeds and string
# operations)
# --------------------------------------------------------------------- #

def route2_docs(docs, row_len: int = ROW_LEN) -> list[str]:
    """General-ASCII docs (route 2): a second space after every 7th word
    from the 4th, and a leading 5-digit number (seed 77)."""
    rng = random.Random(77)
    out = []
    for d in docs:
        parts = d.split(" ")
        for k in range(3, len(parts), 7):
            parts[k] += " "          # ws run of 2 when joined
        parts.insert(0, str(rng.randint(10000, 99999)))
        out.append(" ".join(parts)[:row_len])
    return out


def route3_docs(docs, row_len: int = ROW_LEN) -> list[str]:
    """UTF-8 docs (route 3): the last 8 words dropped and a CJK character
    before every 9th word from the 3rd (seed 88)."""
    rng = random.Random(88)
    cjk = "中文字符测试数据漢字"
    out = []
    for d in docs:
        parts = d.split(" ")[:-8]
        for k in range(2, len(parts), 9):
            parts[k] = rng.choice(cjk) + parts[k]
        out.append(" ".join(parts)[:row_len - 64])
    return out


def mixed_docs(docs, row_len: int = ROW_LEN):
    """The corpus with 1% non-ASCII docs: (the route-1 majority, the
    minority with a trailing ``中``, the minority's rows: the power of two
    at or above its count, at least 8)."""
    n_mix = max(1, len(docs) // 100)
    major = docs[:len(docs) - n_mix]
    minor = [d[:row_len - 8] + "中" for d in docs[len(docs) - n_mix:]]
    rows3 = 8
    while rows3 < n_mix:
        rows3 <<= 1
    return major, minor, rows3


# --------------------------------------------------------------------- #

def run(tok, words, rows: int = 4096, reps: int = 16, iters: int = 8,
        decode_reps: int = 32, decode_iters: int = 4, routes: bool = True,
        device="cuda") -> dict:
    """Every section on ``tok`` (the bench tokenizer, on ``device``) with
    ``rows`` x 2048-byte docs of ``build_corpus(words, corpus_rng(), ...)``;
    returns the line.  Raises on a failed check."""
    dev = bench_device(device)
    on_card = dev.type == "cuda"
    B, R = rows, ROW_LEN
    compile_s = {}
    if on_card:
        t0 = time.perf_counter()
        _build.build()
        compile_s["kernels_build"] = round(time.perf_counter() - t0, 2)

    docs = build_corpus(words, corpus_rng(), n_docs=B, doc_len=R)
    batch_bytes = sum(len(d.encode("utf-8")) for d in docs)
    enc = packed.PackedEncoder(tok, rows=B, row_len=R, np_cap=B * R // 16,
                               device=dev)
    tables = tok.device_tables(dev)

    # 1. parity: two docs through the public grouped path, then the whole
    # batch's device stream after the warm-up call
    for d, g in zip(docs[:2], enc.encode_batch(docs[:2])):
        if g != encode_ranks(d, tok.ranks):
            raise AssertionError("parity failure in the bench batch")
    buf, lengths = enc.pack(docs)
    route = packed.host_route(buf)
    byts = torch.from_numpy(buf).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    encode = encoder_loop(byts, lens, tables, route, enc._np_cap)

    t0 = time.perf_counter()
    out = encode(0)
    n_out = int(out[1])
    compile_s["encode_warmup"] = round(time.perf_counter() - t0, 2)
    if out[4]:
        raise AssertionError("the bench batch overflows a merge bucket; the "
                             "measured run would be incomplete")
    log(f"warm-up {compile_s['encode_warmup']} s on {dev}, route {route}; "
        f"n_out {n_out}")
    st = out[0].cpu().numpy()
    pos0 = np.flatnonzero(st >= 0).astype(np.int64)
    got_ranks, got_pos = packed.splice_host_merges(
        st[pos0], pos0, buf.reshape(-1), out[2].cpu().numpy(),
        out[3].cpu().numpy(), packed.oracle_merge_fn(tok.ranks))
    want = []
    for d in docs:
        want.extend(encode_ranks(d, tok.ranks))
    if got_ranks.tolist() != want:
        raise AssertionError("the device stream differs from the oracle")
    log("full-batch parity of the device stream OK")

    # 2. the headline: reps calls, one synchronize, CUDA events
    dt_in = loop_seconds(encode, reps, dev)
    bps = rate(batch_bytes, dt_in)

    # 3. the host-dispatched loop
    bps_dispatched = rate(batch_bytes,
                          host_seconds(lambda i: encode(0), iters, dev))
    log(f"device packed path {bps} bytes/s; host-dispatched loop "
        f"{bps_dispatched} bytes/s")

    # 4. the route sweep
    route_bps = {}
    mixed_ratio = None
    Bk = min(B, ROUTE_ROWS)
    if routes:
        def measure(texts, want_route, label, n_rows=Bk):
            buf2, lens2 = pack_docs(texts, n_rows, R)
            got_route = packed.host_route(buf2)
            if got_route != want_route:
                raise AssertionError(f"{label}: route {got_route}, not "
                                     f"{want_route}")
            for d, g in zip(texts[:2], enc.encode_batch(texts[:2])):
                if g != encode_ranks(d, tok.ranks):
                    raise AssertionError(f"{label}: parity failure")
            cap2 = max(64, enc._np_cap * n_rows // B)
            fn = encoder_loop(torch.from_numpy(buf2).to(dev),
                              torch.from_numpy(lens2).to(dev), tables,
                              want_route, cap2)
            t1 = time.perf_counter()
            int(fn(0)[1])
            compile_s[f"route{want_route}_{label}"] = round(
                time.perf_counter() - t1, 2)
            return int(lens2.sum()), loop_seconds(fn, reps, dev)

        docs_k = docs[:Bk]
        n2, dt2 = measure(route2_docs(docs_k, R), 2, "general-ascii")
        route_bps["route2"] = rate(n2, dt2)
        n3, dt3 = measure(route3_docs(docs_k, R), 3, "utf8")
        route_bps["route3"] = rate(n3, dt3)
        major, minor, rows3 = mixed_docs(docs_k, R)
        _, dt_ref = measure(docs_k, 1, "route1-ref")
        n_m1, dt_m1 = measure(major, 1, "mixed-major")
        n_m3, dt_m3 = measure(minor, 3, "mixed-minor", n_rows=rows3)
        if on_card:
            route_bps["mixed_1pct_nonascii"] = rate(n_m1 + n_m3,
                                                    dt_m1 + dt_m3)
            mixed_ratio = round((dt_m1 + dt_m3) / dt_ref, 3)
        log(f"route sweep at {Bk} rows: {route_bps}, mixed / route-1 time "
            f"{mixed_ratio}")

    # 5. decode: the spliced stream's id lists through decode_batch, then
    # the decode store over the whole stream
    shift = tok.num_special_tokens()
    cut = np.searchsorted(got_pos // R, np.arange(B + 1))
    id_lists = [got_ranks[cut[i]:cut[i + 1]] + shift for i in range(B)]
    t0 = time.perf_counter()
    texts_out = tok.decode_batch(id_lists, SpecialTokenPolicy.IGNORE)
    compile_s["decode_warmup"] = round(time.perf_counter() - t0, 2)
    if texts_out != docs:
        raise AssertionError("decode_batch differs from the docs")
    log("decode_batch parity on all docs OK")
    out_bytes = sum(len(t.encode("utf-8")) for t in texts_out)

    dec = tok._get_device_decoder()
    stream = got_ranks.astype(np.int32)
    sbuf = np.zeros(_bucket(stream.size), np.int32)
    sbuf[:stream.size] = stream
    toks = torch.from_numpy(sbuf).to(dev)
    out_cap = dec.out_cap_for(stream)
    n_tok = (stream.size, stream.size - 1)
    if dec._sw4 is not None:          # DeviceDecoder's choice of engine
        def decode(i):
            return decode_bytes_compact(toks, n_tok[i & 1], dec._bytes32,
                                        dec._lentab, out_cap)
    else:
        def decode(i):
            return decode_bytes_impl(toks, n_tok[i & 1], dec._flat,
                                     dec._offsets, out_cap)
    got_bytes, total = decode(0)
    if (int(total) != out_bytes or got_bytes[:out_bytes].cpu().numpy()
            .tobytes() != "".join(docs).encode("utf-8")):
        raise AssertionError("the decode store's bytes differ from the docs")
    decode_bps = rate(out_bytes, loop_seconds(decode, decode_reps, dev))

    decode_api_bps = rate(out_bytes, host_seconds(
        lambda i: tok.decode_batch(id_lists, SpecialTokenPolicy.IGNORE),
        decode_iters, dev))
    log(f"device decode {decode_bps} bytes/s; decode_batch end to end "
        f"{decode_api_bps} bytes/s")

    # 6. the native host engine
    ne = NativeEncoder(tok)
    ne.encode_batch(docs[:4])
    native_bps = rate(batch_bytes, host_seconds(
        lambda i: ne.encode_batch(docs, n_threads=0), 1, dev))
    log(f"native host engine {native_bps} bytes/s")

    return {
        "metric": "encode_bytes_per_sec_per_chip",
        "value": bps,
        "unit": "bytes/s",
        "detail": {
            "headline_variant": "device-packed",
            "device_packed_path_bytes_per_sec": bps,
            "host_dispatched_loop_bytes_per_sec": bps_dispatched,
            "device_decode_bytes_per_sec": decode_bps,
            "decode_batch_end_to_end_bytes_per_sec": decode_api_bps,
            "native_host_engine_bytes_per_sec": native_bps,
            "route2_bytes_per_sec": route_bps.get("route2"),
            "route3_bytes_per_sec": route_bps.get("route3"),
            "mixed_1pct_nonascii_bytes_per_sec": route_bps.get(
                "mixed_1pct_nonascii"),
            "mixed_vs_route1_time_ratio": mixed_ratio,
            # the kernels' nvcc build and each section's warm-up call
            "compile_seconds": compile_s if on_card else None,
            "platform": card(dev) if on_card else CPU_PLATFORM,
            "shapes": {"rows": B, "row_len": R,
                       "route_rows": Bk if routes else None,
                       "decode_tokens": int(stream.size)},
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tekken_tpu_torch.tools.bench",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=4096)
    p.add_argument("--reps", type=int, default=16,
                   help="calls of the headline loop and of each route")
    p.add_argument("--iters", type=int, default=8,
                   help="calls of the host-dispatched loop")
    p.add_argument("--decode-reps", type=int, default=32)
    p.add_argument("--decode-iters", type=int, default=4)
    p.add_argument("--no-routes", action="store_true",
                   help="skip the route sweep")
    p.add_argument("--device", default="cuda", help='"cuda" or "cpu"')
    args = p.parse_args(argv)
    dev = bench_device(args.device)
    t0 = time.perf_counter()
    words = bench_words()
    tok = bench_tokenizer(words, dev)
    log(f"vocab {len(tok.ranks)} built in {time.perf_counter() - t0:.1f} s")
    line = run(tok, words, args.rows, args.reps, args.iters,
               args.decode_reps, args.decode_iters, not args.no_routes, dev)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
