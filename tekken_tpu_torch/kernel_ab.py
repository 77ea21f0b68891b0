"""Time this checkout's CUDA kernels against another checkout's, in turns,
on one GPU, at the inputs the main path gives them.

    python3 -m tekken_tpu_torch.kernel_ab OTHER [KERNEL ...]

Run it from the root of this checkout (it takes chip_smoke.py's
configuration and traffic).  OTHER is the root of another checkout of the
repository, for example the parent commit unpacked with ``git archive``;
its ``tekken_tpu_torch`` is loaded under another name and builds its own
kernels into its own ``_build/``.  KERNEL is any of stage1_compact,
stage1_fused, decode_store and merge (all four by default).

The inputs are captured from the main path at the full Tekken V7 width:
stage1_compact at its launches on the route-1 (simple rules), route-2
(general) and route-3 (external flags) batches, stage1_fused at its launch
on the unrouted flat encode of the route-1 batch, and the decode store at
the first 2^16-token chunk of decode_batch over the route-1 batch's ids.
Each checkout's wrapper is first held against this checkout's plain
version on those inputs, then the two are timed other, this, this, other
(CUDA events, the mean of 50 calls each).  Beside stage1_compact at the
route-1 shape it times two yardsticks: ``fill_(-1)`` of its (3 + nw, B, R)
int32 planes, the least time PyTorch takes to write them, and a copy of
its byte buffer; beside stage1_fused, ``fill_(0)`` of its planes.  For
the decode store it also gives each kernel's device time from a profiler
trace.  ``merge`` runs each checkout's ``packed_encode`` on the route-1
batch, routed and flat, checks that both give the same outputs, and
times its clocked ``merge`` stage (host time to a synchronize: the
launches and the tensor work around them) in turns, the median of 11
calls each, and the device time of one call's merge launches.  Prints
one line a measurement, the card's name and power limit, and one JSON
line last.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

KERNELS = ("stage1_compact", "stage1_fused", "decode_store", "merge")
REPS = 50
MERGE_REPS = 11


def load_other(root: str):
    """The other checkout's ``tekken_tpu_torch``, as a package of another
    name (its modules import each other relatively)."""
    pkg = os.path.join(os.path.abspath(root), "tekken_tpu_torch")
    name = "tekken_tpu_torch_other"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def merge_turns(cs, tok, batches, packed_mod, other) -> dict:
    """The clocked ``merge`` stage of each checkout's ``packed_encode`` on
    the route-1 batch, routed and flat, in turns (the median of MERGE_REPS
    calls each), and the device time of the merge launches of one call.
    Each call replays the arguments ``_encode_buffer`` passed, its
    device-merge limit included."""
    o_packed = importlib.import_module(f"{other.__name__}.ops.packed")
    texts = batches["route1_bench"]
    enc = tok._get_packed_encoder(texts)
    buf, lens = enc.pack(texts)
    out = {}
    for label, route in (("route1_bench", 1), ("flat_route1_bench", None)):
        with cs.Capture(packed_mod, "packed_encode") as cap:
            enc._encode_buffer(buf, lens, len(texts), route)
        args, kw = cap.calls[0]
        kw = {k: v for k, v in kw.items() if k != "clock"}
        want = packed_mod.packed_encode(*args, **kw)
        fns = {}
        for who, mod in (("other", o_packed), ("this", packed_mod)):
            got = mod.packed_encode(*args, **kw)
            for k, (g, w) in enumerate(zip(got, want)):
                if not torch.equal(torch.as_tensor(g), torch.as_tensor(w)):
                    raise AssertionError(f"{who} packed_encode {label} output "
                                         f"{k} differs")

            def stage(mod=mod):
                clock = mod.StageClock()
                mod.packed_encode(*args, **kw, clock=clock)
                return clock.times["merge"] * 1e3
            fns[who] = stage

        def median(fn):
            fn()
            return sorted(fn() for _ in range(MERGE_REPS))[MERGE_REPS // 2]
        o1, t1 = median(fns["other"]), median(fns["this"])
        t2, o2 = median(fns["this"]), median(fns["other"])
        row = {"other_ms": [o1, o2], "this_ms": [t1, t2]}
        for who, mod in (("other", o_packed), ("this", packed_mod)):
            row[f"{who}_device_ms"] = cs.device_ms(
                lambda mod=mod: mod.packed_encode(*args, **kw), "merge_", 5)
        cs.log(f"[ab] merge stage {label}: other {o1:.4f} {o2:.4f} ms, this "
               f"{t1:.4f} {t2:.4f} ms; merge kernels' device time a call: "
               f"other {row['other_device_ms']:.5f} ms, this "
               f"{row['this_device_ms']:.5f} ms")
        out[label] = row
    return out


def main(argv) -> None:
    if not argv or any(k not in KERNELS for k in argv[1:]):
        sys.exit(__doc__)
    kernels = argv[1:] or KERNELS
    import chip_smoke as cs   # exits where torch sees no GPU

    from .ops import decode as decode_mod
    from .ops import packed as packed_mod
    from .ops import stage1 as stage1_mod
    from .special_tokens import SpecialTokenPolicy

    other = load_other(argv[0])
    o_mod = {m: importlib.import_module(f"{other.__name__}.ops.{m}")
             for m in ("stage1", "decode")}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(f"[card] {smi}")

    def turns(what, other_fn, this_fn):
        o1, t1 = cs.cuda_ms(other_fn, REPS), cs.cuda_ms(this_fn, REPS)
        t2, o2 = cs.cuda_ms(this_fn, REPS), cs.cuda_ms(other_fn, REPS)
        cs.log(f"[ab] {what}: other {o1:.5f} {o2:.5f} ms, this {t1:.5f} "
               f"{t2:.5f} ms")
        return {"other_ms": [o1, o2], "this_ms": [t1, t2]}

    words, tok = cs.configuration()
    batches = cs.traffic(words, tok.ranks)
    res = {"card": smi}

    if "stage1_compact" in kernels:
        rows = []
        for name in ("route1_bench", "route2", "route3"):
            with cs.Capture(packed_mod, "stage1_compact") as cap:
                tok.encode_batch(batches[name])
            (b, ln, nw, ws_, wseed_), kw = cap.calls[0]
            rules = kw.get("rules", "simple")
            want = stage1_mod.stage1_compact_reference(b, ln, nw, ws_,
                                                       wseed_, **kw)
            fns = {}
            for who, mod in (("other", o_mod["stage1"]),
                             ("this", stage1_mod)):
                fn = mod.stage1_compact
                cs.check_equal(f"{who} stage1_compact {name}",
                               fn(b, ln, nw, ws_, wseed_, **kw), want)
                fns[who] = (lambda fn=fn: fn(b, ln, nw, ws_, wseed_, **kw))
            row = turns(f"stage1_compact {name} {tuple(b.shape)} {rules}",
                        fns["other"], fns["this"])
            row.update(batch=name, shape=list(b.shape), rules=rules,
                       bound_ms=cs.stage1_bound_ms(b, nw, rules)[0])
            rows.append(row)
            if name == "route1_bench":
                planes = torch.empty((3 + max(nw, 1),) + tuple(b.shape),
                                     dtype=torch.int32, device=b.device)
                dst = torch.empty_like(b)
                res["fill_ms"] = cs.cuda_ms(lambda: planes.fill_(-1), REPS)
                res["copy_bytes_ms"] = cs.cuda_ms(lambda: dst.copy_(b), REPS)
                cs.log(f"[ab] yardsticks at {tuple(b.shape)}: fill_(-1) of "
                       f"{tuple(planes.shape)} int32 {res['fill_ms']:.5f} ms, "
                       f"copy of the bytes {res['copy_bytes_ms']:.5f} ms")
        res["stage1_compact"] = rows

    if "stage1_fused" in kernels:
        texts = batches["route1_bench"]
        enc = tok._get_packed_encoder(texts)
        buf, lens = enc.pack(texts)
        with cs.Capture(packed_mod, "stage1_fused") as cap:
            enc._encode_buffer(buf, lens, len(texts), None)
        args = cap.calls[0][0]
        want = stage1_mod.stage1_fused_reference(*args)
        fns = {}
        for who, mod in (("other", o_mod["stage1"]), ("this", stage1_mod)):
            fn = mod.stage1_fused
            cs.check_equal(f"{who} stage1_fused", fn(*args), want)
            fns[who] = (lambda fn=fn: fn(*args))
        res["stage1_fused"] = turns(
            f"stage1_fused {tuple(args[0].shape)} n_words={args[2]}",
            fns["other"], fns["this"])
        planes = torch.empty((len(want),) + tuple(args[0].shape),
                             dtype=torch.int32, device=args[0].device)
        res["stage1_fused"]["fill_ms"] = cs.cuda_ms(lambda: planes.fill_(0),
                                                    REPS)
        cs.log(f"[ab] yardstick: fill_(0) of stage1_fused's "
               f"{tuple(planes.shape)} int32 planes "
               f"{res['stage1_fused']['fill_ms']:.5f} ms")

    if "merge" in kernels:
        res["merge"] = merge_turns(cs, tok, batches, packed_mod, other)

    if "decode_store" in kernels:
        ids = [[tok.bos_id()] + x + [tok.eos_id()]
               for x in tok.encode_batch(batches["route1_bench"])]
        with cs.Capture(decode_mod, "decode_bytes_compact") as cap:
            tok.decode_batch(ids, SpecialTokenPolicy.IGNORE)
        args = cap.calls[0][0]
        want, total = decode_mod.decode_bytes_compact_reference(*args)
        fns = {}
        for who, mod in (("other", o_mod["decode"]), ("this", decode_mod)):
            fn = mod.decode_bytes_compact
            got, got_total = fn(*args)
            if not torch.equal(got, want) or int(got_total) != int(total):
                raise AssertionError(f"{who} decode store differs from the "
                                     f"plain version")
            fns[who] = (lambda fn=fn: fn(*args))
        row = turns(f"decode_store T={args[0].shape[0]} n={args[1]}",
                    fns["other"], fns["this"])
        row.update({f"{who}_device_ms": cs.device_ms(fn, "decode_store")
                    for who, fn in fns.items()})
        cs.log(f"[ab] decode_store device time: other "
               f"{row['other_device_ms']:.5f} ms, this "
               f"{row['this_device_ms']:.5f} ms")
        res["decode_store"] = row

    print(smi)
    print(json.dumps(res))


if __name__ == "__main__":
    main(sys.argv[1:])
