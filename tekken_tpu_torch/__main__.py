"""Command-line interface of the PyTorch port (the JAX package's, with one
more flag, ``--device``).

    python -m tekken_tpu_torch encode  --model tekken.json [--bos] [--eos] TEXT...
    python -m tekken_tpu_torch decode  --model tekken.json --policy keep ID...
    python -m tekken_tpu_torch info    --model tekken.json
    python -m tekken_tpu_torch validate --model tekken.json
    python -m tekken_tpu_torch encode-file --model tekken.json FILE [--engine ...]

Every subcommand takes ``--device cuda|cpu`` (default cuda): the device of
``encode --engine device`` and ``encode-file --engine auto|device``.
``--engine oracle`` encodes on the host with the oracle, ``auto`` (in
``encode``) and ``native`` with the native engine.  ``validate`` runs
``tools.validate_model``: the oracle, the host engine, ``encode_batch``
on the device and the native engine against each other on six probes.
"""

from __future__ import annotations

import argparse
import json
import sys


def _policy(name: str):
    from .special_tokens import SpecialTokenPolicy
    return {"keep": SpecialTokenPolicy.KEEP,
            "ignore": SpecialTokenPolicy.IGNORE,
            "raise": SpecialTokenPolicy.RAISE}[name]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tekken-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def command(name, help_):
        sp = sub.add_parser(name, help=help_)
        sp.add_argument("--model", required=True)
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
        return sp

    pe = command("encode", "encode text arguments to token ids")
    pe.add_argument("--bos", action="store_true")
    pe.add_argument("--eos", action="store_true")
    pe.add_argument("--engine", choices=["auto", "oracle", "device"],
                    default="auto")
    pe.add_argument("text", nargs="+")

    pd = command("decode", "decode token ids to text")
    pd.add_argument("--policy", choices=["keep", "ignore", "raise"],
                    default="ignore")
    pd.add_argument("ids", nargs="+", type=int)

    command("info", "print model metadata")
    command("validate", "run model-file self checks")

    pf = command("encode-file", "encode a text file (one doc per line) and "
                 "print JSONL of id lists")
    pf.add_argument("--engine", choices=["auto", "device", "native",
                                         "oracle"], default="auto")
    pf.add_argument("file")

    args = p.parse_args(argv)

    if args.cmd == "validate":
        from .tools import validate_model
        return validate_model.main([args.model, "--device", args.device])

    from .tekkenizer import Tekkenizer
    # --engine oracle: the host engine is the oracle, not the native one
    tok = Tekkenizer.from_file(args.model, device=args.device,
                               native=getattr(args, "engine", "") != "oracle")

    if args.cmd == "encode":
        if args.engine == "device":
            out = tok.encode_batch(args.text,
                                   add_beginning_of_sequence=args.bos,
                                   add_end_of_sequence=args.eos)
        else:
            out = [tok.encode(t, args.bos, args.eos) for t in args.text]
        for ids in out:
            print(json.dumps(ids))
        return 0

    if args.cmd == "decode":
        print(tok.decode(args.ids, _policy(args.policy)))
        return 0

    if args.cmd == "info":
        print(json.dumps({
            "vocab_size": tok.vocab_size(),
            "num_special_tokens": tok.num_special_tokens(),
            "version": tok.version().as_str(),
            "audio": tok.has_audio_support(),
            "bos_id": tok.bos_id(),
            "eos_id": tok.eos_id(),
        }, indent=2))
        return 0

    # encode-file
    with open(args.file, encoding="utf-8") as f:
        lines = [ln.rstrip("\n") for ln in f]
    if args.engine == "native":
        from .native import NativeEncoder
        ne = NativeEncoder(tok)
        shift = tok.num_special_tokens()
        out = [[r + shift for r in ranks] for ranks in ne.encode_batch(lines)]
    elif args.engine == "oracle":
        out = [tok.encode(ln, False, False) for ln in lines]
    else:
        out = tok.encode_batch(lines)
    for ids in out:
        print(json.dumps(ids))
    return 0


if __name__ == "__main__":
    sys.exit(main())
