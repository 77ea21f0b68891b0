"""What the entries share on the program's side: the tokenizer built
from the benchmark's token bytes, the device's peak memory, the card's
power limit and the host spans of a traced stretch."""

from __future__ import annotations

import base64
import contextlib
import functools
import subprocess
import sys

import torch


def tokenizer(cfg: dict, token_bytes: list, device):
    """The port's Tekkenizer over the benchmark's ranks, the deprecated
    specials and the configuration's widths."""
    import tekken_tpu_torch as tt
    from tekken_tpu_torch.special_tokens import get_deprecated_special_tokens

    vocab = [tt.TokenInfo(rank=r, token_bytes=base64.b64encode(t).decode(),
                          token_str=None)
             for r, t in enumerate(token_bytes)]
    tok = tt.Tekkenizer(
        vocab=vocab, special_tokens=get_deprecated_special_tokens(),
        pattern="", vocab_size=cfg["default_vocab_size"],
        num_special_tokens=cfg["default_num_special_tokens"],
        version=tt.TokenizerVersion.V7, device=device)
    if (tok.bos_id(), tok.eos_id()) != (cfg["bos_id"], cfg["eos_id"]):
        raise ValueError("the program's BOS/EOS ids differ from the "
                         "configuration's")
    return tok


def build_kernels(device) -> None:
    """Every kernel built (or found in the program's build cache)."""
    if torch.device(device).type == "cuda":
        from tekken_tpu_torch import _build

        _build.build()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The device's peak allocated memory so far (0 on the CPU)."""
    sync(device)
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def launches() -> dict:
    """The program's kernel launch counter (by kernel name)."""
    from tekken_tpu_torch import _build

    return _build.LAUNCHES


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"not read ({out.stderr.strip()})"


@contextlib.contextmanager
def host_spans(targets):
    """Wrap each (owner, attribute) in a ``record_function`` range named
    after it while the block runs, so that the trace can say what the
    host did while the device idled; the originals come back after."""
    from torch.profiler import record_function

    saved = []
    for owner, attr in targets:
        fn = owner.__dict__[attr]
        label = f"{owner.__name__}.{attr}"

        def wrap(fn=fn, label=label):
            @functools.wraps(fn)
            def spanned(*a, **kw):
                with record_function(label):
                    return fn(*a, **kw)
            return spanned
        setattr(owner, attr, wrap())
        saved.append((owner, attr, fn))
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def note(*a) -> None:
    """A line for the log: stderr, never the result's stdout."""
    print(*a, file=sys.stderr, flush=True)
