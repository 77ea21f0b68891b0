"""The port's examples: the counterparts of the repo's ``examples/*.py``,
run as modules on the card (``cuda``, ``cuda:LOCAL_RANK`` under
``torchrun``) or, with ``--device cpu``, on the kernels' plain versions.

    python -m tekken_tpu_torch.examples.basic_tokenizer_test [tekken.json] [--device cpu]
    python -m tekken_tpu_torch.examples.basic_usage [tekken.json] [--device cpu]
    python -m tekken_tpu_torch.examples.detailed_test [tekken.json] [--device cpu]
    python -m tekken_tpu_torch.examples.audio_tokenization_test [audio.wav] [--device cpu]
    python -m tekken_tpu_torch.examples.distributed_corpus [--device cpu]
    torchrun --nproc_per_node=N -m tekken_tpu_torch.examples.distributed_corpus

Each prints the ids and texts its JAX counterpart prints, on the same
synthetic tokenizer when no ``tekken.json`` is found.
"""

import argparse


def parse(doc: str, prog: str, argv, path: str = "tekken.json",
          path_help: str = "a tekken.json model file"):
    """The examples' arguments: an optional file ``path`` and ``--device``
    (``cuda`` by default)."""
    p = argparse.ArgumentParser(prog=f"python -m tekken_tpu_torch.examples."
                                f"{prog}", description=doc.split("\n\n")[0])
    p.add_argument("path", nargs="?", default=path, help=path_help)
    p.add_argument("--device", default="cuda", help='"cuda" or "cpu"')
    return p.parse_args(argv)
