"""PyTorch port: ``python -m tekken_tpu_torch`` prints what ``python -m
tekken_tpu`` prints, subcommand by subcommand and engine by engine, on a
model file that the ``merged_tokenizer`` fixture saves.  The port runs
with ``--device cpu``.

The JAX package compiles its device encode once here: every line that
reaches it (``--engine device``, ``encode-file`` auto/device) is simple
ASCII of at most 256 bytes, 8 lines at most, so it runs as route 1 at
(8, 256).
"""

import pytest

from tekken_tpu_torch.__main__ import main

ASCII = ["hello world the quick brown fox", "it's a test of tokenization",
         "numbers 12 and 345 here.", "don't we've I'm you'll x",
         "qzxj vkwy wordy words", "", "end."]
MIXED = ["Hello, World!", "it's 12345 café 中文 \U0001f600", "  \n\t x",
         "tabs\t\tand   runs", "naïve über ſ 日本語 한국어", "a" * 300]

CASES = {
    "encode-auto": ["encode", "--model", "{model}", "--bos", "--eos",
                    *MIXED[:3]],
    "encode-oracle": ["encode", "--model", "{model}", "--engine", "oracle",
                      *MIXED],
    "encode-device": ["encode", "--model", "{model}", "--engine", "device",
                      "--eos", *ASCII[:3]],
    "decode-keep": ["decode", "--model", "{model}", "--policy", "keep",
                    "1", "300", "301", "72", "2", "5"],
    "decode-ignore": ["decode", "--model", "{model}", "1", "300", "301",
                      "72", "2"],
    "decode-raise": ["decode", "--model", "{model}", "--policy", "raise",
                     "300", "72", "301"],
    "info": ["info", "--model", "{model}"],
    "validate": ["validate", "--model", "{model}"],
    "file-auto": ["encode-file", "--model", "{model}", "{ascii}"],
    "file-device": ["encode-file", "--model", "{model}", "--engine",
                    "device", "{ascii}"],
    "file-native": ["encode-file", "--model", "{model}", "--engine",
                    "native", "{mixed}"],
    "file-oracle": ["encode-file", "--model", "{model}", "--engine",
                    "oracle", "{mixed}"],
}


@pytest.fixture(scope="module")
def paths(merged_tokenizer, tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    merged_tokenizer.save(root / "tekken.json")
    for name, lines in (("ascii", ASCII), ("mixed", MIXED)):
        (root / f"{name}.txt").write_text("\n".join(lines) + "\n",
                                          encoding="utf-8")
    return {"model": str(root / "tekken.json"),
            "ascii": str(root / "ascii.txt"),
            "mixed": str(root / "mixed.txt")}


def _stdout(fn, argv, capfd):
    capfd.readouterr()
    rc = fn(argv)
    return rc, capfd.readouterr().out


@pytest.mark.parametrize("case", list(CASES))
def test_cli_prints_what_jax_prints(paths, case, capfd):
    """``validate``: the JAX CLI runs tools/validate_model.py in a
    subprocess (captured at the file descriptor), the port its
    tools.validate_model in process."""
    from tekken_tpu.__main__ import main as jax_main

    argv = [a.format(**paths) for a in CASES[case]]
    want = _stdout(jax_main, argv, capfd)
    got = _stdout(main, argv + ["--device", "cpu"], capfd)
    assert got == want
    assert got[0] == 0 and got[1]
    if case.startswith("file-"):         # one JSON line a line of the file
        with open(argv[-1], encoding="utf-8") as f:
            assert len(got[1].splitlines()) == f.read().count("\n")


def test_cli_refusals(paths, capsys):
    """Unknown engine and device choices exit as argparse does; a special
    token under --policy raise raises the port's SpecialTokenPolicyError."""
    import tekken_tpu_torch as tt

    for bad in (["encode-file", "--model", paths["model"], "--engine", "x",
                 paths["ascii"]],
                ["info", "--model", paths["model"], "--device", "tpu"]):
        with pytest.raises(SystemExit) as e:
            main(bad)
        assert e.value.code == 2
    with pytest.raises(tt.SpecialTokenPolicyError):
        main(["decode", "--model", paths["model"], "--policy", "raise", "1",
              "300", "--device", "cpu"])
