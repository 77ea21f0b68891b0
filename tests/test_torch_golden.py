"""PyTorch port: the golden corpora.

``tests/golden/synthetic_v1.json`` (400 merges, 20 specials, committed
ids with BOS/EOS) through each of the port's engines on the CPU: the
oracle (``native=False``), ``encode`` with the native engine,
``encode_batch``, ``PackedEncoder``, ``FlatEncoder``, and the decode round
trip under IGNORE.  The V7 goldens (the counterparts of
``tests/test_v7_golden.py``) need the real 131k-entry ``tekken.json``,
named by ``TEKKEN_JSON``, and skip without it, as the JAX tests do.
"""

import json
import os

import pytest

import tekken_tpu_torch as tt
from tekken_tpu_torch.models import build_synthetic_model_data
from tekken_tpu_torch.ops.flat import FlatEncoder
from tekken_tpu_torch.ops.packed import PackedEncoder

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "golden", "synthetic_v1.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def _tok(golden, **kw):
    cfg = golden["tokenizer"]
    md = build_synthetic_model_data(
        num_merges=cfg["num_merges"],
        num_special_tokens=cfg["num_special_tokens"])
    return tt.Tekkenizer.from_model_data(md, device="cpu", **kw)


@pytest.fixture(scope="module")
def tok(golden):
    return _tok(golden)


def _full(tok, ranks):
    shift = tok.num_special_tokens()
    return [tok.bos_id()] + [r + shift for r in ranks] + [tok.eos_id()]


def test_oracle_engine_matches_golden(golden):
    tok = _tok(golden, native=False)
    for e in golden["entries"]:
        assert tok.encode(e["text"], True, True) == e["ids"], repr(e["text"])
    assert tok.engine_used == "host-oracle"


def test_native_engine_matches_golden(tok, golden):
    for e in golden["entries"]:
        assert tok.encode(e["text"], True, True) == e["ids"], repr(e["text"])
    assert tok.engine_used == "native-host"


def test_device_path_matches_golden(tok, golden):
    texts = [e["text"] for e in golden["entries"]]
    got = tok.encode_batch(texts, add_beginning_of_sequence=True,
                           add_end_of_sequence=True)
    assert got == [e["ids"] for e in golden["entries"]]


@pytest.mark.parametrize("engine", [PackedEncoder, FlatEncoder])
def test_packed_and_flat_engines_match_golden(tok, golden, engine):
    enc = engine(tok, rows=len(golden["entries"]), row_len=256,
                 device="cpu")
    got = enc.encode_batch([e["text"] for e in golden["entries"]])
    for e, g in zip(golden["entries"], got):
        assert _full(tok, g) == e["ids"], repr(e["text"])


def test_golden_decode_round_trip(tok, golden):
    for e in golden["entries"]:
        assert tok.decode(e["ids"], tt.SpecialTokenPolicy.IGNORE) == e["text"]


# --------------------------------------------------------------------- #
# the V7 goldens (reference: tests/test_tokenizer_output.rs;
# tests/test_rust_tokenizer.rs), gated on a real model file
# --------------------------------------------------------------------- #

TEKKEN_JSON = os.environ.get("TEKKEN_JSON", "")

v7_only = pytest.mark.skipif(
    not (TEKKEN_JSON and os.path.exists(TEKKEN_JSON)),
    reason="real V7 tekken.json not available (set TEKKEN_JSON)")

# (input, expected ids) — reference: tests/test_tokenizer_output.rs
GOLDEN_V7 = [
    ("Hello, world!", [22177, 1044, 4304, 1033]),
    ("The quick brown fox jumps over the lazy dog.",
     [1784, 7586, 22980, 94137, 72993, 2136, 1278, 42757, 10575, 1046]),
    ("This is a test of the Mistral Tekken tokenizer.",
     [4380, 1395, 1261, 2688, 1307, 1278, 42301, 2784, 47213, 3569,
      128405, 1046]),
    ("Emojis and unicode characters work too!",
     [5969, 3659, 1275, 1321, 79219, 11084, 2196, 4382, 1033]),
    ("Hello", [22177]),
    ("world", [34049]),
    ("test", [4417]),
    ("a", [1097]),
    ("the", [3265]),
    ("Python", [46728]),
    ("Rust", [1082, 1616]),
    ("tokenizer", [15017, 7463]),
    ("encoding", [47130]),
    ("decoding", [18888, 7967]),
    ("comparison", [69959, 3693]),
    ("Simple sentence.", [28683, 19286, 1046]),
    ("Another test case with numbers: 123, 456, 789.",
     [18661, 2688, 2937, 1454, 8091, 1058, 1032, 1049, 1050, 1051, 1044,
      1032, 1052, 1053, 1054, 1044, 1032, 1055, 1056, 1057, 1046]),
    ("Special characters: @#$%^&*()_+-={}[]|\\:;\"'<>,.?/",
     [40124, 11084, 1058, 2126, 1035, 1036, 1037, 1094, 1038, 1042, 1690,
      1095, 104799, 3181, 1125, 4344, 17743, 1058, 36211, 96726, 24482,
      1046, 1063, 1047]),
    ("Mixed CaSe WoRdS", [1077, 5422, 10645, 3201, 18739, 1082, 1100, 1083]),
    ("   whitespace   handling   ", [1256, 81024, 1256, 21490, 1293]),
]


@pytest.fixture(scope="module")
def v7():
    return tt.Tekkenizer.from_file(TEKKEN_JSON, device="cpu")


@v7_only
def test_v7_metadata(v7):
    assert v7.vocab_size() == 131072
    assert v7.version() is tt.TokenizerVersion.V7
    assert v7.num_special_tokens() == 1000


@v7_only
@pytest.mark.parametrize("text,expected", GOLDEN_V7,
                         ids=[t[:20] for t, _ in GOLDEN_V7])
def test_v7_golden_oracle(v7, text, expected):
    tokens = v7.encode(text, False, False)
    assert tokens == expected
    assert v7.decode(tokens, tt.SpecialTokenPolicy.IGNORE) == text


@v7_only
@pytest.mark.parametrize("text,expected", GOLDEN_V7[:6],
                         ids=[t[:20] for t, _ in GOLDEN_V7[:6]])
def test_v7_golden_device_path(v7, text, expected):
    assert v7.encode_batch([text])[0] == expected


@v7_only
def test_v7_golden_jfk_decode(v7):
    # reference: tests/test_rust_tokenizer.rs:16-19,80
    ids = [4998, 1878, 1044, 2036, 20574, 20999, 1044, 4237, 1605, 2549,
           2143, 6816, 1710, 1653, 1394, 1636, 1044, 4237, 2549, 1636, 1710,
           1653, 1394, 2143, 6816, 1046, 2]
    text = v7.decode(ids, tt.SpecialTokenPolicy.IGNORE)
    assert text == ("And so, my fellow Americans, ask not what your country "
                    "can do for you, ask what you can do for your country.")
    joined = "".join(v7.id_to_piece(t) for t in ids[:-1])
    assert v7.decode(ids[:-1], tt.SpecialTokenPolicy.IGNORE) == joined


def test_v7_goldens_are_the_jax_tests():
    """The V7 vectors are test_v7_golden.py's, entry for entry."""
    import test_v7_golden

    assert GOLDEN_V7 == test_v7_golden.GOLDEN
