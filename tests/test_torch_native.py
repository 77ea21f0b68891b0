"""PyTorch port: the native C++ host engine (native/) equals the JAX
package's engine and the oracle call for call, builds into the port's own
directory, raises when it cannot build, and is wired where the JAX package
wires it: ``Tekkenizer.encode``, host-mode ``PackedEncoder``, the
overflow-row re-encode and ``DistributedEncoder`` (the 2-rank gloo case is
in tests/test_torch_parallel.py)."""

import os
import pathlib

import numpy as np
import pytest

import tekken_tpu_torch as tt
from tekken_tpu_torch.native import NativeEncoder
from tekken_tpu_torch.native import build as nbuild
from tekken_tpu_torch.native import engine as nengine
from test_torch_tekkenizer import TEXTS

REPO = pathlib.Path(__file__).resolve().parents[1]

# what the random strings are made of: ASCII words, whitespace runs,
# digits, contractions, punctuation, accents, CJK and emoji
PARTS = ["the", "word", "Hello", "x", "quick", " ", "  ", "   ", "\t", "\n",
         "\r\n", " \t ", "\n\n", "1", "42", "12345", "'s", "'ll", "'VE",
         "don't", ".", ",!?", "...", "café", "naïve", "über", "ſ", "中文",
         "日本語", "한국어", "\U0001f600", "\U0001f680\U0001f389", "Ω", "٣"]


def random_texts(seed, n=200):
    g = np.random.default_rng(seed)
    return ["".join(PARTS[k] for k in g.integers(0, len(PARTS),
                                                  g.integers(0, 60)))
            for _ in range(n)]


def _port(tok, **kw):
    md = tt.ModelData.from_json(tok.to_model_data().to_json())
    return tt.Tekkenizer.from_model_data(md, device="cpu", **kw)


@pytest.fixture(scope="module", params=["small_tokenizer", "merged_tokenizer"])
def engines(request):
    """(JAX tokenizer, port tokenizer, port engine, JAX engine)."""
    from tekken_tpu.native import NativeEncoder as JNative

    tok = request.getfixturevalue(request.param)
    port = _port(tok)
    return tok, port, NativeEncoder(port), JNative(tok)


def test_encode_matches_jax_engine_and_oracle(engines):
    from tekken_tpu.oracle import encode_ranks

    tok, _, ne, je = engines
    texts = TEXTS + random_texts(1)
    want = [encode_ranks(t, tok.ranks) for t in texts]
    assert [ne.encode(t) for t in texts] == want
    assert [je.encode(t) for t in texts] == want
    one = ne.encode_batch(texts, n_threads=1)
    assert one == want
    assert ne.encode_batch(texts, n_threads=4) == one
    assert je.encode_batch(texts, n_threads=4) == one
    assert ne.encode_batch(["", ""]) == [[], []]


def test_merge_spans_matches_jax_engine_and_oracle(engines):
    from tekken_tpu.ops.packed import oracle_merge_fn

    tok, _, ne, je = engines
    g = np.random.default_rng(2)
    buf = np.frombuffer("".join(random_texts(3, 50)).encode(), np.uint8)
    n = 300
    lens = g.integers(1, 24, n).astype(np.int32)
    starts = g.integers(0, buf.size - 24, n).astype(np.int32)
    got_t, got_c = ne.merge_spans(buf, starts, lens)
    assert got_t.dtype == got_c.dtype == np.int32
    for want_t, want_c in (je.merge_spans(buf, starts, lens),
                           oracle_merge_fn(tok.ranks)(buf, starts, lens)):
        assert np.array_equal(got_t, want_t)
        assert np.array_equal(got_c, want_c)
    assert int(got_c.sum()) == got_t.size
    empty = ne.merge_spans(buf, starts[:0], lens[:0])
    assert empty[0].size == empty[1].size == 0
    with pytest.raises(ValueError, match="outside the buffer"):
        ne.merge_spans(buf, np.array([buf.size - 2]), np.array([5]))


def test_decode_ranks_matches_jax_engine(engines):
    from tekken_tpu.oracle import decode_bytes

    tok, _, ne, je = engines
    n_ranks = len(tok.decode_table.offsets) - 1
    ranks = np.random.default_rng(4).integers(0, n_ranks, 5000,
                                               dtype=np.int32)
    got = ne.decode_ranks(ranks)
    assert got == je.decode_ranks(ranks) == decode_bytes(ranks,
                                                          tok.decode_table)
    assert ne.decode_ranks(np.zeros(0, np.int32)) == b""
    for bad in (-1, n_ranks):
        with pytest.raises(ValueError, match="out of range"):
            ne.decode_ranks(np.array([0, bad], np.int32))


def test_library_lands_in_the_port_build_dir(engines):
    """g++ writes the port's library under tekken_tpu_torch/_build/ (a
    name keyed on the source), never into the JAX package."""
    path = nbuild.lib_path()
    assert os.path.dirname(path) == str(REPO / "tekken_tpu_torch" / "_build")
    assert os.path.basename(path).startswith("libtekken_native-")
    assert os.path.exists(path)
    assert nengine._LIB._name == path
    assert not path.startswith(str(REPO / "tekken_tpu" / "native"))


def test_failed_build_raises_and_never_falls_back(merged_tokenizer,
                                                  monkeypatch, tmp_path):
    """A source g++ refuses: the build raises with g++'s message, and the
    tokenizer's encode raises with it instead of serving the oracle."""
    bad = tmp_path / "engine.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(nbuild, "SRC", str(bad))
    monkeypatch.setattr(nbuild, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(nengine, "_LIB", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error:"):
        nbuild.build()
    port = _port(merged_tokenizer)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        port.encode("hello", False, False)
    assert port.engine_used is None
    assert not list((tmp_path / "build").glob("*.so"))


def test_engine_used_and_native_off(merged_tokenizer):
    """encode goes through the native engine ("native-host"); with
    native=False through the oracle ("host-oracle"), with the same ids;
    encode_batch and decode_batch name their device engines."""
    port = _port(merged_tokenizer)
    oracle = _port(merged_tokenizer, native=False)
    assert port.engine_used is None
    for t in TEXTS:
        want = merged_tokenizer.encode(t, True, True)
        assert port.encode(t, True, True) == want
        assert port.engine_used == "native-host"
        assert oracle.encode(t, True, True) == want
        assert oracle.engine_used == "host-oracle"
    assert oracle._get_native_encoder() is None
    assert isinstance(port._get_native_encoder(), NativeEncoder)
    ids = port.encode_batch(TEXTS)
    assert port.engine_used == "packed-device"
    port.decode_batch(ids, tt.SpecialTokenPolicy.IGNORE)
    assert port.engine_used == "device-decode"


class _Spy:
    """Counts the calls of one method of an object and forwards them."""

    def __init__(self, monkeypatch, obj, name):
        self.calls = 0
        real = getattr(obj, name)

        def spy(*a, **kw):
            self.calls += 1
            return real(*a, **kw)
        monkeypatch.setattr(obj, name, spy)


def _jax_ranks(tok, texts):
    """The JAX package's encode of each text, as engine ranks."""
    ns = tok.num_special_tokens()
    return [[i - ns for i in tok.encode(t, False, False)] for t in texts]


def _miss_texts(n):
    """Docs whose words are mostly vocabulary misses (host-mode spans)."""
    g = np.random.default_rng(5)
    letters = list("qzxjvkwy")
    return [" ".join("".join(g.choice(letters, g.integers(2, 9)))
                     for _ in range(20)) for _ in range(n)]


@pytest.mark.parametrize("merge", ["host", "device"])
def test_packed_encoder_uses_the_native_engine(merged_tokenizer, monkeypatch,
                                               merge):
    """Host mode merges its spans with merge_spans (device mode merges its
    misses over 32 bytes, the 300-byte piece of TEXTS, with the oracle);
    overflow rows (a capacity of 4 spans or bucket rows) are re-encoded by
    the native engine; every doc equals the JAX package's."""
    from tekken_tpu_torch.ops.packed import PackedEncoder

    port = _port(merged_tokenizer)
    native = port._get_native_encoder()
    spans = _Spy(monkeypatch, native, "merge_spans")
    encodes = _Spy(monkeypatch, native, "encode")
    texts = _miss_texts(6) + TEXTS
    want = _jax_ranks(merged_tokenizer, texts)
    enc = PackedEncoder(port, rows=16, row_len=512, device="cpu",
                        merge=merge)
    assert (enc._merge_fn is native.merge_spans) == (merge == "host")
    assert enc.encode_batch(texts) == want
    assert enc.stats["fb_spans"] > 0 and enc.stats["overflow_rows"] == 0
    # the 9-byte misses (" " and 8 letters) merge on the device
    assert (enc.stats["device_long_rows"] > 0) == (merge == "device")
    assert (spans.calls > 0) == (merge == "host")
    assert encodes.calls == 0
    small = PackedEncoder(port, rows=16, row_len=512, device="cpu",
                          merge=merge, np_cap=4)
    assert small.encode_batch(texts) == want
    assert small.stats["overflow_rows"] > 0
    assert encodes.calls == small.stats["overflow_rows"]


@pytest.mark.parametrize("merge", ["host", "device"])
def test_distributed_encoder_uses_the_native_engine(merged_tokenizer,
                                                    monkeypatch, merge):
    """A world-of-one DistributedEncoder merges its spans with merge_spans
    in both modes (as the JAX package's does) and re-encodes overflow rows
    with the native engine; every doc equals the JAX package's."""
    from tekken_tpu_torch.parallel.encode import DistributedEncoder
    from tekken_tpu_torch.parallel.mesh import make_dp_mesh

    port = _port(merged_tokenizer)
    native = port._get_native_encoder()
    texts = _miss_texts(6) + ["x" * 40 + " " + "q" * 12] + TEXTS[:5]
    want = _jax_ranks(merged_tokenizer, texts)
    spans = _Spy(monkeypatch, native, "merge_spans")
    encodes = _Spy(monkeypatch, native, "encode")
    enc = DistributedEncoder(port, mesh=make_dp_mesh(device="cpu"), rows=16,
                             row_len=512, merge=merge, np_cap=8)
    docs, n_bytes, n_tokens = enc.encode_batch(texts)
    assert docs == want
    assert n_tokens == sum(len(d) for d in want)
    assert spans.calls >= 1
    assert enc.last_overflow_rows > 0
    assert encodes.calls == enc.last_overflow_rows
