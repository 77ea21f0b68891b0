"""PyTorch port: the Tekkenizer's host surface (construction, from_file,
encode, decode, id helpers) equals the JAX package's, and the port keeps
its package boundary: no import of jax or of the JAX package."""

import pathlib
import re

import pytest

import tekken_tpu_torch as tt
from tekken_tpu.special_tokens import SpecialTokenPolicy as JPolicy
from tekken_tpu_torch.special_tokens import SpecialTokenPolicy

REPO = pathlib.Path(__file__).resolve().parents[1]

TEXTS = ["Hello, World!", "it's 12345 café 中文 \U0001f600", "", "  \n\t x",
         "don't we've I'm you'll", "a" * 300]


def _port(tok, tmp_path=None):
    if tmp_path is None:
        md = tt.ModelData.from_json(tok.to_model_data().to_json())
        return tt.Tekkenizer.from_model_data(md, device="cpu")
    path = tmp_path / "tekken.json"
    tok.save(path)
    return tt.Tekkenizer.from_file(path, device="cpu")


@pytest.mark.parametrize("name", ["small_tokenizer", "merged_tokenizer",
                                  "audio_tokenizer"])
def test_host_surface_matches_jax(request, tmp_path, name):
    tok = request.getfixturevalue(name)
    port = _port(tok, tmp_path)
    assert port.vocab_size() == tok.vocab_size()
    assert port.num_special_tokens() == tok.num_special_tokens()
    assert port.version().as_str() == tok.version().as_str()
    assert port.vocab() == tok.vocab()
    assert (port.bos_id(), port.eos_id()) == (tok.bos_id(), tok.eos_id())
    assert port.has_audio_support() == tok.has_audio_support()
    for t in TEXTS:
        ids = tok.encode(t, True, True)
        assert port.encode(t, True, True) == ids
        for pol in ("KEEP", "IGNORE"):
            assert port.decode(ids, SpecialTokenPolicy[pol]) == \
                tok.decode(ids, JPolicy[pol])
            assert port.decode_all(ids, SpecialTokenPolicy[pol]) == \
                tok.decode_all(ids, JPolicy[pol])
    for i in (0, 1, tok.num_special_tokens(), tok.vocab_size() - 1):
        assert port.id_to_piece(i) == tok.id_to_piece(i)
        assert port.id_to_byte_piece(i, SpecialTokenPolicy.KEEP) == \
            tok.id_to_byte_piece(i, JPolicy.KEEP)
    assert port.to_model_data().to_json() == tok.to_model_data().to_json()


def test_errors_and_unported_surface(merged_tokenizer):
    port = _port(merged_tokenizer)
    with pytest.raises(tt.SpecialTokenPolicyError):
        port.decode([port.bos_id()], SpecialTokenPolicy.RAISE)
    with pytest.raises(tt.TokenNotFoundError):
        port.get_control_token("[NOPE]")
    # decode_batch raises as decode does (tests/test_torch_decode.py)
    with pytest.raises(tt.SpecialTokenPolicyError):
        port.decode_batch([[port.bos_id()]], SpecialTokenPolicy.RAISE)
    with pytest.raises(tt.TokenizersError, match="Invalid token id"):
        port.decode_batch([[port.vocab_size() + 1]], SpecialTokenPolicy.KEEP)
    # no audio config: encode_audio raises as the JAX package's does
    with pytest.raises(tt.AudioError, match="not configured"):
        port.encode_audio(tt.Audio.new([0.0] * 100, 16000))


def test_oversize_doc_matches_jax(merged_tokenizer, monkeypatch):
    """A doc longer than an 8-row buffer's row (MAX_BATCH_BYTES / 8, here
    patched down to 512 bytes) is cut at piece-safe points: its segments
    run as rows of the same encode_batch call, the pieces that cannot be
    cut are merged on the host, and the ids equal the JAX package's for
    the same texts, BOS and EOS on.  The JAX side is its ``encode``: its
    encode_batch gives the same ids but compiles for ~80 s on the CPU at
    a 4096-byte row."""
    import random

    import tekken_tpu_torch.tekkenizer as ttk
    from tekken_tpu_torch.ops.packed import piece_safe_segments

    port = _port(merged_tokenizer)
    monkeypatch.setattr(ttk, "MAX_BATCH_BYTES", 4096)
    rng = random.Random(8)
    words = [w for t in TEXTS for w in t.split()] + ["hello", "world"]
    runs = ["  ", "\t", " \t ", "\n\n"]
    prose = "".join(rng.choice(words) + (rng.choice(runs) if rng.random()
                                          < 0.2 else " ")
                    for _ in range(500))[:3000]
    texts = [
        prose,                                         # segments only
        "one piece " + "q" * 600 + " then words",      # a 600-byte piece
        "cut " + "!\n" * 300 + " here",                 # 600 bytes, no safe cut
        "short doc",
    ]
    kinds = [{k for k, _ in piece_safe_segments(t, 512)} for t in texts[:3]]
    assert kinds == [{"d"}, {"d", "h"}, {"d", "hp"}]
    assert len(texts[0].encode()) >= 2900
    got = port.encode_batch(texts, True, True)
    assert port.engine_used == "packed-device"
    assert got == [merged_tokenizer.encode(t, True, True) for t in texts]


def test_general_ascii_rows_past_the_general_bound(merged_tokenizer):
    """A general-ASCII doc (whitespace runs, long digit runs) longer than
    the general rules' 8192-byte row bound runs on the byte-level rules of
    the UTF-8 route, and its ids equal the JAX package's encode (the JAX
    device path refuses such rows and serves the host engine)."""
    port = _port(merged_tokenizer)
    doc = ("it's  12345678 words\t\tand  runs " * 300)[:9500]
    texts = [doc, "Hello, World!", "two  spaces"]
    assert port.encode_batch(texts) == [merged_tokenizer.encode(t, False,
                                                                False)
                                        for t in texts]
    assert port.engine_used == "packed-device"


def test_oversize_batch_splits_into_row_batches(merged_tokenizer,
                                                monkeypatch):
    """A batch whose buffer would exceed MAX_BATCH_BYTES (here patched to
    4096) runs as consecutive row sub-batches on the device, and returns
    what the JAX package returns for a batch over its cap: the oracle's
    ids, in input order."""
    import tekken_tpu_torch.tekkenizer as ttk
    from tekken_tpu.oracle import encode_ranks

    port = _port(merged_tokenizer)
    monkeypatch.setattr(ttk, "MAX_BATCH_BYTES", 4096)
    texts = [((t + " ") * (i % 7 + 1))[:120]
             for i, t in enumerate(TEXTS * 4)]
    texts.append("y" * 512)
    assert max(len(t.encode()) for t in texts) == 512   # 8-row sub-batches
    shapes = []
    real = port._get_packed_encoder
    monkeypatch.setattr(port, "_get_packed_encoder",
                        lambda sub: shapes.append(len(sub)) or real(sub))
    got = port.encode_batch(texts, True, True)
    ns = merged_tokenizer.num_special_tokens()
    want = [[port.bos_id()] + [r + ns for r in encode_ranks(t, port.ranks)]
            + [port.eos_id()] for t in texts]
    assert got == want
    assert shapes == [8, 8, 8, 1]
    # one 513-byte piece: no device row holds it, the host merges it
    assert port.encode_batch(["z" * 513]) == [
        [r + ns for r in encode_ranks("z" * 513, port.ranks)]]


def test_exports_cover_jax():
    """The port exports every name the JAX package exports, and its
    version."""
    import tekken_tpu

    assert set(tekken_tpu.__all__) <= set(tt.__all__)
    assert all(hasattr(tt, name) for name in tt.__all__)
    assert tt.__version__ == tekken_tpu.__version__
    assert tt.TEKKEN_PATTERN == tekken_tpu.TEKKEN_PATTERN
    assert [(t.rank, t.token_str) for t in tt.get_deprecated_special_tokens()
            ] == [(t.rank, t.token_str)
                  for t in tekken_tpu.get_deprecated_special_tokens()]


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither jax nor the JAX package,
    nor the repo's ``bench.py`` or ``tools/`` scripts (which import the
    JAX package)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|tekken_tpu|bench|tools)"
                     r"\b(?!_)", re.MULTILINE)
    for line in ("import bench", "from bench import build_corpus",
                 "import tools.soak", "    from tools import soak",
                 "from tekken_tpu.ops import packed", "import jax.numpy"):
        assert pat.search(line), line
    for line in ("from .tools import soak", "import tekken_tpu_torch.tools",
                 "from .models.bench import BENCH_SEED"):
        assert not pat.search(line), line
    files = sorted((REPO / "tekken_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        hits = pat.findall(f.read_text(encoding="utf-8"))
        assert not hits, (f, hits)
