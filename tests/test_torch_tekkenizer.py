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
    # a doc longer than an 8-row buffer's row (2 MiB) is refused with its
    # size, never served elsewhere
    with pytest.raises(ValueError, match="16777216"):
        port.encode_batch(["x" * ((1 << 21) + 1)])


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
    with pytest.raises(ValueError, match="4096"):
        port.encode_batch(["z" * 513])


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither jax nor the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|tekken_tpu)\b(?!_)",
                     re.MULTILINE)
    files = sorted((REPO / "tekken_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        hits = pat.findall(f.read_text(encoding="utf-8"))
        assert not hits, (f, hits)
