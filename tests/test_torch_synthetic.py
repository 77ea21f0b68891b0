"""PyTorch port: the synthetic model builders (models/) give the JAX
package's ``tekken.json`` for the same arguments, and a tokenizer built
from it encodes and decodes as the JAX package's does."""

import pytest

import tekken_tpu_torch as tt
from tekken_tpu_torch.models import (build_synthetic_model_data,
                                     build_synthetic_tokenizer,
                                     train_bpe_vocab)
from test_torch_native import random_texts
from test_torch_tekkenizer import TEXTS

ARGS = {
    "bytes-only": dict(num_merges=0, num_special_tokens=10),
    "merges-audio": dict(num_merges=120, num_special_tokens=20,
                         with_audio=True, chunk_length_s=30.0),
    "own-texts-v3": dict(num_merges=60, num_special_tokens=12,
                         texts=["aaa bbb aaa ccc", "x y z x y z 123",
                                "café café 中文"], version="v3"),
}


@pytest.mark.parametrize("name", list(ARGS))
def test_model_data_json_matches_jax(name):
    from tekken_tpu.models import build_synthetic_model_data as jax_build

    kw = ARGS[name]
    assert build_synthetic_model_data(**kw).to_json() == \
        jax_build(**kw).to_json()


def test_train_bpe_vocab_matches_jax():
    from tekken_tpu.models import train_bpe_vocab as jax_train

    texts = random_texts(6, 40)
    got = train_bpe_vocab(texts, 80)
    want = jax_train(texts, 80)
    assert [(t.rank, t.token_bytes) for t in got] == \
        [(t.rank, t.token_bytes) for t in want]
    assert len(got) > 256


@pytest.mark.parametrize("name", ["bytes-only", "merges-audio"])
def test_synthetic_tokenizer_encodes_as_jax(name):
    from tekken_tpu.models import build_synthetic_tokenizer as jax_tok
    from tekken_tpu.special_tokens import SpecialTokenPolicy as JPolicy

    kw = ARGS[name]
    port = build_synthetic_tokenizer(device="cpu", **kw)
    tok = jax_tok(**kw)
    assert isinstance(port, tt.Tekkenizer)
    assert port.vocab() == tok.vocab()
    assert port.has_audio_support() == tok.has_audio_support()
    texts = TEXTS + random_texts(7, 40)
    want = [tok.encode(t, True, True) for t in texts]
    assert [port.encode(t, True, True) for t in texts] == want
    assert port.encode_batch(texts, True, True) == want
    assert port.decode_batch(want, tt.SpecialTokenPolicy.IGNORE) == [
        tok.decode(ids, JPolicy.IGNORE) for ids in want]
