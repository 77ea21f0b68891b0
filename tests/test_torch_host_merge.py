"""PyTorch port: host-merge mode.  ``packed_encode(host_merge=True)`` equals
the JAX package's ``packed_encode_fn(..., host_merge=True, route)`` output
for output (routes 1-3 and the unrouted flat path, overflow included), and
``PackedEncoder(merge="host")`` equals the JAX encoder and the oracle, on
CPU tensors."""

import random

import numpy as np
import pytest
import torch

import tekken_tpu_torch as tt
import tekken_tpu_torch.ops.packed as tpacked
from tekken_tpu.oracle import encode_ranks
from tekken_tpu_torch.ops.packed import PackedEncoder, packed_encode
from test_torch_packed import B8, R256, ROUTE_TEXTS, _pack, _prose


@pytest.fixture(scope="module")
def toks(merged_tokenizer):
    md = tt.ModelData.from_json(merged_tokenizer.to_model_data().to_json())
    return merged_tokenizer, tt.Tekkenizer.from_model_data(md, device="cpu")


def _run_jax(tok, buf, lens, route, np_cap):
    import jax.numpy as jnp

    from tekken_tpu.ops.packed import PackedEncoder as JEncoder
    from tekken_tpu.ops.packed import packed_encode_fn

    B, R = buf.shape
    enc = JEncoder(tok, rows=B, row_len=R, np_cap=np_cap)
    fn = packed_encode_fn(enc._seed1, enc._seed2, np_cap, enc._wseed, True,
                          route)
    out = fn(jnp.asarray(buf), jnp.asarray(lens), enc._packed, enc._dense,
             enc._word_rows)
    return [np.asarray(x) for x in out]


def _run_port(port, buf, lens, route, np_cap):
    out = packed_encode(torch.from_numpy(buf), torch.from_numpy(lens),
                        port.device_tables("cpu"), route, np_cap,
                        host_merge=True)
    return [out[0].numpy(), out[1].numpy(), out[2].numpy(), out[3].numpy(),
            np.asarray(out[4], np.int32), out[5].numpy()]


def _assert_same(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("route,texts", [(1, 1), (2, 2), (3, 3),
                                         (None, 1), (None, 3)],
                         ids=["r1", "r2", "r3", "flat-simple", "flat-utf8"])
def test_host_merge_matches_jax(toks, monkeypatch, route, texts):
    """Every output equal; every miss is a span and no merge runs."""
    tok, port = toks
    calls = []
    monkeypatch.setattr(tpacked, "merge_buckets",
                        lambda *a, **kw: calls.append(a))
    buf, lens = _pack(ROUTE_TEXTS[texts](random.Random(texts)), B8, R256)
    got = _run_port(port, buf, lens, route, 256)
    _assert_same(got, _run_jax(tok, buf, lens, route, 256))
    assert not calls and got[4] == 0 and (got[2] >= 0).sum() > 40


@pytest.mark.parametrize("route", [1, None], ids=["routed", "flat"])
def test_host_merge_overflow_matches_jax(toks, route):
    """More misses than the 64 spans of a small np_cap: overflow is set
    and exactly the rows holding unrecorded misses are flagged."""
    tok, port = toks
    texts = ROUTE_TEXTS[1](random.Random(1))
    buf, lens = _pack(texts, B8, R256)
    got = _run_port(port, buf, lens, route, 64)
    _assert_same(got, _run_jax(tok, buf, lens, route, 64))
    assert got[4] == 1 and (got[2] >= 0).sum() == 64
    assert 0 < got[5].sum() < len(texts)


def test_packed_encoder_host_merge(toks):
    """PackedEncoder(merge="host"): the docs equal the JAX encoder's and
    the oracle's, on a mixed batch (three route groups) and on a batch
    that overflows a small capacity; every miss is spliced on the host.
    (Shapes and capacities are the tests' above, so the JAX package
    compiles nothing new.)"""
    from tekken_tpu.ops.packed import PackedEncoder as JEncoder

    tok, port = toks
    rng = random.Random(41)
    mixed = ([_prose(rng, rng.randint(5, 40))[:250] for _ in range(5)]
             + ["double  spaces 1234567", "café naïve 中文 \U0001f600", ""])
    for texts, np_cap, overflow in ((mixed, 256, False),
                                    (ROUTE_TEXTS[1](random.Random(1)), 64,
                                     True)):
        penc = PackedEncoder(port, rows=B8, row_len=R256, np_cap=np_cap,
                             device="cpu", merge="host")
        jenc = JEncoder(tok, rows=B8, row_len=R256, np_cap=np_cap,
                        merge="host")
        got = penc.encode_batch(texts)
        assert got == jenc.encode_batch(texts)
        assert got == [encode_ranks(t, tok.ranks) for t in texts]
        assert penc.stats["fb_spans"] > 40
        assert (penc.stats["overflow_rows"] > 0) == overflow


def test_merge_argument_refused(toks):
    _, port = toks
    with pytest.raises(ValueError, match="merge must be 'host' or 'device'"):
        PackedEncoder(port, rows=8, row_len=256, device="cpu", merge="both")
