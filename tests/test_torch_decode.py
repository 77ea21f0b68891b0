"""PyTorch port: the decode plain versions, DeviceDecoder and
Tekkenizer.decode_batch equal the JAX package's decode functions, its
decode_batch and the host loop, byte for byte, on CPU tensors (the kernel's
plain version).  The JAX Pallas decode runs in interpret mode on the CPU."""

import base64
import random

import numpy as np
import pytest
import torch

import tekken_tpu_torch as tt
import tekken_tpu_torch.ops.decode as tdecode
from tekken_tpu.oracle import decode_bytes
from tekken_tpu_torch.special_tokens import SpecialTokenPolicy

POLICIES = ["KEEP", "IGNORE", "RAISE"]


@pytest.fixture(scope="module")
def toks(merged_tokenizer):
    md = tt.ModelData.from_json(merged_tokenizer.to_model_data().to_json())
    return merged_tokenizer, tt.Tekkenizer.from_model_data(md, device="cpu")


@pytest.fixture(scope="module")
def long_toks():
    """Byte tokens + the prefix chain of a 40-byte word: one token longer
    than 32 bytes, so the decoder takes the gather formulation."""
    import tekken_tpu as jt

    word = b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMN"
    tokens = [bytes([i]) for i in range(256)]
    tokens += [word[:k] for k in range(2, len(word) + 1)]

    def vocab(mod):
        return [mod.TokenInfo(rank=r, token_bytes=base64.b64encode(t).decode(),
                              token_str=None) for r, t in enumerate(tokens)]

    args = dict(pattern="", vocab_size=len(tokens) + 10, num_special_tokens=10)
    jtok = jt.Tekkenizer(vocab(jt), [], version=jt.TokenizerVersion.V7,
                         **args)
    port = tt.Tekkenizer(vocab(tt), [], version=tt.TokenizerVersion.V7,
                         device="cpu", **args)
    return jtok, port


def _jax_decoder(tok, **kw):
    from tekken_tpu.ops.decode import DeviceDecoder

    return DeviceDecoder(tok, **kw)


@pytest.mark.parametrize("T,n", [(256, 256), (512, 300), (256, 1), (256, 0)])
def test_decode_plain_versions_match_jax(toks, T, n):
    """Both formulations against decode_bytes_impl and
    decode_bytes_pallas_impl, over all out_cap bytes."""
    import jax.numpy as jnp

    from tekken_tpu.ops.decode import (decode_bytes_impl,
                                       decode_bytes_pallas_impl)

    tok, port = toks
    jd = _jax_decoder(tok)
    pd = tdecode.DeviceDecoder(port, device="cpu")
    assert pd._sw4 == jd._sw4 is not None
    assert np.array_equal(pd._bytes32.numpy(), np.asarray(jd._bytes32))
    ranks = np.random.default_rng(T + n).integers(0, pd._n_ranks, T,
                                                  dtype=np.int32)
    cap = pd.out_cap_for(ranks[:n])
    assert cap == jd.out_cap_for(ranks[:n])
    jr, tr = jnp.asarray(ranks), torch.from_numpy(ranks)
    w1, wt1 = decode_bytes_impl(jr, n, jd._flat, jd._offsets, cap)
    w2, wt2 = decode_bytes_pallas_impl(jr, n, jd._bytes32, jd._lentab, cap,
                                       jd._sw4)
    dt = port.decode_table
    flat = torch.from_numpy(np.asarray(dt.flat).astype(np.int32))
    offsets = torch.from_numpy(np.asarray(dt.offsets).astype(np.int32))
    g1, gt1 = tdecode.decode_bytes_impl(tr, n, flat, offsets, cap)
    g2, gt2 = tdecode.decode_bytes_compact_reference(tr, n, pd._bytes32,
                                                     pd._lentab, cap)
    g3, _ = tdecode.decode_bytes_compact(tr, n, pd._bytes32, pd._lentab, cap)
    assert int(gt1) == int(gt2) == int(wt1) == int(wt2)
    for g, w in ((g1, w1), (g2, w2), (g3, w2)):
        assert g.dtype == torch.uint8
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [255, 256, 257])
def test_decode_store_total_is_int32(toks, n):
    """decode_bytes_compact on CPU tensors at n_tokens on both sides of a
    256-token boundary: the plain version's total is int32, as the JAX
    function's is, and it and every byte equal decode_bytes_pallas_impl's."""
    import jax.numpy as jnp

    from tekken_tpu.ops.decode import decode_bytes_pallas_impl

    tok, port = toks
    jd = _jax_decoder(tok)
    pd = tdecode.DeviceDecoder(port, device="cpu")
    ranks = np.random.default_rng(n).integers(0, pd._n_ranks, 512,
                                              dtype=np.int32)
    cap = pd.out_cap_for(ranks[:n])
    want, wt = decode_bytes_pallas_impl(jnp.asarray(ranks), n, jd._bytes32,
                                        jd._lentab, cap, jd._sw4)
    got, gt = tdecode.decode_bytes_compact(torch.from_numpy(ranks), n,
                                           pd._bytes32, pd._lentab, cap)
    assert np.asarray(wt).dtype == np.int32
    assert gt.dtype == torch.int32 and gt.shape == ()
    assert int(gt) == int(wt)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_gather_formulation_for_long_tokens(long_toks):
    jtok, port = long_toks
    jd = _jax_decoder(jtok)
    pd = tdecode.DeviceDecoder(port, device="cpu")
    assert pd._sw4 is None and jd._sw4 is None
    ranks = np.random.default_rng(3).integers(0, pd._n_ranks, 700,
                                              dtype=np.int32)
    want = decode_bytes(ranks, jtok.decode_table)
    assert pd.decode_stream(ranks) == jd.decode_stream(ranks) == want
    ids = [[1] + [int(r) + 10 for r in ranks[:50]], [int(ranks[-1]) + 10]]
    assert port.decode_batch(ids, SpecialTokenPolicy.IGNORE) == [
        port.decode(x, SpecialTokenPolicy.IGNORE) for x in ids]


def test_device_decoder_capacity_and_chunks(toks):
    """Streams longer than the capacity decode in chunks; decode_ranks
    refuses them; ranks outside the table are refused."""
    tok, port = toks
    pd = tdecode.DeviceDecoder(port, capacity=256, device="cpu")
    jd = _jax_decoder(tok, capacity=256)
    ranks = np.random.default_rng(5).integers(0, pd._n_ranks, 1000,
                                              dtype=np.int32)
    want = decode_bytes(ranks, tok.decode_table)
    assert pd.decode_stream(ranks) == jd.decode_stream(ranks) == want
    assert pd.decode_ranks([]) == b""
    assert pd.decode_ranks(ranks[:256]) == want[:len(
        decode_bytes(ranks[:256], tok.decode_table))]
    with pytest.raises(ValueError, match="exceed capacity"):
        pd.decode_ranks(ranks[:257])
    with pytest.raises(ValueError, match="outside the decode table"):
        pd.decode_stream([pd._n_ranks])


def _lists(tok, rng):
    ns, vs = tok.num_special_tokens(), tok.vocab_size()
    euro = "€".encode("utf-8")
    lists = [[rng.randrange(0, vs) for _ in range(rng.randint(0, 60))]
             for _ in range(24)]
    lists += [[], [0], [ns], [vs - 1], [0, 0, ns, ns + 1, 0],
              [ns + b for b in euro[:2]],                    # dangling prefix
              [ns + euro[0], 1, ns + euro[1], ns + euro[2]],  # split by a special
              tok.encode("hello world, it's 中文", True, True)]
    return lists


def _outcome(fn):
    try:
        return fn()
    except Exception as e:      # the error's class name and text
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("policy", POLICIES)
def test_decode_batch_matches_jax(toks, monkeypatch, policy):
    """Strings or the raised error, against the JAX decode_batch on its
    device decoder and against the host loop."""
    from tekken_tpu.special_tokens import SpecialTokenPolicy as JPolicy

    monkeypatch.setenv("TEKKEN_TPU_DECODE_BYTES", "device")
    tok, port = toks
    pol, jpol = SpecialTokenPolicy[policy], JPolicy[policy]
    cases = [_lists(tok, random.Random(11)),
             [[tok.num_special_tokens() + 70] * 3, [tok.vocab_size() + 5]],
             [[-1 - tok.num_special_tokens()]],
             [[tok.num_special_tokens() + 65]]]
    for lists in cases:
        got = _outcome(lambda: port.decode_batch(lists, pol))
        want = _outcome(lambda: tok.decode_batch(lists, jpol))
        assert got == want
        if isinstance(got, list) and policy != "RAISE":
            assert got == [port.decode(x, pol) for x in lists]
    if policy == "RAISE":
        with pytest.raises(tt.SpecialTokenPolicyError, match="not allowed"):
            port.decode_batch(cases[0], pol)
    with pytest.raises(tt.TokenizersError, match="Invalid token id"):
        port.decode_batch(cases[1][1:], pol)


def test_decode_batch_stream_over_capacity(toks, monkeypatch):
    """A batch whose rank stream is longer than the decoder's capacity."""
    from tekken_tpu.special_tokens import SpecialTokenPolicy as JPolicy

    monkeypatch.setenv("TEKKEN_TPU_DECODE_BYTES", "device")
    tok, port = toks
    monkeypatch.setattr(tok, "_device_decoder", _jax_decoder(tok, capacity=256),
                        raising=False)
    monkeypatch.setattr(port, "_device_decoder",
                        tdecode.DeviceDecoder(port, capacity=256, device="cpu"))
    rng = random.Random(2)
    lists = _lists(tok, rng) + _lists(tok, rng) + _lists(tok, rng)
    assert sum(len(x) for x in lists) > 3 * 256
    for policy in ("KEEP", "IGNORE"):
        got = port.decode_batch(lists, SpecialTokenPolicy[policy])
        assert got == tok.decode_batch(lists, JPolicy[policy])
        assert got == [port.decode(x, SpecialTokenPolicy[policy])
                       for x in lists]
