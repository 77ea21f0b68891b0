"""PyTorch port: the bucket merge's plain version (ops/merge.py
``merge_buckets_reference``, with the tiers of ops/packed.py) equals the JAX
package's ``_merge_buckets`` on the same bucket words, geometry and byte
ranks, exactly on the integer token stream: routed words (compact record
indices into the (start, plen) planes) and flat words (byte starts into a
plen plane), with and without fallback rows, at device-merge limits 8 and
32.

``bucket_inputs`` builds the inputs from a numpy seed; the ``cuda`` tests
(tests/test_torch_cuda.py) hold the kernel against the plain version on
the same inputs.  This module imports jax only inside its tests.
"""

import numpy as np
import pytest
import torch

import tekken_tpu_torch as tt
from tekken_tpu_torch.ops.merge import merge_buckets_reference
from tekken_tpu_torch.ops.packed import _bucket_tiers

# bucket capacities (NP4, NP8, NP32) of the inputs below
CAPS = (128, 64, 64)
PIECE_LENS = (2, 3, 4, 5, 6, 7, 8, 9, 12, 20, 31, 32, 33, 40)
MERGING = np.frombuffer(b"etaoinshrdlu ", np.uint8)


def bucket_inputs(seed, layout, limit=8, which="all", fb=True, B=8, R=512):
    """Bucket words over a (B, R) byte buffer, as the encode builds them.

    Rows of random lengths are cut into consecutive pieces; a piece of
    common letters merges deeply, one of control bytes never merges (its
    rounds end at once).  Pieces of 2-4 bytes go to the P=4 bucket, 5-8 to
    the P=8 bucket, longer ones to the P=32 bucket, where those over
    ``limit`` are fallback rows (``fb`` False keeps pieces to ``limit``
    bytes).  ``which`` names the buckets that get rows ("all", "none", or
    "tiny", "short", "long" joined by "+"); dead rows sit between the live
    ones.  ``layout`` "routed": words hold compact record indices into
    (start, plen) planes (B, R); "flat": words hold byte starts into a plen
    plane (N,).  Returns numpy arrays and the counts (n_t, n_s, n_l,
    n_lm)."""
    g = np.random.default_rng(seed)
    N = B * R
    NP4, NP8, NP32 = CAPS
    names = {"tiny": 0, "short": 1, "long": 2}
    want = ({0, 1, 2} if which == "all" else set() if which == "none"
            else {names[k] for k in which.split("+")})
    lens_ok = [L for L in PIECE_LENS if fb or L <= limit]
    byts = np.zeros((B, R), np.uint8)
    st = np.full((B, R), -1, np.int32)
    pl = np.full((B, R), -1, np.int32)
    plen_flat = np.zeros(N, np.int32)
    lengths = g.integers(R // 2, R + 1, B).astype(np.int32)
    w = np.zeros(sum(CAPS), np.int64)
    lo = [0, NP4, NP4 + NP8]
    nxt = list(lo)
    n_lm = 0
    for r in range(B):
        s = k = 0
        while True:
            L = int(g.choice(lens_ok))
            if s + L > lengths[r]:
                break
            byts[r, s:s + L] = (g.choice(MERGING, L) if g.random() < 0.8
                                else g.integers(1, 9, L))
            st[r, k], pl[r, k] = s, L
            plen_flat[r * R + s] = L
            b = 0 if L <= 4 else 1 if L <= 8 else 2
            if b in want and nxt[b] + 1 < lo[b] + CAPS[b]:
                if g.random() < 0.2:
                    nxt[b] += 1                              # a dead row
                is_fb = b == 2 and L > limit
                idx = r * R + (s if layout == "flat" else k)
                w[nxt[b]] = (idx << 2) | (int(is_fb) << 1) | 1
                nxt[b] += 1
                n_lm += b == 2 and not is_fb
            s += L
            k += 1
        byts[r, s:lengths[r]] = g.integers(97, 123, lengths[r] - s)
    valid = np.arange(R)[None, :] < lengths[:, None]
    byte_rank = np.where(valid, byts, -1).reshape(N).astype(np.int64)
    counts = (nxt[0], nxt[1] - lo[1], nxt[2] - lo[2], n_lm)
    geo = (dict(plen=pl, start=st) if layout == "routed"
           else dict(plen=plen_flat, start=None))
    return dict(byts=byts, byte_rank=byte_rank, w=w, counts=counts,
                tok=g.integers(-1, 1000, N + 1).astype(np.int32), **geo)


def _port_tables(merged_tokenizer):
    md = tt.ModelData.from_json(merged_tokenizer.to_model_data().to_json())
    return tt.Tekkenizer.from_model_data(md, device="cpu").device_tables("cpu")


def _jax_merge(tabs, inp, layout):
    """The JAX package's _merge_buckets on the same inputs (its rows_fn as
    its flat and compact paths build them)."""
    import jax
    import jax.numpy as jnp

    from tekken_tpu.ops.packed import _merge_buckets

    w = inp["w"]
    N = inp["byte_rank"].shape[0]
    live = (w & 1) == 1
    fbv = live & ((w & 2) != 0)
    keep = live & ~fbv
    jj = np.clip(w >> 2, 0, N - 1)
    if layout == "flat":
        n0 = np.where(keep, inp["plen"][jj], 0)
        s0 = np.where(keep, w >> 2, -1)
    else:
        R = inp["start"].shape[1]
        stf = inp["start"].reshape(N).astype(np.int64)
        pos = np.where(stf >= 0, stf + np.arange(N) // R * R, -1)
        n0 = np.where(keep, inp["plen"].reshape(N)[jj], 0)
        s0 = np.where(keep, pos[jj], -1)
    n0 = jnp.asarray(n0.astype(np.int32))
    s0 = jnp.asarray(s0.astype(np.int32))
    n_t, n_s, n_l, _ = inp["counts"]
    fn = jax.jit(lambda t, br, pk, dn: _merge_buckets(
        t, br, lambda lo, rows: (n0[lo:lo + rows], s0[lo:lo + rows]),
        (n_t, n_s, n_l), CAPS, pk, dn, tabs.seed1, tabs.seed2))
    return np.asarray(fn(jnp.asarray(inp["tok"][:N]),
                         jnp.asarray(inp["byte_rank"].astype(np.int32)),
                         jnp.asarray(tabs.packed.numpy()),
                         jnp.asarray(tabs.dense.numpy())))


@pytest.mark.parametrize("limit", [8, 32])
@pytest.mark.parametrize("fb", [True, False], ids=["fb", "no-fb"])
@pytest.mark.parametrize("layout", ["routed", "flat"])
def test_merge_buckets_reference_matches_jax(merged_tokenizer, layout, fb,
                                             limit):
    tabs = _port_tables(merged_tokenizer)
    inp = bucket_inputs(limit + 3 * fb, layout, limit, fb=fb)
    n_t, n_s, n_l, n_lm = inp["counts"]
    # pieces over 8 bytes exist only as fallback rows or under limit 32
    assert n_t and n_s and bool(n_l) == (fb or limit > 8)
    assert bool(((inp["w"] & 3) == 3).any()) == fb and bool(n_lm) == (limit > 8)
    tok = torch.from_numpy(inp["tok"].copy())
    start = inp["start"]
    merge_buckets_reference(
        tok, torch.from_numpy(inp["w"]), torch.from_numpy(inp["byte_rank"]),
        torch.from_numpy(inp["plen"]), _bucket_tiers(inp["counts"], CAPS),
        tabs, None if start is None else torch.from_numpy(start))
    want = _jax_merge(tabs, inp, layout)
    N = want.shape[0]
    assert not np.array_equal(want, inp["tok"][:N])      # rows merged
    assert np.array_equal(tok.numpy()[:N], want)


def test_bucket_tiers():
    """Empty buckets have no tier; P=4 and P=8 run fixed rounds, P=32
    loops; the long tier covers every row the bucket fills."""
    assert _bucket_tiers((0, 0, 0, 0), CAPS) == []
    assert _bucket_tiers((5, 0, 70, 0), CAPS) == [(0, 64, 4, 3)]
    assert _bucket_tiers((0, 9, 70, 1), (1024, 512, 128)) == [
        (1024, 64, 8, 7), (1536, 128, 32, None)]
