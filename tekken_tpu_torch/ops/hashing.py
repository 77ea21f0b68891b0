"""uint32 hash arithmetic on torch integer tensors.

torch has no general uint32 arithmetic and its ``>>`` on int32 is
arithmetic, so every uint32 quantity here is held in int64 in
[0, 2^32): shifts are then logical, and ``mul32`` splits each multiply
into 16-bit halves so no int64 product overflows, also when both factors
are tensors (a product of two uint32 values needs 64 bits, which int64
cannot hold).  Bit-identical to the numpy builders (vocab.cuckoo_hash /
vocab.pair_hash / vocab.word_hash) and to the CUDA kernels' ``uint32_t``
arithmetic.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
K1 = 0x9E3779B1
K2 = 0x85EBCA77
K3 = 0xC2B2AE3D
K4 = 0x27D4EB2F


def u32(x: torch.Tensor) -> torch.Tensor:
    """int tensor -> its uint32 bit pattern as int64 (negatives wrap)."""
    return x.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def mul32(a: torch.Tensor, k) -> torch.Tensor:
    """(a * k) mod 2^32 for a in [0, 2^32) held in int64; ``k`` an int or
    an int64 tensor in [0, 2^32).  Each partial product stays below
    2^48."""
    lo = (a & 0xFFFF) * k
    hi = ((a >> 16) * k) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def _finalize(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 15)
    h = mul32(h, K3)
    return h ^ (h >> 13)


def pair_slot(left: torch.Tensor, right: torch.Tensor, seed: int,
              size: int) -> torch.Tensor:
    """Cuckoo slot of (left, right) under ``seed`` (vocab.cuckoo_hash)."""
    h = mul32(u32(left), K1) ^ mul32(u32(right), K2) ^ (seed & MASK32)
    return _finalize(h) & (size - 1)


def pair_hash_slot(left: torch.Tensor, right: torch.Tensor,
                   size: int) -> torch.Tensor:
    """First linear-probe slot of (left, right) (vocab.pair_hash): the
    cuckoo hash without its seed."""
    return pair_slot(left, right, 0, size)


def word_slot(w0: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              plen: torch.Tensor, seed: int, size: int) -> torch.Tensor:
    """Word-map slot of a piece's first three content dwords and its length
    (vocab.word_hash).  Dwords are uint32 values held in int64."""
    h = (mul32(w0, K1) ^ mul32(w1, K2) ^ mul32(w2, K3)
         ^ mul32(u32(plen), K4) ^ (seed & MASK32))
    return _finalize(h) & (size - 1)
