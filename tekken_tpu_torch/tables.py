"""Device copies of the encode tables.

``tables_from_numpy`` turns the numpy tables of a tokenizer (built by this
package's vocab.py, or identical arrays from the JAX package's builders)
into the tensors the packed encode reads on the device:

- ``packed``: the cuckoo pair table, (S, 4) int32 [left, right, merged, 0]
- ``dense``: the byte-pair table of the first merge round, (65536,) int32
- ``word_rows``: the word-exact whole-piece map, (W, 4) or (W, 8) int32
- the seeds of the two cuckoo hashes and of the word hash.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .vocab import RANK_LIMIT


@dataclass(frozen=True)
class DeviceTables:
    packed: torch.Tensor
    dense: torch.Tensor
    word_rows: torch.Tensor
    seed1: int
    seed2: int
    wseed: int

    @property
    def device(self) -> torch.device:
        return self.packed.device

    @property
    def n_words(self) -> int:
        """Content dwords per word-map row: 3 (narrow) or 6 (wide)."""
        return 3 if self.word_rows.shape[1] == 4 else 6

    @property
    def max_word_len(self) -> int:
        return 4 * self.n_words


def _pow2(n: int) -> bool:
    return n > 0 and not n & (n - 1)


def tables_from_numpy(packed: np.ndarray, dense: np.ndarray,
                      word_rows: np.ndarray, seed1: int, seed2: int,
                      wseed: int, device="cuda") -> DeviceTables:
    """Validate the numpy tables and copy them to ``device``."""
    packed = np.ascontiguousarray(packed, dtype=np.int32)
    dense = np.ascontiguousarray(dense, dtype=np.int32)
    word_rows = np.ascontiguousarray(word_rows, dtype=np.int32)
    if packed.ndim != 2 or packed.shape[1] != 4 or not _pow2(packed.shape[0]):
        raise ValueError(f"packed must be (S, 4) with S a power of two, "
                         f"got {packed.shape}")
    if packed.size and int(packed[:, 2].max()) >= RANK_LIMIT:
        raise ValueError("pair-table rank >= 2^24 unsupported by the merge "
                         "kernel")
    if dense.shape != (65536,):
        raise ValueError(f"dense must be (65536,), got {dense.shape}")
    if (word_rows.ndim != 2 or word_rows.shape[1] not in (4, 8)
            or not _pow2(word_rows.shape[0])):
        raise ValueError(f"word_rows must be (W, 4|8) with W a power of "
                         f"two, got {word_rows.shape}")

    def put(a):
        return torch.from_numpy(a).to(device)

    return DeviceTables(packed=put(packed), dense=put(dense),
                        word_rows=put(word_rows), seed1=int(seed1),
                        seed2=int(seed2), wseed=int(wseed))
