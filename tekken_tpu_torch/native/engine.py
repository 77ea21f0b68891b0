"""ctypes bindings for the native C++ engine (native/engine.cpp).

The engine shares the cuckoo pair table's hash layout and the unicode
class tables with the device path, so the engines agree by construction;
tests/test_torch_native.py holds it against the oracle and against the
JAX package's engine call for call.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np

from ..ops.pretokenize import unicode_tables
from ..vocab import PieceTable
from .build import build

_i8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")

_LIB = None
_lock = threading.Lock()


def _load():
    """The engine's library, built and loaded on first use."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        lib.tkn_create.restype = ctypes.c_void_p
        lib.tkn_create.argtypes = [_i32p, ctypes.c_int64, ctypes.c_int32,
                                   ctypes.c_int32, _i8p, _i8p, ctypes.c_int64,
                                   _i32p, ctypes.c_int64, ctypes.c_int32,
                                   _i8p, ctypes.c_int64, _i32p,
                                   ctypes.c_int64]
        lib.tkn_destroy.restype = None
        lib.tkn_destroy.argtypes = [ctypes.c_void_p]
        lib.tkn_encode.restype = ctypes.c_int64
        lib.tkn_encode.argtypes = [ctypes.c_void_p, _i8p, ctypes.c_int64,
                                   _i32p, ctypes.c_int64]
        lib.tkn_encode_batch.restype = ctypes.c_int64
        lib.tkn_encode_batch.argtypes = [ctypes.c_void_p, _i8p, _i64p,
                                         ctypes.c_int64, _i32p, _i64p,
                                         ctypes.c_int32]
        lib.tkn_merge_spans.restype = ctypes.c_int64
        lib.tkn_merge_spans.argtypes = [ctypes.c_void_p, _i8p, _i32p, _i32p,
                                        ctypes.c_int64, _i32p, _i32p,
                                        ctypes.c_int64]
        lib.tkn_decode.restype = ctypes.c_int64
        lib.tkn_decode.argtypes = [ctypes.c_void_p, _i32p, ctypes.c_int64,
                                   _i8p, ctypes.c_int64]
        _LIB = lib
        return lib


class NativeEncoder:
    """Host-native encoder for one Tekkenizer (engine ranks, pre-shift)."""

    def __init__(self, tokenizer):
        self._lib = _load()
        table = tokenizer.cuckoo_table()
        cls_tab, fold_tab = unicode_tables()
        self._cls = np.ascontiguousarray(cls_tab, dtype=np.uint8)
        self._fold = np.ascontiguousarray(fold_tab, dtype=np.uint8)
        self._packed = np.ascontiguousarray(table.packed.reshape(-1),
                                            dtype=np.int32)
        pt = PieceTable.build(tokenizer.ranks)
        dt = tokenizer.decode_table
        self._piece_slot = np.ascontiguousarray(pt.slots[:, 2])
        self._vflat = np.ascontiguousarray(dt.flat, dtype=np.uint8)
        self._voff = np.ascontiguousarray(dt.offsets, dtype=np.int32)
        basis = pt.basis - (1 << 32) if pt.basis >= (1 << 31) else pt.basis
        # the engine copies every table at create
        self._h = self._lib.tkn_create(
            self._packed, table.size, int(table.seed1) & 0x7FFFFFFF,
            int(table.seed2) & 0x7FFFFFFF, self._cls, self._fold,
            len(self._cls), self._piece_slot, pt.size, basis, self._vflat,
            len(self._vflat), self._voff, len(self._voff) - 1)
        if not self._h:
            raise RuntimeError("tkn_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.tkn_destroy(h)
            self._h = None

    def encode(self, text: str) -> list[int]:
        data = np.frombuffer(text.encode("utf-8"), dtype=np.uint8)
        n = len(data)
        if n == 0:
            return []
        out = np.empty(n, dtype=np.int32)
        cnt = self._lib.tkn_encode(self._h, data, n, out, n)
        if cnt < 0:
            raise RuntimeError("native encode overflow")
        return out[:cnt].tolist()

    def merge_spans(self, buf: np.ndarray, starts: np.ndarray,
                    lens: np.ndarray):
        """Bulk-merge pre-split pieces (the device path's vocab misses):
        spans (starts[i], lens[i]) into ``buf`` (uint8).  Returns (tokens
        int32 back-to-back, counts int32 per span) with byte_pair_merge
        semantics (whole-piece lookup first)."""
        buf = np.ascontiguousarray(buf, dtype=np.uint8)
        starts = np.ascontiguousarray(starts, dtype=np.int32)
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        n = len(starts)
        if n == 0:
            return (np.empty(0, np.int32), np.empty(0, np.int32))
        if len(lens) != n:
            raise ValueError("merge_spans: starts and lens differ in length")
        if (int(starts.min()) < 0 or int(lens.min()) < 0
                or int((starts.astype(np.int64) + lens).max()) > buf.size):
            raise ValueError("merge_spans: a span lies outside the buffer")
        cap = int(lens.sum(dtype=np.int64))
        out = np.empty(max(1, cap), dtype=np.int32)
        cnts = np.empty(n, dtype=np.int32)
        total = self._lib.tkn_merge_spans(self._h, buf, starts, lens, n, out,
                                          cnts, cap)
        if total < 0:
            raise RuntimeError("native merge_spans overflow")
        return out[:total], cnts

    def decode_ranks(self, ranks: np.ndarray) -> bytes:
        """Engine ranks -> concatenated bytes (reference byte semantics,
        src/tekkenizer.rs:548-557).  Raises on out-of-range ranks; returns
        b"" for an empty stream."""
        ranks = np.ascontiguousarray(ranks, dtype=np.int32)
        n = ranks.size
        if n == 0:
            return b""
        if int(ranks.min()) < 0 or int(ranks.max()) + 1 >= self._voff.size:
            raise ValueError("native decode: rank out of range")
        cap = int((self._voff[ranks + 1] - self._voff[ranks]).sum(
            dtype=np.int64))
        out = np.empty(max(1, cap), dtype=np.uint8)
        total = self._lib.tkn_decode(self._h, ranks, n, out, cap)
        if total < 0:
            raise ValueError(f"native decode failed (code {total})")
        return out[:total].tobytes()

    def encode_batch(self, texts: Sequence[str], n_threads: int = 0):
        """Every text's ranks, the docs spread over ``n_threads`` threads
        (0: one a core)."""
        datas = [t.encode("utf-8") for t in texts]
        offsets = np.zeros(len(datas) + 1, dtype=np.int64)
        np.cumsum([len(d) for d in datas], out=offsets[1:])
        total = int(offsets[-1])
        if total == 0:
            return [[] for _ in texts]
        buf = np.frombuffer(b"".join(datas), dtype=np.uint8)
        out = np.empty(total, dtype=np.int32)
        out_offsets = np.zeros(len(datas) + 1, dtype=np.int64)
        n = self._lib.tkn_encode_batch(self._h, buf, offsets, len(datas), out,
                                       out_offsets, n_threads)
        if n < 0:
            raise RuntimeError("native encode_batch failed")
        return [out[out_offsets[i]:out_offsets[i + 1]].tolist()
                for i in range(len(datas))]
