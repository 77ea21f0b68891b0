"""Vocabulary loading and the device-table builders (numpy, host side).

Turns a model file's vocab list into:

1. ``mergeable_ranks``: dict bytes -> rank, with the reference's validation
   rules (reference: src/tekkenizer.rs:776-816):
   - vocab truncated to ``max_vocab`` entries (src/tekkenizer.rs:780-784)
   - ranks < 256 must be exactly the single byte ``[rank]``
     (src/tekkenizer.rs:792-798)
   - the rank set must be contiguous ``0..len`` (src/tekkenizer.rs:804-813)
2. ``CuckooPairTable``: (left_rank, right_rank) -> merged_rank, two-choice
   cuckoo hashed, plus the dense byte-pair table of the first merge round.
   ``PairTable``: the same map with linear probing, for the flat engine
   (ops/flat.py) and the bucket merge (ops/bpe.py).
3. ``WordDirectMap``: the word-exact single-probe whole-piece table.
   ``CuckooPieceTable``: the flat engine's whole-piece table, keyed by the
   scan-friendly polynomial signature ``poly_sig31``.
4. ``PieceTable``: the native engine's whole-piece FNV-1a index.
5. ``DecodeTable``: concatenated token bytes + offsets.

The builders are copies of the JAX package's and produce identical arrays
from the same vocab (tests/test_torch_tables.py).  ``tables.py`` moves
their arrays to the device.
"""

from __future__ import annotations

import base64
import binascii
from dataclasses import dataclass

import numpy as np

from .config import TokenInfo
from .errors import Base64Error, InvalidConfigError

# the merge kernel packs (rank << lane_bits | lane) into one int32 key, so
# every rank it sees must stay below 2^24 (ops/bpe.py min_lane)
RANK_LIMIT = 1 << 24


def reload_mergeable_ranks(vocab: list[TokenInfo], max_vocab: int) -> dict[bytes, int]:
    """Decode and validate the vocab into a bytes->rank map
    (reference: src/tekkenizer.rs:776-816)."""
    if len(vocab) > max_vocab:
        vocab = vocab[:max_vocab]

    ranks: dict[bytes, int] = {}
    for token in vocab:
        try:
            token_bytes = base64.b64decode(token.token_bytes, validate=True)
        except (binascii.Error, ValueError) as e:
            raise Base64Error(str(e)) from e

        if token.rank < 256 and token_bytes != bytes([token.rank]):
            raise InvalidConfigError(
                f"Expected byte token at rank {token.rank} to be "
                f"[{token.rank}], got {list(token_bytes)}"
            )
        ranks[token_bytes] = token.rank

    if set(ranks.values()) != set(range(len(ranks))):
        raise InvalidConfigError("Vocabulary ranks are not contiguous")

    return ranks


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# 32-bit mixing constants (Murmur3/xxHash finalizer style); exactness comes
# from comparing the stored keys, not from the hash
_HC1 = np.uint32(0x9E3779B1)
_HC2 = np.uint32(0x85EBCA77)
_HC3 = np.uint32(0xC2B2AE3D)


def _enumerate_pairs(ranks: dict[bytes, int]) -> list[tuple[int, int, int]]:
    pairs: list[tuple[int, int, int]] = []
    for token_bytes, rank in ranks.items():
        n = len(token_bytes)
        if n < 2:
            continue
        for i in range(1, n):
            l = ranks.get(token_bytes[:i])
            if l is None:
                continue
            r = ranks.get(token_bytes[i:])
            if r is not None:
                pairs.append((l, r, rank))
    return pairs


def pair_hash(left: np.ndarray, right: np.ndarray, table_size: int) -> np.ndarray:
    """Hash a (left_rank, right_rank) pair into [0, table_size) (a power of
    two) — ``cuckoo_hash`` with seed 0; uint32 arithmetic, mirrored by the
    device probe (ops/bpe.py ``probe_pairs``)."""
    l = left.astype(np.uint32)
    r = right.astype(np.uint32)
    with np.errstate(over="ignore"):
        h = (l * _HC1) ^ (r * _HC2)
        h ^= h >> np.uint32(15)
        h *= _HC3
        h ^= h >> np.uint32(13)
    return (h & np.uint32(table_size - 1)).astype(np.int64)


@dataclass
class PairTable:
    """Open-addressing (linear probing) hash table of BPE merge pairs.

    Arrays (all length ``size``, a power of two):
      - ``key_left`` / ``key_right``: int32 pair key, -1 where empty
      - ``values``: merged rank (int32), -1 where empty

    ``max_probes`` bounds the longest probe chain, so the device probe is
    a loop of fixed length.
    """

    key_left: np.ndarray
    key_right: np.ndarray
    values: np.ndarray
    size: int
    max_probes: int
    num_pairs: int

    @classmethod
    def build(cls, ranks: dict[bytes, int], load_factor: float = 0.5) -> "PairTable":
        pairs = _enumerate_pairs(ranks)
        num_pairs = len(pairs)
        size = max(64, _next_pow2(int(num_pairs / load_factor) + 1))
        key_left = np.full(size, -1, dtype=np.int32)
        key_right = np.full(size, -1, dtype=np.int32)
        values = np.full(size, -1, dtype=np.int32)

        max_probes = 1
        if num_pairs:
            arr = np.asarray(pairs, dtype=np.int64)
            slots = pair_hash(arr[:, 0], arr[:, 1], size)
            mask = size - 1
            for (l, r, val), slot in zip(arr, slots):
                probes = 1
                s = int(slot)
                while key_left[s] >= 0:
                    if key_left[s] == l and key_right[s] == r:
                        probes = 0  # duplicate pair; bytes->rank is a function
                        break
                    s = (s + 1) & mask
                    probes += 1
                if probes == 0:
                    continue
                key_left[s] = l
                key_right[s] = r
                values[s] = val
                max_probes = max(max_probes, probes)

        return cls(key_left=key_left, key_right=key_right, values=values,
                   size=size, max_probes=max_probes, num_pairs=num_pairs)

    def lookup_host(self, left: int, right: int) -> int:
        """Scalar host-side probe (for tests). Returns merged rank or -1."""
        s = int(pair_hash(np.asarray(left), np.asarray(right), self.size))
        mask = self.size - 1
        for _ in range(self.max_probes + 1):
            if self.key_left[s] == left and self.key_right[s] == right:
                return int(self.values[s])
            if self.key_left[s] < 0:
                return -1
            s = (s + 1) & mask
        return -1


def cuckoo_hash(left, right, seed: int, table_size: int):
    """Seeded pair hash into [0, table_size) — uint32 arithmetic, mirrored by
    the device probe (ops/hashing.py, csrc/merge_rows.cu)."""
    l = np.asarray(left).astype(np.uint32)
    r = np.asarray(right).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = (l * _HC1) ^ (r * _HC2) ^ np.uint32(seed)
        h ^= h >> np.uint32(15)
        h *= _HC3
        h ^= h >> np.uint32(13)
    return (h & np.uint32(table_size - 1)).astype(np.int64)


def _cuckoo_place(triples, load_factor: float = 0.45):
    """Place (key_left, key_right, value) triples into a two-choice cuckoo
    table.  Returns (packed int32 (size, 4) [kl, kr, v, 0], size, seed1,
    seed2); key_left must be >= 0 for all triples (-1 marks empty slots)."""
    num = len(triples)
    size = max(64, _next_pow2(int(num / load_factor) + 1))

    def hash_py(l, r, seed, mask):
        # pure-int mirror of cuckoo_hash (uint32 arithmetic)
        h = (((l * 0x9E3779B1) ^ (r * 0x85EBCA77) ^ seed)) & 0xFFFFFFFF
        h ^= h >> 15
        h = (h * 0xC2B2AE3D) & 0xFFFFFFFF
        h ^= h >> 13
        return h & mask

    rng = np.random.RandomState(0)
    for _attempt in range(32):
        seed1 = int(rng.randint(1, 1 << 31))
        seed2 = int(rng.randint(1, 1 << 31))
        mask = size - 1
        if num:
            arr = np.asarray(triples, dtype=np.int64)
            h1 = cuckoo_hash(arr[:, 0], arr[:, 1], seed1, size)
        else:
            arr = np.zeros((0, 3), dtype=np.int64)
            h1 = np.zeros(0, dtype=np.int64)
        # python-list slot store (fast scalar access during kicks)
        slot_kl = [-1] * size
        slot_kr = [-1] * size
        slot_v = [0] * size
        ok = True
        max_kicks = 64 + 4 * max(1, num).bit_length()
        for i in range(num):
            cl, cr, cv = int(arr[i, 0]), int(arr[i, 1]), int(arr[i, 2])
            slot = int(h1[i])
            placed = False
            for _ in range(max_kicks):
                if slot_kl[slot] < 0:
                    slot_kl[slot], slot_kr[slot], slot_v[slot] = cl, cr, cv
                    placed = True
                    break
                ol, orr, ov = slot_kl[slot], slot_kr[slot], slot_v[slot]
                slot_kl[slot], slot_kr[slot], slot_v[slot] = cl, cr, cv
                cl, cr, cv = ol, orr, ov
                s1 = hash_py(cl, cr, seed1, mask)
                slot = hash_py(cl, cr, seed2, mask) if slot == s1 else s1
            if not placed:
                ok = False
                break
        if ok:
            packed = np.zeros((size, 4), dtype=np.int32)
            packed[:, 0] = slot_kl
            packed[:, 1] = slot_kr
            packed[:, 2] = slot_v
            return packed, size, seed1, seed2
        size <<= 1  # give the next attempt more room
    raise InvalidConfigError("cuckoo table build failed")


@dataclass
class CuckooPairTable:
    """Two-choice cuckoo hash table of merge pairs, packed for row gathers.

    ``packed`` is int32 (size, 4): [key_left, key_right, merged_rank, 0]
    with key_left == -1 marking empty slots.  A query probes exactly two
    slots: ``cuckoo_hash(l, r, seed1)`` and ``cuckoo_hash(l, r, seed2)``.
    """

    packed: np.ndarray
    size: int
    seed1: int
    seed2: int
    num_pairs: int

    @classmethod
    def build(cls, ranks: dict[bytes, int], load_factor: float = 0.45
              ) -> "CuckooPairTable":
        if ranks and max(ranks.values()) >= RANK_LIMIT:
            raise InvalidConfigError(
                "vocab rank >= 2^24 unsupported by the device merge kernel")
        pairs = _enumerate_pairs(ranks)
        packed, size, seed1, seed2 = _cuckoo_place(pairs, load_factor)
        return cls(packed=packed, size=size, seed1=seed1, seed2=seed2,
                   num_pairs=len(pairs))

    def lookup_host(self, left: int, right: int) -> int:
        for seed in (self.seed1, self.seed2):
            s = int(cuckoo_hash(left, right, seed, self.size))
            if self.packed[s, 0] == left and self.packed[s, 1] == right:
                return int(self.packed[s, 2])
        return -1

    def byte_pair_dense(self) -> np.ndarray:
        """Dense (65536,) int32 table of byte-byte merges: entry l*256+r is
        the merged rank of single-byte tokens (l, r), or INT32_MAX.  The
        first merge round only ever queries byte pairs, so its probe pass
        is one small-table gather."""
        INF = np.int32(2**31 - 1)
        dense = np.full(65536, INF, dtype=np.int32)
        ls = np.repeat(np.arange(256, dtype=np.int64), 256)
        rs = np.tile(np.arange(256, dtype=np.int64), 256)
        for seed in (self.seed1, self.seed2):
            slots = cuckoo_hash(ls, rs, seed, self.size)
            hit = ((self.packed[slots, 0] == ls)
                   & (self.packed[slots, 1] == rs))
            dense[np.where(hit)[0]] = self.packed[slots[hit], 2]
        return dense


def poly_sig(data: bytes, k: int) -> int:
    """Polynomial rolling signature ``sum b_i * k^(L-1-i) mod 2^32``.

    The hash of a concatenation is ``h_a * k^len_b + h_b``, so the flat
    engine (ops/flat.py) computes every piece's signature with one
    segmented scan.  Mirrored exactly there."""
    h = 0
    for b in data:
        h = (h * k + b) & 0xFFFFFFFF
    return h


def poly_sig31(data: bytes, k: int) -> int:
    """31-bit polynomial signature (non-negative, so it rides the same
    cuckoo probe as (left, right) pair keys)."""
    return poly_sig(data, k) & 0x7FFFFFFF


@dataclass
class CuckooPieceTable:
    """Whole-piece (poly_sig31, length) -> rank cuckoo index: the flat
    engine's fast path (reference engine semantics: a piece whose bytes
    ARE a vocab token encodes as that token before any merging —
    src/tekkenizer.rs:125).

    Two row gathers a lookup (the same ``probe2`` as pair lookups).  The
    multiplier ``k`` is chosen at build time so that no two vocab tokens
    share a (signature, length) pair: a match names a unique candidate,
    which callers byte-verify against the decode table; exactness never
    rests on the hash.
    """

    packed: np.ndarray      # (size, 4) int32 [sig31, len, rank, 0]
    size: int
    k: int
    seed1: int
    seed2: int

    # odd multipliers tried in order at build time
    _K_CANDIDATES = (0x01000193, 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D,
                     0x27D4EB2F, 0x165667B1, 0x5851F42D, 0x41C64E6D)

    @classmethod
    def build(cls, ranks: dict[bytes, int], load_factor: float = 0.45
              ) -> "CuckooPieceTable":
        for k in cls._K_CANDIDATES:
            sigs = set()
            collision = False
            for token_bytes in ranks:
                key = (poly_sig31(token_bytes, k), len(token_bytes))
                if key in sigs:
                    collision = True
                    break
                sigs.add(key)
            if not collision:
                break
        else:
            raise InvalidConfigError("piece table: no collision-free "
                                     "multiplier found")

        triples = [(poly_sig31(b, k), len(b), r) for b, r in ranks.items()]
        packed, size, seed1, seed2 = _cuckoo_place(triples, load_factor)
        return cls(packed=packed, size=size, k=k, seed1=seed1, seed2=seed2)

    def lookup_host(self, piece: bytes, decode_table: "DecodeTable") -> int:
        sig = poly_sig31(piece, self.k)
        for seed in (self.seed1, self.seed2):
            s = int(cuckoo_hash(sig, len(piece), seed, self.size))
            if (self.packed[s, 0] == sig and self.packed[s, 1] == len(piece)
                    and self.packed[s, 2] >= 0):
                r = int(self.packed[s, 2])
                return r if decode_table.token_bytes(r) == piece else -1
        return -1

    def direct_map(self, ranks: dict[bytes, int], slots_per_entry: int = 16,
                   max_log2: int = 22, _min_log2: int = 14
                   ) -> tuple[np.ndarray, int]:
        """Single-probe candidate table: (size, 4) int32 rows
        [sig31, len, rank, 0], slot = cuckoo_hash(sig, len, seed).
        Returns (table, seed).

        On a build-time slot collision the SHORTER token wins (a frequency
        heuristic) — UNLESS a collider is *greedy-unstable* (its own greedy
        merge does not reproduce it, e.g. a token with no in-vocab
        two-token split): such a token depends on the whole-piece probe
        for exactness, so it always wins its slot.  Losing a greedy-STABLE
        entry is harmless (callers byte-verify every candidate and route
        misses to the merge path, which reproduces a stable token).  If
        two unstable tokens collide, the table is regrown/reseeded until
        every unstable token holds a slot; a build that cannot satisfy
        this raises."""
        from .oracle import byte_pair_merge_no_whole

        live = self.packed[self.packed[:, 2] >= 0]
        base = max(1 << _min_log2, min(1 << max_log2,
                                       _next_pow2(slots_per_entry *
                                                  max(1, len(live)))))

        by_rank: dict[int, bytes] = {r: b for b, r in ranks.items()}
        stab_cache: dict[int, bool] = {}

        def stable(rank: int) -> bool:
            got = stab_cache.get(rank)
            if got is None:
                b = by_rank[rank]
                got = (len(b) < 2
                       or byte_pair_merge_no_whole(b, ranks) == [rank])
                stab_cache[rank] = got
            return got

        # shortest-first, ties by rank: the FIRST row of a slot group is the
        # default winner
        order = np.lexsort((live[:, 2].astype(np.int64),
                            live[:, 1].astype(np.int64)))
        rows = live[order]
        sigs = rows[:, 0].astype(np.int64)
        lens = rows[:, 1].astype(np.int64)

        seeds = [self.seed1] + [
            (self.seed1 + i * 0x632BE59B) & 0x7FFFFFFF or 1
            for i in range(1, 8)]
        for seed in seeds:
            size = base
            while size <= (1 << max_log2):
                slots = cuckoo_hash(sigs, lens, seed, size)
                dm = np.zeros((size, 4), dtype=np.int32)
                dm[:, 2] = -1
                # longest-first scatter: duplicate-index writes keep the
                # LAST one, i.e. the shortest (lowest-rank on ties) row
                dm[slots[::-1]] = rows[::-1]
                # collision groups only: an unstable collider must override
                # the heuristic winner
                grp = np.argsort(slots, kind="stable")
                gs = slots[grp]
                dup = np.flatnonzero(gs[1:] == gs[:-1])
                ok = True
                gi = 0
                while gi < len(dup):
                    lo = dup[gi]
                    hi = lo + 1
                    while hi < len(gs) - 1 and gs[hi + 1] == gs[lo]:
                        hi += 1
                    members = grp[lo:hi + 1]
                    unstable = [m for m in members
                                if not stable(int(rows[m, 2]))]
                    if len(unstable) > 1:
                        ok = False
                        break
                    if unstable:
                        dm[gs[lo]] = rows[unstable[0]]
                    while gi < len(dup) and dup[gi] < hi:
                        gi += 1
                if ok:
                    return dm, seed
                size <<= 1
        raise InvalidConfigError(
            "direct_map: could not give every greedy-unstable token a slot")


def _le_words(data: bytes, n_words: int) -> list[int]:
    """Little-endian uint32 words of ``data`` zero-padded to 4*n_words."""
    buf = data + b"\x00" * (4 * n_words - len(data))
    return [int.from_bytes(buf[4 * k:4 * k + 4], "little")
            for k in range(n_words)]


def word_hash(w0, w1, w2, length, seed: int, table_size: int):
    """Slot hash of a piece's first 12 content bytes + length — uint32
    arithmetic, mirrored exactly by the stage-1 kernel and its plain
    version (ops/hashing.py, csrc/stage1_compact.cu)."""
    a = np.asarray(w0).astype(np.uint32)
    b = np.asarray(w1).astype(np.uint32)
    c = np.asarray(w2).astype(np.uint32)
    ln = np.asarray(length).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = ((a * _HC1) ^ (b * _HC2) ^ (c * _HC3)
             ^ (ln * np.uint32(0x27D4EB2F)) ^ np.uint32(seed))
        h ^= h >> np.uint32(15)
        h *= _HC3
        h ^= h >> np.uint32(13)
    return (h & np.uint32(table_size - 1)).astype(np.int64)


@dataclass
class WordDirectMap:
    """Word-exact single-probe whole-piece table: the packed pipeline's fast
    path (reference engine semantics: a piece whose bytes ARE a vocab token
    encodes as that token before any merging — src/tekkenizer.rs:125).

    Rows are int32 (size, 4) ``[w0, w1, w2, meta]`` (or (size, 8)
    ``[w0..w5, meta, 0]`` in wide mode), where w_k is the token's k-th
    little-endian content dword zero-padded, and ``meta = rank*32 + len``
    (-1 marks empty).  The full content (up to ``max_len`` = 12 narrow /
    24 wide bytes) plus the length is stored IN the row, so a probe is ONE
    row gather + word compares, exact with no byte-verify gather.

    Only tokens with 2 <= len <= max_len are stored; longer pieces take the
    merge path (or the host splice).  That is exact for greedy-STABLE
    tokens (their merge reproduces them); greedy-UNSTABLE tokens must be
    probe-reachable, so on slot collisions an unstable token always wins
    (regrow/reseed on unstable-unstable conflicts), and a vocab with an
    unstable token longer than ``max_len`` makes ``build`` raise.
    """

    rows: np.ndarray
    size: int
    seed: int
    max_len: int
    n_words: int

    @classmethod
    def build(cls, ranks: dict[bytes, int], wide: bool = False,
              slots_per_entry: int = 16, max_log2: int = 22,
              _min_log2: int = 14) -> "WordDirectMap":
        from .oracle import byte_pair_merge_no_whole

        max_len = 24 if wide else 12
        n_words = 6 if wide else 3
        width = 8 if wide else 4

        stab_cache: dict[int, bool] = {}

        def stable(b: bytes, rank: int) -> bool:
            got = stab_cache.get(rank)
            if got is None:
                got = byte_pair_merge_no_whole(b, ranks) == [rank]
                stab_cache[rank] = got
            return got

        entries = []  # (w0..w{n-1}, meta) per token, shortest-first
        for b, r in sorted(ranks.items(), key=lambda kv: (len(kv[0]),
                                                          kv[1])):
            if len(b) < 2:
                continue
            if len(b) > max_len:
                if not stable(b, r):
                    raise InvalidConfigError(
                        f"vocab has a greedy-unstable token of "
                        f"{len(b)} bytes (> {max_len}); word probe "
                        f"cannot guarantee exactness")
                continue
            entries.append((b, r, _le_words(b, n_words)))

        arr = np.zeros((len(entries), width), dtype=np.int32)
        for i, (b, r, ws) in enumerate(entries):
            for k, w in enumerate(ws):
                arr[i, k] = np.uint32(w).view(np.int32) if w < (1 << 31) \
                    else np.int32(w - (1 << 32))
            arr[i, n_words] = r * 32 + len(b)
        lens = np.asarray([len(b) for b, _, _ in entries], dtype=np.int64)
        w0 = arr[:, 0].astype(np.int64) & 0xFFFFFFFF
        w1 = arr[:, 1].astype(np.int64) & 0xFFFFFFFF
        w2 = arr[:, 2].astype(np.int64) & 0xFFFFFFFF

        base = max(1 << _min_log2, min(1 << max_log2,
                                       _next_pow2(slots_per_entry *
                                                  max(1, len(entries)))))
        seeds = [0x9E3779B9] + [
            (0x9E3779B9 + i * 0x632BE59B) & 0x7FFFFFFF or 1
            for i in range(1, 8)]
        for seed in seeds:
            size = base
            while size <= (1 << max_log2):
                slots = word_hash(w0, w1, w2, lens, seed, size)
                rows = np.zeros((size, width), dtype=np.int32)
                rows[:, n_words] = -1
                # reversed scatter: final occupant is the FIRST (shortest,
                # lowest-rank) collider — the frequency heuristic winner
                rows[slots[::-1]] = arr[::-1]
                grp = np.argsort(slots, kind="stable")
                gs = slots[grp]
                dup = np.flatnonzero(gs[1:] == gs[:-1])
                ok = True
                gi = 0
                while gi < len(dup):
                    lo = dup[gi]
                    hi = lo + 1
                    while hi < len(gs) - 1 and gs[hi + 1] == gs[lo]:
                        hi += 1
                    members = grp[lo:hi + 1]
                    unstable = [m for m in members
                                if not stable(entries[m][0], entries[m][1])]
                    if len(unstable) > 1:
                        ok = False
                        break
                    if unstable:
                        rows[gs[lo]] = arr[unstable[0]]
                    while gi < len(dup) and dup[gi] < hi:
                        gi += 1
                if ok:
                    return cls(rows=rows, size=size, seed=seed,
                               max_len=max_len, n_words=n_words)
                size <<= 1
        raise InvalidConfigError(
            "word_direct_map: could not give every greedy-unstable token "
            "a slot")

    def lookup_host(self, piece: bytes) -> int:
        """Scalar probe for tests: returns rank or -1."""
        if not 2 <= len(piece) <= self.max_len:
            return -1
        ws = _le_words(piece, self.n_words)
        s = int(word_hash(ws[0], ws[1], ws[2], len(piece), self.seed,
                          self.size))
        row = self.rows[s]
        meta = int(row[self.n_words])
        if meta < 0 or (meta & 31) != len(piece):
            return -1
        for k in range(self.n_words):
            if (int(row[k]) & 0xFFFFFFFF) != ws[k]:
                return -1
        return meta >> 5


def fnv1a(data: bytes, basis: int = 0x811C9DC5) -> int:
    """Seeded FNV-1a 32-bit hash — mirrored in native/engine.cpp."""
    h = basis
    for b in data:
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


@dataclass
class PieceTable:
    """Whole-piece bytes -> rank hash index (the native engine's fast path:
    a piece whose bytes are a vocab token encodes as that single token
    before any merging, as the reference's engine does).

    Open addressing over a packed (size, 4) int32 array
    [signature, length, rank, 0] (rank -1 = empty).  The signature is the
    seeded FNV-1a hash of the token bytes, and the seed is chosen at build
    time so that no two vocab tokens share a (signature, length) pair — a
    signature+length match therefore identifies a unique candidate, which
    is then byte-verified (exactness does not rest on the hash).
    ``max_probes`` bounds the probe chains.
    """

    slots: np.ndarray       # (size, 4) int32 [sig, len, rank, 0]
    size: int
    basis: int
    max_probes: int

    @staticmethod
    def _sig_i32(sig: int) -> np.int32:
        return np.int32(sig - (1 << 32) if sig >= (1 << 31) else sig)

    @classmethod
    def build(cls, ranks: dict[bytes, int], load_factor: float = 0.5
              ) -> "PieceTable":
        size = max(64, _next_pow2(int(len(ranks) / load_factor) + 1))
        mask = size - 1
        for attempt in range(64):
            basis = (0x811C9DC5 + attempt * 0x9E3779B9) & 0xFFFFFFFF
            sigs = set()
            collision = False
            for token_bytes in ranks:
                key = (fnv1a(token_bytes, basis), len(token_bytes))
                if key in sigs:
                    collision = True
                    break
                sigs.add(key)
            if not collision:
                break
        else:
            raise InvalidConfigError("piece table: signature seed not found")

        slots = np.zeros((size, 4), dtype=np.int32)
        slots[:, 2] = -1
        max_probes = 1
        for token_bytes, rank in ranks.items():
            sig = fnv1a(token_bytes, basis)
            s = sig & mask
            probes = 1
            while slots[s, 2] >= 0:
                s = (s + 1) & mask
                probes += 1
            slots[s, 0] = cls._sig_i32(sig)
            slots[s, 1] = len(token_bytes)
            slots[s, 2] = rank
            max_probes = max(max_probes, probes)
        return cls(slots=slots, size=size, basis=basis, max_probes=max_probes)

    def lookup_host(self, piece: bytes, decode_table: "DecodeTable") -> int:
        mask = self.size - 1
        sig = fnv1a(piece, self.basis)
        sig_i = self._sig_i32(sig)
        s = sig & mask
        for _ in range(self.max_probes + 1):
            if self.slots[s, 2] < 0:
                return -1
            if self.slots[s, 0] == sig_i and self.slots[s, 1] == len(piece):
                # unique candidate by construction; byte-verify for exactness
                r = int(self.slots[s, 2])
                return r if decode_table.token_bytes(r) == piece else -1
            s = (s + 1) & mask
        return -1


@dataclass
class DecodeTable:
    """Flat byte-span arrays for rank -> bytes decode.

    ``flat``: all token bytes concatenated in rank order (uint8)
    ``offsets``: int32 array of length n_ranks+1; token r spans
    ``flat[offsets[r]:offsets[r+1]]``.
    """

    flat: np.ndarray
    offsets: np.ndarray
    max_token_len: int

    @classmethod
    def build(cls, ranks: dict[bytes, int]) -> "DecodeTable":
        n = len(ranks)
        by_rank: list[bytes] = [b""] * n
        for token_bytes, rank in ranks.items():
            by_rank[rank] = token_bytes
        offsets = np.zeros(n + 1, dtype=np.int32)
        for r, b in enumerate(by_rank):
            offsets[r + 1] = offsets[r] + len(b)
        flat = np.frombuffer(b"".join(by_rank), dtype=np.uint8).copy()
        max_len = max((len(b) for b in by_rank), default=0)
        return cls(flat=flat, offsets=offsets, max_token_len=max_len)

    def token_bytes(self, rank: int) -> bytes:
        return self.flat[self.offsets[rank]:self.offsets[rank + 1]].tobytes()

    def padded_rows(self, row_len: int | None = None) -> np.ndarray:
        """(n_ranks, row_len) uint8 array of token bytes, zero-padded.
        Flattened on the device, entry ``rank * row_len + offset`` is byte
        ``offset`` of token ``rank``: the flat engine's whole-piece verify
        is one element gather per input byte.  Tokens longer than row_len
        are all-zero rows (callers only verify pieces of <= row_len
        bytes)."""
        n = len(self.offsets) - 1
        L = row_len if row_len is not None else max(1, self.max_token_len)
        rows = np.zeros((n, L), dtype=np.uint8)
        for r in range(n):
            o0, o1 = int(self.offsets[r]), int(self.offsets[r + 1])
            if 0 < o1 - o0 <= L:
                rows[r, :o1 - o0] = self.flat[o0:o1]
        return rows

    def word_packed(self, max_len: int = 32) -> np.ndarray:
        """(n_ranks, max_len//4) int32 array of token bytes packed 4 per
        little-endian word, zero-padded; tokens longer than max_len are
        all-zero rows (they can never match a piece of <= max_len
        bytes)."""
        n = len(self.offsets) - 1
        words = np.zeros((n, max_len // 4), dtype=np.int32)
        buf = np.zeros(max_len, dtype=np.uint8)
        for r in range(n):
            o0, o1 = int(self.offsets[r]), int(self.offsets[r + 1])
            ln = o1 - o0
            if 0 < ln <= max_len:
                buf[:] = 0
                buf[:ln] = self.flat[o0:o1]
                words[r] = buf.view("<u4").astype(np.int64).astype(
                    np.uint32).view(np.int32)
        return words
