// tekken_tpu_torch native host engine: Tekken pre-tokenizer + BPE merge in
// C++ (a copy of the JAX package's tekken_tpu/native/engine.cpp; the two
// give the same result call for call, tests/test_torch_native.py).
//
// The host-side counterpart of the device kernels (csrc/): single-string
// encode, the host merge of the packed encode's miss spans and the
// overflow-row re-encode, mirroring how the reference delegates its hot
// loops to a native engine (reference: src/tekkenizer.rs:125 CoreBPE).
// Nothing here is a translation of that engine — the pre-tokenizer is the
// same closed-form boundary rule set as ops/pretokenize.py (derived from the
// hardcoded pattern, reference: src/tekkenizer.rs:123), and the merge loop is
// the leftmost-lowest-rank algorithm driven by the cuckoo pair table's hash
// layout (vocab.CuckooPairTable).
//
// Exposed as a C ABI for ctypes (native/engine.py):
//   tkn_create(packed cuckoo table, size, seed1, seed2, cls_table,
//              fold_table, n_codepoints, piece slots, piece size,
//              piece basis, vocab bytes, their length, vocab offsets,
//              n_ranks) -> handle
//   tkn_encode(handle, bytes, len, out, out_cap) -> n_tokens
//   tkn_encode_batch(handle, ...) (parallel over docs with a thread pool)
//   tkn_merge_spans(handle, ...) (pre-split pieces)
//   tkn_decode(handle, ranks, n, out, out_cap) -> n_bytes
//   tkn_destroy(handle)
//
// Character classes come from the same unicode_tables.npz content the device
// path uses (passed in at create), so the engines agree by construction.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int32_t INF = INT32_MAX;

struct Slot {
  int32_t kl, kr, val, pad;
};

enum : uint8_t { C_LETTER = 1, C_NUMBER = 2, C_WS = 4 };
enum Cls { L, N, W, P };

struct CharInfo {
  Cls g;
  bool nl;     // \r or \n
  bool space;  // literal ' '
  bool apos;   // '
  uint8_t fold;
};

struct Engine {
  // packed cuckoo table: one 16-byte slot per entry (vocab.CuckooPairTable
  // layout) — a probe touches at most two cache lines.
  std::vector<Slot> table;
  uint32_t mask = 0;
  uint32_t seed1 = 0, seed2 = 0;
  // unicode tables: cls bits 1=L 2=N 4=WS; fold 1..8 = s t r e v m l d
  std::vector<uint8_t> cls, fold;
  // whole-piece fast path (vocab.PieceTable + DecodeTable): FNV-1a index
  // with exact byte verification against the flat vocab bytes
  std::vector<int32_t> piece_slot;   // slot -> rank (-1 empty)
  uint32_t piece_mask = 0;
  uint32_t piece_basis = 0x811C9DC5u;
  std::vector<uint8_t> vocab_flat;
  std::vector<int32_t> vocab_off;    // n_ranks + 1
  // ASCII fast-path class table: bytes ARE chars, one L1-resident lookup
  CharInfo ascii_ci[128];
};

inline uint32_t fnv1a(const uint8_t* p, int32_t n, uint32_t basis) {
  uint32_t h = basis;
  for (int32_t i = 0; i < n; i++) h = (h ^ p[i]) * 0x01000193u;
  return h;
}

inline int32_t lookup_piece(const Engine& e, const uint8_t* p, int32_t n) {
  if (e.piece_slot.empty()) return -1;
  uint32_t s = fnv1a(p, n, e.piece_basis) & e.piece_mask;
  for (;;) {
    int32_t r = e.piece_slot[s];
    if (r < 0) return -1;
    int32_t off = e.vocab_off[r];
    if (e.vocab_off[r + 1] - off == n &&
        std::memcmp(e.vocab_flat.data() + off, p, n) == 0)
      return r;
    s = (s + 1) & e.piece_mask;
  }
}

inline uint32_t pair_hash(uint32_t l, uint32_t r, uint32_t seed,
                          uint32_t mask) {
  uint32_t h = (l * 0x9E3779B1u) ^ (r * 0x85EBCA77u) ^ seed;
  h ^= h >> 15;
  h *= 0xC2B2AE3Du;
  h ^= h >> 13;
  return h & mask;
}

inline int32_t probe(const Engine& e, int32_t l, int32_t r) {
  const Slot& a = e.table[pair_hash((uint32_t)l, (uint32_t)r, e.seed1,
                                    e.mask)];
  if (a.kl == l && a.kr == r) return a.val;
  const Slot& b = e.table[pair_hash((uint32_t)l, (uint32_t)r, e.seed2,
                                    e.mask)];
  if (b.kl == l && b.kr == r) return b.val;
  return INF;
}

// ---------------------------------------------------------------- utf-8

struct Char {
  uint32_t cp;
  int32_t byte_off;  // offset of lead byte
};

inline int decode_utf8(const uint8_t* p, const uint8_t* end, uint32_t* cp) {
  uint8_t b = p[0];
  if (b < 0x80) { *cp = b; return 1; }
  if (b < 0xE0) {
    if (p + 1 >= end) { *cp = b; return 1; }
    *cp = ((b & 0x1Fu) << 6) | (p[1] & 0x3Fu);
    return 2;
  }
  if (b < 0xF0) {
    if (p + 2 >= end) { *cp = b; return 1; }
    *cp = ((b & 0x0Fu) << 12) | ((p[1] & 0x3Fu) << 6) | (p[2] & 0x3Fu);
    return 3;
  }
  if (p + 3 >= end) { *cp = b; return 1; }
  *cp = ((b & 0x07u) << 18) | ((p[1] & 0x3Fu) << 12) | ((p[2] & 0x3Fu) << 6) |
        (p[3] & 0x3Fu);
  return 4;
}

// ---------------------------------------------------------------- classes

inline CharInfo classify(const Engine& e, uint32_t cp) {
  uint8_t c = cp < e.cls.size() ? e.cls[cp] : 0;
  CharInfo ci;
  ci.g = (c & C_LETTER) ? L : (c & C_NUMBER) ? N : (c & C_WS) ? W : P;
  ci.nl = (cp == 0x0A || cp == 0x0D);
  ci.space = (cp == 0x20);
  ci.apos = (cp == 0x27);
  ci.fold = cp < e.fold.size() ? e.fold[cp] : 0;
  return ci;
}

enum Fold : uint8_t { F0 = 0, FS, FT, FR, FE, FV, FM, FL, FD };

// ---------------------------------------------------------------- splitter
//
// Sequential walk emitting piece boundaries per the leftmost-first
// alternation semantics of the hardcoded Tekken pattern (same rule
// derivation as ops/pretokenize.py; fuzz-verified against the regex oracle).

struct SplitScratch {
  std::vector<CharInfo> ci;
  std::vector<int32_t> off;
};

// char-index accessors: the walk below is shared by the UTF-8 path
// (decoded CharInfo/offset vectors) and the ASCII fast path (bytes ARE
// chars: a 128-entry table lookup per access, no vectors at all)
struct VecCI {
  const CharInfo* ci;
  const int32_t* off_;
  const CharInfo& operator[](int32_t k) const { return ci[k]; }
  int32_t off(int32_t k) const { return off_[k]; }
};

struct AsciiCI {
  const uint8_t* data;
  const CharInfo* tab;  // Engine::ascii_ci, 128 entries
  const CharInfo& operator[](int32_t k) const { return tab[data[k] & 0x7F]; }
  int32_t off(int32_t k) const { return k; }
};

inline bool all_ascii(const uint8_t* p, int64_t n) {
  uint64_t acc = 0;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t w;
    std::memcpy(&w, p + i, 8);
    acc |= w;
  }
  for (; i < n; i++) acc |= p[i];
  return (acc & 0x8080808080808080ull) == 0;
}

template <class CIA>
static void walk_pieces(CIA ci, int32_t nc, int32_t len,
                        std::vector<int32_t>& starts) {
  starts.clear();
  int32_t k = 0;
  while (k < nc) {
    starts.push_back(ci.off(k));
    const CharInfo& c = ci[k];
    if (c.g == N) {
      // \p{N}{1,3}
      int32_t t = 1;
      while (t < 3 && k + t < nc && ci[k + t].g == N) t++;
      k += t;
      continue;
    }
    if (c.g == L) {
      int32_t t = k;
      while (t < nc && ci[t].g == L) t++;
      k = t;
      continue;
    }
    if (c.g == P) {
      // contraction: free ' followed by letter branch
      if (c.apos && k + 1 < nc && ci[k + 1].g == L) {
        uint8_t f1 = ci[k + 1].fold;
        bool two = false, one = (f1 == FS || f1 == FT || f1 == FM || f1 == FD);
        if (!one && k + 2 < nc && ci[k + 2].g == L) {
          uint8_t f2 = ci[k + 2].fold;
          two = ((f1 == FR || f1 == FV) && f2 == FE) || (f1 == FL && f2 == FL);
        }
        if (one) { k += 2; continue; }
        if (two) { k += 3; continue; }
      }
      // [^\r\n\p{L}\p{N}]? \p{L}+  — single free punct absorbed by letters
      if (k + 1 < nc && ci[k + 1].g == L) {
        int32_t t = k + 1;
        while (t < nc && ci[t].g == L) t++;
        k = t;
        continue;
      }
      //  ?[^\s\p{L}\p{N}]+[\r\n]*
      int32_t t = k;
      while (t < nc && ci[t].g == P) t++;
      while (t < nc && ci[t].nl) t++;
      k = t;
      continue;
    }
    // whitespace
    int32_t rend = k;
    while (rend < nc && ci[rend].g == W) rend++;
    // T = [k, rend)
    int32_t nl_last = -1;
    for (int32_t t = rend - 1; t >= k; t--) {
      if (ci[t].nl) { nl_last = t; break; }
    }
    if (nl_last >= 0) {
      // \s*[\r\n]+ up to last newline
      k = nl_last + 1;
      continue;  // boundary for tail (if any) on next loop iteration
    }
    // no newline in T
    bool x_exists = rend < nc;
    if (!x_exists) {  // \s+(?!\S) to EOF
      k = rend;
      continue;
    }
    int32_t tl = rend - k;
    if (tl >= 2) {
      // \s+(?!\S) leaves one char
      k = rend - 1;
      continue;
    }
    // single ws char before X
    const CharInfo& x = ci[rend];
    if (x.g == L && !c.nl) {
      // attach to letter run (alt2)
      int32_t t = rend;
      while (t < nc && ci[t].g == L) t++;
      k = t;
      continue;
    }
    if (x.g == P && c.space) {
      //  ?[^\s..]+[\r\n]*  with leading space
      int32_t t = rend;
      while (t < nc && ci[t].g == P) t++;
      while (t < nc && ci[t].nl) t++;
      k = t;
      continue;
    }
    // stands alone (\s+)
    k = rend;
  }
  starts.push_back(len);
}

static void split_pieces(const Engine& e, const uint8_t* data, int32_t len,
                         std::vector<int32_t>& starts, SplitScratch& ss) {
  if (all_ascii(data, len)) {
    walk_pieces(AsciiCI{data, e.ascii_ci}, len, len, starts);
    return;
  }
  // decode chars
  std::vector<CharInfo>& ci = ss.ci;
  std::vector<int32_t>& off = ss.off;
  ci.clear();
  off.clear();
  ci.reserve(len);
  off.reserve(len);
  const uint8_t* end = data + len;
  for (const uint8_t* p = data; p < end;) {
    uint32_t cp;
    int n = decode_utf8(p, end, &cp);
    ci.push_back(classify(e, cp));
    off.push_back((int32_t)(p - data));
    p += n;
  }
  walk_pieces(VecCI{ci.data(), off.data()}, (int32_t)ci.size(), len, starts);
}

// ---------------------------------------------------------------- merge
//
// Leftmost-lowest-rank merge over one piece; byte ranks are the identity for
// ranks < 256 (validated at vocab load, reference: src/tekkenizer.rs:792-798).

struct MergeScratch {
  std::vector<int32_t> rank, pr, nxt, prv;
  void ensure(int32_t n) {
    if ((int32_t)rank.size() < n) {
      rank.resize(n);
      pr.resize(n);
      nxt.resize(n);
      prv.resize(n);
    }
  }
};

static int32_t merge_piece(const Engine& e, const uint8_t* piece, int32_t n,
                           int32_t* out, MergeScratch& s) {
  if (n == 0) return 0;
  if (n == 1) { out[0] = piece[0]; return 1; }
  s.ensure(n);
  int32_t* rank = s.rank.data();
  int32_t* pr = s.pr.data();
  int32_t* nxt = s.nxt.data();
  int32_t* prv = s.prv.data();
  for (int32_t i = 0; i < n; i++) {
    rank[i] = piece[i];
    nxt[i] = i + 1;
    prv[i] = i - 1;
  }
  for (int32_t i = 0; i < n - 1; i++) pr[i] = probe(e, rank[i], rank[i + 1]);
  pr[n - 1] = INF;

  for (;;) {
    int32_t best = INF, m = -1;
    for (int32_t i = 0; i < n; i++) {
      if (pr[i] < best) { best = pr[i]; m = i; }
    }
    if (m < 0) break;
    int32_t j = nxt[m];
    int32_t nj = nxt[j];
    rank[m] = best;
    pr[j] = INF;
    nxt[m] = nj;
    if (nj < n) prv[nj] = m;
    pr[m] = (nj < n) ? probe(e, rank[m], rank[nj]) : INF;
    int32_t pm = prv[m];
    if (pm >= 0) pr[pm] = probe(e, rank[pm], rank[m]);
  }

  int32_t cnt = 0;
  for (int32_t i = 0; i < n; i = nxt[i]) out[cnt++] = rank[i];
  return cnt;
}

}  // namespace

extern "C" {

void* tkn_create(const int32_t* packed, int64_t size, int32_t seed1,
                 int32_t seed2, const uint8_t* cls_table,
                 const uint8_t* fold_table, int64_t n_codepoints,
                 const int32_t* piece_slot, int64_t piece_size,
                 int32_t piece_basis,
                 const uint8_t* vocab_flat, int64_t flat_len,
                 const int32_t* vocab_off, int64_t n_ranks) {
  Engine* e = new Engine();
  e->table.resize(size);
  std::memcpy(e->table.data(), packed, size * sizeof(Slot));
  e->mask = (uint32_t)(size - 1);
  e->seed1 = (uint32_t)seed1;
  e->seed2 = (uint32_t)seed2;
  e->cls.assign(cls_table, cls_table + n_codepoints);
  e->fold.assign(fold_table, fold_table + n_codepoints);
  if (piece_size > 0) {
    e->piece_slot.assign(piece_slot, piece_slot + piece_size);
    e->piece_mask = (uint32_t)(piece_size - 1);
    e->piece_basis = (uint32_t)piece_basis;
    e->vocab_flat.assign(vocab_flat, vocab_flat + flat_len);
    e->vocab_off.assign(vocab_off, vocab_off + n_ranks + 1);
  }
  for (uint32_t cp = 0; cp < 128; cp++) e->ascii_ci[cp] = classify(*e, cp);
  return e;
}

void tkn_destroy(void* h) { delete (Engine*)h; }

// Encode one document. Returns token count (<= len), -1 on overflow.
int64_t tkn_encode(void* h, const uint8_t* data, int64_t len, int32_t* out,
                   int64_t out_cap) {
  Engine& e = *(Engine*)h;
  if (out_cap < len) return -1;  // output can never exceed byte count
  thread_local std::vector<int32_t> starts;
  thread_local SplitScratch ss;
  thread_local MergeScratch ms;
  split_pieces(e, data, (int32_t)len, starts, ss);
  int64_t cnt = 0;
  for (size_t i = 0; i + 1 < starts.size(); i++) {
    const uint8_t* piece = data + starts[i];
    int32_t n = starts[i + 1] - starts[i];
    if (n > 1) {  // whole-piece fast path (result identical to merging)
      int32_t whole = lookup_piece(e, piece, n);
      if (whole >= 0) {
        out[cnt++] = whole;
        continue;
      }
    }
    cnt += merge_piece(e, piece, n, out + cnt, ms);
  }
  return cnt;
}

// Merge pre-split pieces (the device kernel's vocab misses): spans[i] =
// (starts[i], lens[i]) into buf.  Semantics identical to the oracle's
// byte_pair_merge: whole-piece lookup first, then greedy lowest-rank
// merging.  out receives tokens back-to-back; out_cnts[i] = tokens of
// span i.  Returns total tokens, -1 if out_cap < sum(lens).
int64_t tkn_merge_spans(void* h, const uint8_t* buf, const int32_t* starts,
                        const int32_t* lens, int64_t n_spans, int32_t* out,
                        int32_t* out_cnts, int64_t out_cap) {
  Engine& e = *(Engine*)h;
  thread_local MergeScratch ms;
  int64_t cnt = 0;
  for (int64_t i = 0; i < n_spans; i++) {
    const uint8_t* piece = buf + starts[i];
    int32_t n = lens[i];
    if (cnt + n > out_cap) return -1;
    int32_t c;
    int32_t whole = (n > 1) ? lookup_piece(e, piece, n) : -1;
    if (whole >= 0) {
      out[cnt] = whole;
      c = 1;
    } else {
      c = merge_piece(e, piece, n, out + cnt, ms);
    }
    out_cnts[i] = c;
    cnt += c;
  }
  return cnt;
}

// Decode a rank stream into concatenated bytes (the reference's decode
// byte concatenation, src/tekkenizer.rs:548-557; UTF-8/policy handling
// stays in Python).  Returns byte total; -1 on output overflow, -2 when
// the engine was built without a decode table, -3 on an out-of-range
// rank.  memcpy-bound: one thread saturates memory bandwidth.
int64_t tkn_decode(void* h, const int32_t* ranks, int64_t n, uint8_t* out,
                   int64_t out_cap) {
  Engine& e = *(Engine*)h;
  if (e.vocab_off.empty()) return -2;
  const int64_t n_ranks = (int64_t)e.vocab_off.size() - 1;
  const uint8_t* flat = e.vocab_flat.data();
  int64_t w = 0;
  for (int64_t i = 0; i < n; i++) {
    int32_t r = ranks[i];
    if (r < 0 || r >= n_ranks) return -3;
    int32_t lo = e.vocab_off[r];
    int32_t len = e.vocab_off[r + 1] - lo;
    if (w + len > out_cap) return -1;
    std::memcpy(out + w, flat + lo, (size_t)len);
    w += len;
  }
  return w;
}

// Encode a batch in parallel. docs: concatenated bytes; offsets: n_docs+1.
// out: caller buffer of total byte length; out_offsets: n_docs+1 (filled).
int64_t tkn_encode_batch(void* h, const uint8_t* docs, const int64_t* offsets,
                         int64_t n_docs, int32_t* out, int64_t* out_offsets,
                         int32_t n_threads) {
  Engine& e = *(Engine*)h;
  std::vector<int64_t> counts(n_docs, 0);
  std::atomic<int64_t> cursor{0};
  if (n_threads <= 0) n_threads = (int32_t)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if ((int64_t)n_threads > n_docs) n_threads = (int32_t)n_docs;
  // the worker loop is compute-bound: more threads than cores only adds
  // contention (measured: oversubscription cost ~20% on a 2-core host)
  int32_t hw = (int32_t)std::thread::hardware_concurrency();
  if (hw >= 1 && n_threads > hw) n_threads = hw;

  auto worker = [&]() {
    for (;;) {
      int64_t d = cursor.fetch_add(1);
      if (d >= n_docs) return;
      const uint8_t* p = docs + offsets[d];
      int64_t len = offsets[d + 1] - offsets[d];
      // write into the doc's own byte-span slot (token count <= byte count)
      counts[d] = tkn_encode(&e, p, len, out + offsets[d], len);
    }
  };
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();

  // compact: move each doc's tokens into contiguous output
  out_offsets[0] = 0;
  int64_t w = 0;
  for (int64_t d = 0; d < n_docs; d++) {
    int64_t c = counts[d];
    if (w != offsets[d]) {
      std::memmove(out + w, out + offsets[d], c * sizeof(int32_t));
    }
    w += c;
    out_offsets[d + 1] = w;
  }
  return w;
}

}  // extern "C"
