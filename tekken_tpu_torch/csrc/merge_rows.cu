// Compact-shift BPE merge of piece rows, for Hopper: the merge buckets of
// one packed encode in one launch, and the (B2, P) matrix form.
//
// Replaces: tekken_tpu/ops/pallas_merge.py `_round_kernel` (launched by
// `_round_fn` and `merge_rows_compact_fused`) together with the XLA
// cuckoo-row gather that fed it each round, and, for the bucket entry, the
// tensor code around it in tekken_tpu/ops/packed.py `_merge_buckets` (the
// lane gather, the first round's dense-table ranks, the token scatter).
// Two C entry points share one merge core:
//   tk_merge_rows     rank (B2, P) and n_seg (B2,) after every row has
//                     merged to completion (or after `max_rounds` rounds),
//                     bit for bit the plain `merge_rows_compact` in
//                     ops/bpe.py;
//   tk_merge_buckets  every row of up to three bucket tiers of one encode:
//                     a row loads its bucket word, takes its piece's bytes
//                     as lanes, merges, and writes its tokens into `tok` in
//                     place, bit for bit the plain `merge_buckets_reference`
//                     in ops/merge.py.
//
// Semantics kept exactly: each round merges the leftmost lowest-rank pair
// of a row (the fused key (min(pr, 2^24) << lane_bits) | lane, so ranks
// >= 2^24 count as absent), one merge per row per round, and closes the
// gap by shifting the lanes right of it; the two new pair ranks come from
// the two-choice cuckoo table (vocab.cuckoo_hash with the table's seeds).
//
// What bounds it on this card: latency, not bytes.  A bucket row reads its
// 8-byte word, its geometry and its P lane bytes, and writes its tokens:
// a few MB a call.  Each merge round costs a P-lane argmin and two
// dependent cuckoo probes (16-byte rows of a table that fits the 50 MB
// L2).  What a call costs the caller was the launches and the tensor ops
// around them; the bucket entry does the work of all of one encode's
// tiers in one launch.
//
// Design.  On the TPU the table gather had to stay outside the kernel
// (in-kernel gathers miscompiled on Mosaic), so every round was a launch
// pair.  Here one thread owns one row and probes the table itself, looping
// rounds until its row has no mergeable pair.  The row lives in registers:
// PMAX lanes fully unrolled, the argmin an unrolled min chain over the
// fused keys, and the compact shift a select per lane on lane < q, == q,
// > q (as the TPU kernel did), so no lane is indexed by a value known only
// at run time.  Lanes past the row's P hold -1 and absent pair ranks, which
// the shift and the argmin treat as the reference treats the lanes past
// its end.  A P-lane row merges at most P - 1 times, so P rounds bound the
// loop when no fixed count is given, and a row whose merges end early
// stops there: later rounds would change nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kInf = 0x7fffffff;
constexpr int kCap = 1 << 24;
constexpr int kMaxBuckets = 3;

constexpr uint32_t K1 = 0x9E3779B1u;
constexpr uint32_t K2 = 0x85EBCA77u;
constexpr uint32_t K3 = 0xC2B2AE3Du;

__device__ __forceinline__ uint32_t pair_hash(int l, int r, uint32_t seed) {
  uint32_t h = (static_cast<uint32_t>(l) * K1) ^
               (static_cast<uint32_t>(r) * K2) ^ seed;
  h ^= h >> 15;
  h *= K3;
  h ^= h >> 13;
  return h;
}

// the cuckoo pair table: (size, 4) int32 rows [left, right, merged, 0]
struct Pairs {
  const int4* table;
  uint32_t mask, s1, s2;

  // merged rank of (l, r), or kInf when absent or when either is negative
  __device__ __forceinline__ int probe(int l, int r) const {
    if (l < 0 || r < 0) return kInf;
    const int4 a = __ldg(table + (pair_hash(l, r, s1) & mask));
    if (a.x == l && a.y == r) return a.z;
    const int4 b = __ldg(table + (pair_hash(l, r, s2) & mask));
    if (b.x == l && b.y == r) return b.z;
    return kInf;
  }
};

// bits of the lane index in the fused key for PMAX lanes
template <int PMAX>
__host__ __device__ constexpr int lane_bits() {
  return PMAX <= 2 ? 1 : PMAX <= 4 ? 2 : PMAX <= 8 ? 3 : PMAX <= 16 ? 4
       : PMAX <= 32 ? 5 : 6;
}

// The merge core: up to max_rounds rounds on one row of n segments.
// Returns the row's segment count after.
template <int PMAX>
__device__ __forceinline__ int merge_row(int (&rank)[PMAX], int (&pr)[PMAX],
                                         int n, int max_rounds,
                                         const Pairs& t) {
  constexpr int kBits = lane_bits<PMAX>();
  for (int round = 0; round < max_rounds; ++round) {
    // fused min + argmin: the leftmost lowest rank wins
    int key = kInf;
#pragma unroll
    for (int k = 0; k < PMAX; ++k) {
      const int p = pr[k] < kCap ? pr[k] : kCap;
      const int kk = (p << kBits) | k;
      key = kk < key ? kk : key;
    }
    const int m = key >> kBits;
    if (m >= kCap) break;   // no mergeable pair left in this row
    const int q = key & ((1 << kBits) - 1);

    int left = -1, right = -1;
#pragma unroll
    for (int k = 0; k < PMAX; ++k) {
      if (k == q - 1) left = rank[k];
      if (k == q + 2 && k < n) right = rank[k];
    }
    const int new_pl = t.probe(left, m);
    const int new_pq = t.probe(m, right);

    // lane q takes the merged rank, the lanes right of it shift left
#pragma unroll
    for (int k = 0; k < PMAX; ++k) {
      const int r_next = k + 1 < PMAX ? rank[k + 1] : -1;
      const int p_next = k + 1 < PMAX ? pr[k + 1] : kInf;
      rank[k] = k < q ? rank[k] : (k == q ? m : r_next);
      pr[k] = k < q - 1 ? pr[k]
            : (k == q - 1 ? new_pl : (k == q ? new_pq : p_next));
    }
    n -= 1;
  }
  return n;
}

// Load a row, merge it, store it.  Rows gives load(i, rank, pr, &n, &ctx)
// (false: nothing to do for row i) and store(i, ctx, rank, n).
template <int PMAX, class Rows>
__device__ __forceinline__ void merge_one(const Rows& rows, int i,
                                          const Pairs& t) {
  int rank[PMAX], pr[PMAX], n, ctx;
  if (!rows.template load<PMAX>(i, rank, pr, &n, &ctx)) return;
  n = merge_row<PMAX>(rank, pr, n, rows.rounds, t);
  rows.template store<PMAX>(i, ctx, rank, n);
}

// (B2, P) matrix rows in, (B2, P) rows and counts out
struct MatrixRows {
  const int32_t* rank_in;
  const int32_t* pr_in;
  const int32_t* n_in;
  int32_t* rank_out;
  int32_t* n_out;
  int P, rounds;

  template <int PMAX>
  __device__ __forceinline__ bool load(int i, int (&rank)[PMAX],
                                       int (&pr)[PMAX], int* n,
                                       int* ctx) const {
    const size_t off = static_cast<size_t>(i) * P;
#pragma unroll
    for (int k = 0; k < PMAX; ++k) {
      rank[k] = k < P ? rank_in[off + k] : -1;
      pr[k] = k < P ? pr_in[off + k] : kInf;
    }
    *n = n_in[i];
    *ctx = 0;
    return true;
  }
  template <int PMAX>
  __device__ __forceinline__ void store(int i, int, const int (&rank)[PMAX],
                                        int n) const {
    const size_t off = static_cast<size_t>(i) * P;
#pragma unroll
    for (int k = 0; k < PMAX; ++k)
      if (k < P) rank_out[off + k] = rank[k];
    n_out[i] = n;
  }
};

// What every bucket row reads and writes.
struct BucketData {
  const int64_t* w;          // bucket words: live bit, fb bit, index << 2
  const int32_t* start;      // routed: (B, R) row-local piece starts; flat:
                             // null (the word holds the flat start)
  const int32_t* plen;       // piece lengths at the word's index
  int R;                     // routed row width
  int N;                     // bytes in the buffer
  const int64_t* byte_rank;  // (N,) byte value, -1 outside the rows
  const int32_t* dense;      // (65536,) first-round pair ranks
  int32_t* tok;              // (N + 1,) token at each byte, in place
};

// Rows lo .. lo + rows of the bucket words, P lanes a row.  A live,
// non-fallback row's piece starts at byte s and is plen long; its lanes
// are the piece's bytes, its tokens go to tok[s + k].
struct BucketRows {
  BucketData d;
  int lo, P, rounds;

  template <int PMAX>
  __device__ __forceinline__ bool load(int i, int (&rank)[PMAX],
                                       int (&pr)[PMAX], int* n,
                                       int* ctx) const {
    const long long wv = d.w[lo + i];
    if ((wv & 3) != 1) return false;          // dead, or a fallback row
    const int j = static_cast<int>(wv >> 2);
    const int jj = j < 0 ? 0 : (j > d.N - 1 ? d.N - 1 : j);
    int s = j;
    if (d.start != nullptr) {
      s = d.start[jj];
      if (s >= 0) s += (jj / d.R) * d.R;
    }
    if (s < 0) return false;                  // no lane of it is in
    const int len = d.plen[jj];
    const int nl = len < P ? len : P;
#pragma unroll
    for (int k = 0; k < PMAX; ++k) {
      int b = s + k;
      b = b > d.N - 1 ? d.N - 1 : b;
      rank[k] = k < nl ? static_cast<int>(d.byte_rank[b]) : -1;
    }
    // the first round only pairs single bytes: the dense table
#pragma unroll
    for (int k = 0; k < PMAX; ++k) {
      const int right = k + 1 < PMAX ? rank[k + 1] : -1;
      pr[k] = (k + 1 < nl && rank[k] >= 0 && right >= 0)
                  ? __ldg(d.dense + rank[k] * 256 + right) : kInf;
    }
    *n = len;
    *ctx = s;
    return true;
  }
  template <int PMAX>
  __device__ __forceinline__ void store(int, int s, const int (&rank)[PMAX],
                                        int n) const {
#pragma unroll
    for (int k = 0; k < PMAX; ++k)
      if (k < P && k < n && s + k < d.N) d.tok[s + k] = rank[k];
  }
};

template <int PMAX>
__global__ void __launch_bounds__(kThreads)
merge_rows_kernel(MatrixRows rows, int B2, Pairs t) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < B2) merge_one<PMAX>(rows, i, t);
}

struct Bucket {
  int lo, rows, P, rounds;
};

// The buckets of one call: bucket b takes blocks block0[b] .. block0[b+1].
struct Buckets {
  Bucket b[kMaxBuckets];
  int block0[kMaxBuckets + 1];
  int n;
};

// PTOP: the largest P of the call's buckets, 8 or 32, so that a call
// without the P=32 bucket (no miss over 8 bytes to merge) runs an
// instantiation that holds no 16- or 32-lane row
template <int PTOP>
__global__ void __launch_bounds__(kThreads)
merge_buckets_kernel(Buckets bk, BucketData d, Pairs t) {
  // the last bucket that starts at or before this block (constant indices,
  // so the table stays in the parameter bank)
  Bucket s = bk.b[0];
  int base = 0;
#pragma unroll
  for (int b = 1; b < kMaxBuckets; ++b)
    if (b < bk.n && static_cast<int>(blockIdx.x) >= bk.block0[b]) {
      s = bk.b[b];
      base = bk.block0[b];
    }
  const int i = (static_cast<int>(blockIdx.x) - base) * kThreads +
                threadIdx.x;
  if (i >= s.rows) return;
  const BucketRows rows{d, s.lo, s.P, s.rounds};
  // every row of a block is in one bucket, so a block takes one branch
  if (s.P <= 4)
    merge_one<4>(rows, i, t);
  else if (PTOP <= 8 || s.P <= 8)
    merge_one<8>(rows, i, t);
  else if (s.P <= 16)
    merge_one<16>(rows, i, t);
  else
    merge_one<PTOP>(rows, i, t);
}

template <int PMAX>
void launch_rows(const MatrixRows& rows, int B2, const Pairs& t,
                 cudaStream_t stream) {
  const int blocks = (B2 + kThreads - 1) / kThreads;
  merge_rows_kernel<PMAX><<<blocks, kThreads, 0, stream>>>(rows, B2, t);
}

}  // namespace

extern "C" {

// table: (size, 4) int32 rows [left, right, merged, 0], size a power of two.
// Returns cudaGetLastError() after the launch (0 on success), or -1
// without a launch for no rows.
int tk_merge_rows(const int32_t* rank, const int32_t* pr,
                  const int32_t* n_seg, const int32_t* table,
                  unsigned int size_mask, unsigned int seed1,
                  unsigned int seed2, int B2, int P, int max_rounds,
                  int32_t* rank_out, int32_t* n_out, void* stream) {
  if (B2 <= 0) return -1;  // nothing to launch
  if (P < 1 || P > 64) return static_cast<int>(cudaErrorInvalidValue);
  const Pairs t{reinterpret_cast<const int4*>(table), size_mask, seed1,
                seed2};
  const MatrixRows rows{rank, pr, n_seg, rank_out, n_out, P, max_rounds};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 4)
    launch_rows<4>(rows, B2, t, s);
  else if (P <= 8)
    launch_rows<8>(rows, B2, t, s);
  else if (P <= 16)
    launch_rows<16>(rows, B2, t, s);
  else if (P <= 32)
    launch_rows<32>(rows, B2, t, s);
  else
    launch_rows<64>(rows, B2, t, s);
  return static_cast<int>(cudaGetLastError());
}

// buckets: n_buckets x (lo, rows, P, rounds), each P in 1..32.  start is
// null for flat words (the word holds the flat start; plen is (N,)) or the
// (B, R) row-local starts of the compact records the words index (plen is
// their (B, R) lengths).  Returns cudaGetLastError() after the launch, or
// -1 without a launch when no bucket has a row.
int tk_merge_buckets(int n_buckets, const int* buckets, const int64_t* w,
                     const int32_t* start, const int32_t* plen, int R,
                     const int64_t* byte_rank, int N, const int32_t* dense,
                     const int32_t* table, unsigned int size_mask,
                     unsigned int seed1, unsigned int seed2, int32_t* tok,
                     void* stream) {
  if (n_buckets < 0 || n_buckets > kMaxBuckets || N <= 0 ||
      (start != nullptr && R <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Buckets bk{};
  int blocks = 0, ptop = 0;
  for (int b = 0; b < n_buckets; ++b) {
    const Bucket s{buckets[4 * b], buckets[4 * b + 1], buckets[4 * b + 2],
                   buckets[4 * b + 3]};
    if (s.lo < 0 || s.rows < 0 || s.P < 1 || s.P > 32)
      return static_cast<int>(cudaErrorInvalidValue);
    bk.b[b] = s;
    bk.block0[b] = blocks;
    blocks += (s.rows + kThreads - 1) / kThreads;
    if (s.rows > 0 && s.P > ptop) ptop = s.P;
  }
  bk.block0[n_buckets] = blocks;
  bk.n = n_buckets;
  if (blocks == 0) return -1;  // nothing to launch
  const BucketData d{w, start, plen, R, N, byte_rank, dense, tok};
  const Pairs t{reinterpret_cast<const int4*>(table), size_mask, seed1,
                seed2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ptop <= 8)
    merge_buckets_kernel<8><<<blocks, kThreads, 0, s>>>(bk, d, t);
  else
    merge_buckets_kernel<32><<<blocks, kThreads, 0, s>>>(bk, d, t);
  return static_cast<int>(cudaGetLastError());
}

const char* tk_merge_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
