// Compact-shift BPE merge of a (B2, P) matrix of piece rows, for Hopper.
//
// Replaces: tekken_tpu/ops/pallas_merge.py `_round_kernel` (launched by
// `_round_fn` and `merge_rows_compact_fused`) together with the XLA
// cuckoo-row gather that fed it each round.  Same result, bit for bit, as
// the plain version `merge_rows_compact` in ops/bpe.py: rank (B2, P) and
// n_seg (B2,) after every row has merged to completion (or after
// `max_rounds` rounds).
//
// Semantics kept exactly: each round merges the leftmost lowest-rank pair
// of a row (the fused key (min(pr, 2^24) << lane_bits) | lane, so ranks
// >= 2^24 count as absent), one merge per row per round, and closes the
// gap by shifting the lanes right of it; the two new pair ranks come from
// the two-choice cuckoo table (vocab.cuckoo_hash with the table's seeds).
//
// What bounds it on this card: operations and latency, not bytes.  A row
// reads and writes 2 * P * 4 + 8 bytes once, but each merge round costs a
// P-lane argmin and two dependent cuckoo probes (16-byte rows of a table
// that fits the 50 MB L2).
//
// Design.  On the TPU the table gather had to stay outside the kernel
// (in-kernel gathers miscompiled on Mosaic), so every round was a launch
// pair.  Here one thread owns one row, keeps its P <= 64 lanes in local
// memory, probes the table itself, and loops rounds until its row has no
// mergeable pair: one launch for all rounds.  A P-lane row merges at most
// P - 1 times, so the loop is bounded by P rounds when no fixed count is
// given, which ends where the reference's run-until-done loop ends.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kInf = 0x7fffffff;
constexpr int kCap = 1 << 24;

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

// merged rank of (l, r), or kInf when absent or when either is negative
__device__ __forceinline__ int probe(const int4* __restrict__ table,
                                     uint32_t mask, uint32_t s1, uint32_t s2,
                                     int l, int r) {
  if (l < 0 || r < 0) return kInf;
  const int4 a = __ldg(table + (pair_hash(l, r, s1) & mask));
  if (a.x == l && a.y == r) return a.z;
  const int4 b = __ldg(table + (pair_hash(l, r, s2) & mask));
  if (b.x == l && b.y == r) return b.z;
  return kInf;
}

template <int PMAX>
__global__ void __launch_bounds__(kThreads)
merge_rows_kernel(const int32_t* __restrict__ rank_in,
                  const int32_t* __restrict__ pr_in,
                  const int32_t* __restrict__ n_in,
                  const int4* __restrict__ table, uint32_t mask, uint32_t s1,
                  uint32_t s2, int B2, int P, int lane_bits, int max_rounds,
                  int32_t* __restrict__ rank_out,
                  int32_t* __restrict__ n_out) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= B2) return;
  int rank[PMAX], pr[PMAX];
  const size_t off = static_cast<size_t>(row) * P;
  for (int k = 0; k < P; ++k) {
    rank[k] = rank_in[off + k];
    pr[k] = pr_in[off + k];
  }
  int n = n_in[row];
  const int lane_mask = (1 << lane_bits) - 1;

  for (int round = 0; round < max_rounds; ++round) {
    // fused min + argmin: the leftmost lowest rank wins
    int key = 0x7fffffff;
    for (int k = 0; k < P; ++k) {
      const int p = pr[k] < kCap ? pr[k] : kCap;
      const int kk = static_cast<int>(static_cast<uint32_t>(p) << lane_bits)
                     | k;
      key = kk < key ? kk : key;
    }
    const int m = key >> lane_bits;
    if (m >= kCap) break;   // no mergeable pair left in this row
    const int q = key & lane_mask;

    const int left = q >= 1 ? rank[q - 1] : -1;
    const int right = (q + 2 < P && q + 2 < n) ? rank[q + 2] : -1;
    const int new_pl = probe(table, mask, s1, s2, left, m);
    const int new_pq = probe(table, mask, s1, s2, m, right);

    for (int k = q + 1; k < P - 1; ++k) {
      rank[k] = rank[k + 1];
      pr[k] = pr[k + 1];
    }
    if (q + 1 <= P - 1) {
      rank[P - 1] = -1;
      pr[P - 1] = kInf;
    }
    rank[q] = m;
    if (q >= 1) pr[q - 1] = new_pl;
    pr[q] = new_pq;
    n -= 1;
  }

  for (int k = 0; k < P; ++k) rank_out[off + k] = rank[k];
  n_out[row] = n;
}

template <int PMAX>
void launch(const int32_t* rank, const int32_t* pr, const int32_t* n_seg,
            const int4* table, uint32_t mask, uint32_t s1, uint32_t s2,
            int B2, int P, int lane_bits, int max_rounds, int32_t* rank_out,
            int32_t* n_out, cudaStream_t stream) {
  const int blocks = (B2 + kThreads - 1) / kThreads;
  merge_rows_kernel<PMAX><<<blocks, kThreads, 0, stream>>>(
      rank, pr, n_seg, table, mask, s1, s2, B2, P, lane_bits, max_rounds,
      rank_out, n_out);
}

}  // namespace

extern "C" {

// table: (size, 4) int32 rows [left, right, merged, 0], size a power of two.
// Returns cudaGetLastError() after the launch (0 on success), or -1
// without a launch for no rows.
int tk_merge_rows(const int32_t* rank, const int32_t* pr,
                  const int32_t* n_seg, const int32_t* table,
                  unsigned int size_mask, unsigned int seed1,
                  unsigned int seed2, int B2, int P, int lane_bits,
                  int max_rounds, int32_t* rank_out, int32_t* n_out,
                  void* stream) {
  if (B2 <= 0) return -1;  // nothing to launch
  if (P < 1 || P > 64) return static_cast<int>(cudaErrorInvalidValue);
  const int4* t = reinterpret_cast<const int4*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 4)
    launch<4>(rank, pr, n_seg, t, size_mask, seed1, seed2, B2, P, lane_bits,
              max_rounds, rank_out, n_out, s);
  else if (P <= 8)
    launch<8>(rank, pr, n_seg, t, size_mask, seed1, seed2, B2, P, lane_bits,
              max_rounds, rank_out, n_out, s);
  else if (P <= 16)
    launch<16>(rank, pr, n_seg, t, size_mask, seed1, seed2, B2, P, lane_bits,
               max_rounds, rank_out, n_out, s);
  else if (P <= 32)
    launch<32>(rank, pr, n_seg, t, size_mask, seed1, seed2, B2, P, lane_bits,
               max_rounds, rank_out, n_out, s);
  else
    launch<64>(rank, pr, n_seg, t, size_mask, seed1, seed2, B2, P, lane_bits,
               max_rounds, rank_out, n_out, s);
  return static_cast<int>(cudaGetLastError());
}

const char* tk_merge_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
