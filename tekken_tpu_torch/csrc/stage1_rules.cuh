// The simple-ASCII boundary rules, the word-probe hash and a block-wide
// scan, shared by the two stage-1 kernels (stage1_compact.cu and
// stage1_fused.cu, through stage1_tile.cuh).  Each includes this header
// into its own library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 1 << 30;

constexpr uint32_t K1 = 0x9E3779B1u;
constexpr uint32_t K2 = 0x85EBCA77u;
constexpr uint32_t K3 = 0xC2B2AE3Du;
constexpr uint32_t K4 = 0x27D4EB2Fu;

// per-char class word: 0 for an invalid lane (outside [0, length))
enum {
  kL = 1, kN = 2, kW = 4, kP = 8, kNL = 16, kSP = 32, kAP = 64, kValid = 128
};

__device__ __forceinline__ int char_info(int b) {
  const int lo = b | 32;
  const bool l = lo >= 97 && lo <= 122;
  const bool n = b >= 48 && b <= 57;
  const bool w = b == 32 || (b >= 9 && b <= 13);
  int fold = 0;
  if (l) {
    switch (lo) {
      case 's': fold = 1; break;
      case 't': fold = 2; break;
      case 'r': fold = 3; break;
      case 'e': fold = 4; break;
      case 'v': fold = 5; break;
      case 'm': fold = 6; break;
      case 'l': fold = 7; break;
      case 'd': fold = 8; break;
      default: break;
    }
  }
  return kValid | (l ? kL : 0) | (n ? kN : 0) | (w ? kW : 0) |
         ((!l && !n && !w) ? kP : 0) | ((b == 13 || b == 10) ? kNL : 0) |
         (b == 32 ? kSP : 0) | (b == 39 ? kAP : 0) | (fold << 8);
}

__device__ __forceinline__ int fold_of(int info) { return (info >> 8) & 31; }

// contraction at a free length-1 apostrophe run at lane j: bit 0 consumes
// one letter ('s 't 'm 'd), bit 1 two ('re 've 'll)
template <class Row>
__device__ int contraction(const Row& rw, int j) {
  if (j < 0) return 0;
  const int c = rw.info(j);
  if (!(c & kP) || !(c & kAP)) return 0;
  if (!rw.change(j) || !rw.change_next(j)) return 0;
  if (rw.info(j - 1) & kSP) return 0;
  const int n1 = rw.info(j + 1);
  if (!(n1 & kL)) return 0;
  const int n2 = rw.info(j + 2);
  const bool has_l2 = (n2 & kL) && !rw.change(j + 2);
  const int f1 = fold_of(n1), f2 = fold_of(n2);
  const bool one = f1 == 1 || f1 == 2 || f1 == 6 || f1 == 8;
  const bool two = ((f1 == 3 || f1 == 5) && has_l2 && f2 == 4) ||
                   (f1 == 7 && has_l2 && f2 == 7);
  return (one ? 1 : 0) | (two ? 2 : 0);
}

// the rules shared by both rule sets (letters, digits-at-change, punct)
template <class Row>
__device__ void common_rules(const Row& rw, int i, int c, int m1, int m2,
                             bool chg, bool chg1, bool chg2, bool* b_ls,
                             bool* b_lc, bool* b_p) {
  const bool absorbed = ((m1 & kW) && !(m1 & kNL)) ||
                        ((m1 & kP) && chg1 && !(m2 & kSP));
  *b_ls = (c & kL) && chg && !(i > 0 && absorbed);
  *b_lc = (c & kL) && !chg &&
          ((chg1 && (contraction(rw, i - 2) & 1)) ||
           (chg2 && !chg1 && (contraction(rw, i - 3) & 2)));
  *b_p = (c & kP) && chg && !(i > 0 && (m1 & kSP));
}

// simple rules (no whitespace run > 1, no digit run > 3) at a valid lane;
// Row gives the class words (RegRow, stage1_tile.cuh)
template <class Row>
__device__ bool boundary_simple(const Row& rw, int i) {
  const int c = rw.info(i), m1 = rw.info(i - 1), m2 = rw.info(i - 2);
  const bool chg = i == 0 || rw.differ(c, m1);
  const bool chg1 = rw.change(i - 1);
  const bool chg2 = rw.change(i - 2);
  bool b_ls, b_lc, b_p;
  common_rules(rw, i, c, m1, m2, chg, chg1, chg2, &b_ls, &b_lc, &b_p);
  const bool b_num = (c & kN) && chg;
  const bool b_ws = (c & kW) && !((m1 & kP) && (c & kNL));
  return b_num || b_ls || b_lc || b_p || b_ws;
}

// word-map probe slot of a piece (vocab.word_hash)
__device__ __forceinline__ uint32_t word_slot(uint32_t w0, uint32_t w1,
                                              uint32_t w2, int L,
                                              uint32_t wseed,
                                              uint32_t size_mask) {
  uint32_t h = (w0 * K1) ^ (w1 * K2) ^ (w2 * K3) ^
               (static_cast<uint32_t>(L) * K4) ^ wseed;
  h ^= h >> 15;
  h *= K3;
  h ^= h >> 13;
  return h & size_mask;
}

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct MinOp {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct AddOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Block-wide inclusive scan in thread order; *total gets the block
// aggregate.  `buf` holds kWarps ints of shared memory.
template <class Op>
__device__ int block_scan(int v, int identity, Op op, int* buf, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = op(x, y);
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? buf[lane] : identity;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = op(w, y);
    }
    if (lane < kWarps) buf[lane] = w;
  }
  __syncthreads();
  const int res = warp > 0 ? op(buf[warp - 1], x) : x;
  *total = buf[kWarps - 1];
  __syncthreads();
  return res;
}

}  // namespace
