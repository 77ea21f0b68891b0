// The tile walk shared by the two stage-1 kernels (stage1_compact.cu and
// stage1_fused.cu): a CTA of kThreads threads walks a row in tiles of
// kTile lanes, 4 consecutive lanes a thread.  Per tile, the tile's bytes,
// kHead before it and 32 past it, are staged once in shared memory with
// 16-byte loads; the simple rules run on class words looked up once into
// registers from a 256-entry table in shared memory; one block scan
// numbers the tile's piece starts into a list in shared memory.  The
// kernels differ only in what they store.

#pragma once

#include "stage1_rules.cuh"

namespace {

constexpr int kLanes = 4;                       // lanes a thread owns
constexpr int kTile = kThreads * kLanes;        // 2048 lanes a tile
constexpr int kHead = 16;                       // staged bytes before it
constexpr int kWin = kHead + kTile + 32;        // staged bytes (131 x 16)
constexpr int kMaxNw = 6;

// The run class bits of a class word: exactly one of kL, kN, kW, kP for
// a valid lane and none for an invalid one, so two lanes are in the same
// run class (group) exactly when these bits are equal.
__device__ __forceinline__ bool other_class(int a, int b) {
  return ((a ^ b) & (kL | kN | kW | kP)) != 0;
}

// Class words of lanes base .. base + 7 in registers (simple rules): the
// rules at lane i read lanes i-4 .. i, so a thread's 4 lanes need the 4
// before them.  Indices fold to constants once the lane loop unrolls.
struct RegRow {
  int c[2 * kLanes];
  int base;
  __device__ int info(int j) const { return c[j - base]; }
  __device__ bool change(int j) const {
    if (j < 0) return false;
    return j == 0 || other_class(info(j), info(j - 1));
  }
  __device__ bool change_next(int j) const {
    return other_class(info(j), info(j + 1));
  }
  __device__ bool differ(int a, int b) const { return other_class(a, b); }
};

// Start flags (bit k for lane i0 + k) of the simple rules at the thread's
// lanes i0 .. i0+3 = t0 + 4 * threadIdx.x, from the staged window of tile
// t0 and the class table.
__device__ __forceinline__ unsigned simple_starts(const uint32_t* win,
                                                  const int* cls, int i0,
                                                  int len) {
  RegRow rw;
  rw.base = i0 - kLanes;
  const uint32_t b0 = win[threadIdx.x + 3], b1 = win[threadIdx.x + 4];
#pragma unroll
  for (int e = 0; e < 2 * kLanes; ++e) {
    const int pos = rw.base + e;
    const int b = ((e < kLanes ? b0 : b1) >> (8 * (e & 3))) & 255;
    rw.c[e] = (pos >= 0 && pos < len) ? cls[b] : 0;
  }
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < kLanes; ++k)
    if (i0 + k < len && boundary_simple(rw, i0 + k)) m |= 1u << k;
  return m;
}

// Number the tile's starts: one block scan of the threads' start counts;
// each thread writes the lanes of its starts into lanes[p_off + ...] in
// order.  Returns the thread's inclusive count; *total the tile's.
__device__ __forceinline__ int number_starts(unsigned m, int i0, int p_off,
                                             int* lanes, int* buf,
                                             int* total) {
  const int n = __popc(m);
  const int incl = block_scan(n, 0, AddOp(), buf, total);
  int at = p_off + incl - n;
#pragma unroll
  for (int k = 0; k < kLanes; ++k)
    if (m >> k & 1) lanes[at++] = i0 + k;
  return incl;
}

// the nw raw (unmasked) dwords of the bytes from lane s, s inside the
// window with 4 * kMaxNw + 4 staged bytes past it
__device__ __forceinline__ void window_dwords(const uint32_t* win, int win0,
                                              int s, uint32_t* w) {
  const int q = (s - win0) >> 2, sh = ((s - win0) & 3) * 8;
#pragma unroll
  for (int j = 0; j < kMaxNw; ++j)
    w[j] = __funnelshift_r(win[q + j], win[q + j + 1], sh);
}

// the low `rem` bytes of a dword (rem clamped to 0..4)
__device__ __forceinline__ uint32_t byte_mask(int rem) {
  return rem >= 4 ? 0xffffffffu : (rem <= 0 ? 0u : (1u << (8 * rem)) - 1u);
}

// bytes [n, 16) of v set to 0 (0 <= n < 16)
__device__ __forceinline__ uint4 keep_bytes(uint4 v, int n) {
  uint32_t* c = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] &= byte_mask(n - 4 * q);
  return v;
}

// the 16 window bytes at row lane p (p a multiple of 16 when vec); bytes
// outside [0, len) read as 0
__device__ __forceinline__ uint4 stage16(const uint8_t* row, int p, int len,
                                         bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (vec) {
    if (p >= 0 && p < len) {
      v = __ldg(reinterpret_cast<const uint4*>(row + p));
      if (p + 16 > len) v = keep_bytes(v, len - p);
    }
  } else {
    uint32_t c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (p + b >= 0 && p + b < len)
        c[b >> 2] |= static_cast<uint32_t>(__ldg(row + p + b))
                     << (8 * (b & 3));
    v = make_uint4(c[0], c[1], c[2], c[3]);
  }
  return v;
}

__device__ __forceinline__ int row_len(const int32_t* lengths, int r, int R) {
  const int len = __ldg(lengths + r);
  return len < 0 ? 0 : (len > R ? R : len);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// CTAs of the persistent grid: two an SM, the CTAs whose registers
// __launch_bounds__(kThreads, 2) keeps room for, or one a row when there
// are fewer rows.  The SM count is read once a device.
inline cudaError_t persistent_grid(int B, int* grid) {
  static int sms_of[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int sms = dev < 64 ? sms_of[dev] : 0;
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (dev < 64) sms_of[dev] = sms;
  }
  *grid = B < 2 * sms ? B : 2 * sms;
  return cudaSuccess;
}

}  // namespace
