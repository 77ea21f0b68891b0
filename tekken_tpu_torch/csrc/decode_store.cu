// The byte store of the batched decode, for Hopper.
//
// Replaces: tekken_tpu/ops/decode.py `_compact_store_kernel` (launched by
// `_compact_store_fn` and `decode_bytes_pallas_impl`), with the lengths,
// their exclusive cumsum and the total that decode_bytes_pallas_impl
// computes around it.  Same bytes, over all out_cap of them, and the same
// total as the plain version `decode_bytes_compact_reference` in
// ops/decode.py: token i < n_tokens (its rank clamped to the table) has
// `lentab[rank]` bytes, read from its row of the padded per-rank table
// `bytes32` (n_ranks, sw4) int32, and they land at the sum of the lengths
// before it; every byte from `total` to out_cap is 0 and bytes past out_cap
// are dropped.  The table's lengths are at most sw4 (padded_table builds it
// so); the kernel clamps them there.
//
// What bounds it on this card: bytes.  The function needs each token's id
// and table length (8 bytes) and its live table lanes (4 bytes a byte),
// and writes out_cap bytes.  For 65,536 tokens of ~5.5 bytes that is about
// 2 MB, under 1 us at 3.35 TB/s, so at this size a call is launch latency
// and, above all, the host's cost of issuing it.
//
// Design.  One launch does the whole function (the wrapper issues nothing
// else but the allocation of out and total).  Each CTA takes a tile of
// 1024 tokens, 4 a thread:
//   1. it loads its ids (16-byte loads where aligned), clamps them and
//      gathers their lengths from lentab (0.5 MB, resident in L2);
//   2. it scans the lengths in the block (warp shuffles, then one pass
//      over the warp totals);
//   3. warp 0 finds the tile's global byte offset by a single-pass chained
//      scan with decoupled look-back (Merrill and Garland): each tile
//      publishes its aggregate, then its inclusive prefix, in one 64-bit
//      status word, and a tile sums its predecessors' words back to the
//      first inclusive one, 32 at a time.  Each word carries the epoch of
//      the call that wrote it, so the status array, cached per device and
//      stream by the wrapper, is never cleared between calls;
//   4. meanwhile the other threads copy their tokens' bytes from bytes32
//      (16-byte loads) into shared memory at the tile-local offsets;
//   5. the tile's bytes form one contiguous output range: it is written
//      with 16-byte stores where aligned and byte stores at its two ends;
//   6. the last tile writes the total and the zeros over [total, out_cap).
// The TPU kernel's binary-gap left-compaction and its aligned
// read-modify-write (right only because Mosaic runs the grid in order)
// are not needed: a tile's bytes are contiguous in shared memory.  Tiles
// look back only at lower-numbered tiles, which the hardware dispatches
// first, so the spin always ends (the same assumption CUB's scans make).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                        // tokens a thread
constexpr int kTile = kThreads * kItems;         // tokens a CTA
constexpr uint32_t kInclusive = 0x80000000u;     // status: prefix, not
                                                 // just the aggregate
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             uint32_t epoch, uint32_t v) {
  const unsigned long long w =
      (static_cast<unsigned long long>(epoch) << 32) | v;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(w) : "memory");
}

// The sum of the lengths of every tile before `tile` (warp 0, all lanes).
__device__ int look_back(const unsigned long long* status, int tile,
                         uint32_t epoch) {
  const int lane = threadIdx.x & 31;
  int prefix = 0;
  for (int look = tile - 1;; look -= 32) {
    const int idx = look - lane;
    unsigned long long w = 0;
    bool ready;
    do {
      if (idx >= 0) w = load_status(status + idx);
      ready = idx < 0 || static_cast<uint32_t>(w >> 32) == epoch;
    } while (!__all_sync(kFull, ready));
    const uint32_t lo = static_cast<uint32_t>(w);
    const bool incl = idx < 0 || (lo & kInclusive);
    const unsigned inc = __ballot_sync(kFull, incl);
    // lanes up to the nearest inclusive word contribute
    const int first = inc ? __ffs(inc) - 1 : 32;
    int v = (idx >= 0 && lane <= first) ? static_cast<int>(lo & ~kInclusive)
                                        : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    prefix += v;
    if (inc) return prefix;
  }
}

// 16 bytes from shared memory at any offset
__device__ __forceinline__ uint4 load16(const uint8_t* s) {
  uint32_t c[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    c[q] = s[4 * q] | (s[4 * q + 1] << 8) | (s[4 * q + 2] << 16) |
           (static_cast<uint32_t>(s[4 * q + 3]) << 24);
  return make_uint4(c[0], c[1], c[2], c[3]);
}

__global__ void __launch_bounds__(kThreads)
decode_store_kernel(const int32_t* __restrict__ tokens, int n_tok,
                    const int32_t* __restrict__ lentab, int n_ranks,
                    const int32_t* __restrict__ bytes32, int sw4_bits,
                    bool vec, uint8_t* __restrict__ out, int out_cap,
                    int32_t* __restrict__ total_out,
                    unsigned long long* __restrict__ status,
                    uint32_t epoch) {
  extern __shared__ uint8_t sb[];       // the tile's bytes, kTile << sw4_bits
  __shared__ int wsum[kWarps];
  __shared__ int prefix_s;

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sw4 = 1 << sw4_bits;
  const int i0 = tile * kTile + threadIdx.x * kItems;

  // 1. ids (0 past n_tok), clamped to the table, and their lengths
  int tok[kItems], len[kItems];
  if (vec && i0 + kItems <= n_tok) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(tokens + i0));
    tok[0] = t.x; tok[1] = t.y; tok[2] = t.z; tok[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      tok[e] = i0 + e < n_tok ? __ldg(tokens + i0 + e) : 0;
  }
  int sum = 0;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int t = tok[e] < 0 ? 0 : (tok[e] >= n_ranks ? n_ranks - 1 : tok[e]);
    tok[e] = t;
    int L = i0 + e < n_tok ? __ldg(lentab + t) : 0;
    L = L < 0 ? 0 : (L > sw4 ? sw4 : L);
    len[e] = L;
    sum += L;
  }

  // 2. block scan of the threads' sums
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) wsum[lane] = w;
  }
  __syncthreads();
  const int agg = wsum[kWarps - 1];
  int off = (warp > 0 ? wsum[warp - 1] : 0) + x - sum;

  // 3. the tile's global offset (warp 0)
  if (warp == 0) {
    int prefix = 0;
    if (tile > 0) {
      if (lane == 0) store_status(status + tile, epoch, agg);
      prefix = look_back(status, tile, epoch);
    }
    if (lane == 0) {
      store_status(status + tile, epoch, (prefix + agg) | kInclusive);
      prefix_s = prefix;
    }
  }

  // 4. the tokens' bytes into shared memory at their tile-local offsets
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int32_t* src = bytes32 + (static_cast<size_t>(tok[e]) << sw4_bits);
    if (vec) {
      for (int j = 0; j < len[e]; j += 4) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(src + j));
        const int b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < len[e]) sb[off + j + q] = static_cast<uint8_t>(b[q]);
      }
    } else {
      for (int j = 0; j < len[e]; ++j)
        sb[off + j] = static_cast<uint8_t>(__ldg(src + j));
    }
    off += len[e];
  }
  __syncthreads();

  // 5. the tile's output range [G, G + n), n clipped at out_cap
  const int G = prefix_s;
  const int n = agg < out_cap - G ? agg : out_cap - G;
  if (n > 0) {
    uint8_t* dst = out + G;
    const int m = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
    const int chunks = (m + n + 15) >> 4;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      const int s0 = 16 * c - m;          // tile-local index of its byte 0
      if (s0 >= 0 && s0 + 16 <= n) {
        *reinterpret_cast<uint4*>(dst + s0) = load16(sb + s0);
      } else {
        for (int b = 0; b < 16; ++b)
          if (s0 + b >= 0 && s0 + b < n) dst[s0 + b] = sb[s0 + b];
      }
    }
  }

  // 6. the total and the zeros past it
  if (tile == gridDim.x - 1) {
    const int total = G + agg;
    if (threadIdx.x == 0) *total_out = total;
    if (total < out_cap) {
      uint8_t* z = out + total;
      const int nz = out_cap - total;
      int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(z) & 15))
                                  & 15);
      head = head < nz ? head : nz;
      if (static_cast<int>(threadIdx.x) < head) z[threadIdx.x] = 0;
      const int body = (nz - head) >> 4;
      uint4* zb = reinterpret_cast<uint4*>(z + head);
      for (int c = threadIdx.x; c < body; c += kThreads)
        zb[c] = make_uint4(0, 0, 0, 0);
      const int tail = head + 16 * body;
      if (tail + static_cast<int>(threadIdx.x) < nz)
        z[tail + threadIdx.x] = 0;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// tokens: (T,) int32; lentab: (n_ranks,) int32; bytes32: (n_ranks,
// 1 << sw4_bits) int32; out: (out_cap,) uint8; total: one int32; status:
// n_status 64-bit words of the caller's scan state, at least one a tile of
// 1024 tokens, each 0 or written by an earlier call with another epoch
// (epoch != 0).  Returns cudaGetLastError() after the launch
// (0 on success), or -1 without a launch when there is no byte to store
// and no token to count (total is then 0).
int tk_decode_store(const int32_t* tokens, int T, int n_tokens,
                    const int32_t* lentab, int n_ranks,
                    const int32_t* bytes32, int sw4_bits, uint8_t* out,
                    int out_cap, int32_t* total, void* status, int n_status,
                    unsigned int epoch, void* stream) {
  const int n_tok = n_tokens < 0 ? 0 : (n_tokens > T ? T : n_tokens);
  if (out_cap <= 0 && n_tok == 0) return -1;  // nothing to launch
  if (sw4_bits < 0 || sw4_bits > 5 || n_ranks <= 0 || T < 0 ||
      out_cap < 0 || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = T > 0 ? (T + kTile - 1) / kTile : 1;
  if (n_status < tiles) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = sw4_bits >= 2 && aligned16(tokens) && aligned16(bytes32);
  const size_t smem = static_cast<size_t>(kTile) << sw4_bits;
  decode_store_kernel<<<tiles, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      tokens, n_tok, lentab, n_ranks, bytes32, sw4_bits, vec, out, out_cap,
      total, static_cast<unsigned long long*>(status), epoch);
  return static_cast<int>(cudaGetLastError());
}

const char* tk_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
