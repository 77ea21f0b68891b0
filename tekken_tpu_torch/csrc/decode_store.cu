// The byte store of the batched decode, for Hopper.
//
// Replaces: tekken_tpu/ops/decode.py `_compact_store_kernel` (launched by
// `_compact_store_fn` and `decode_bytes_pallas_impl`).  Same bytes, over
// all out_cap of them, as the plain version `decode_bytes_compact_reference`
// in ops/decode.py: token i's `length[i]` bytes, read from its row of the
// padded per-rank table `bytes32` (n_ranks, sw4) int32, land at
// out[out_off[i] .. out_off[i] + length[i]); every byte from `total` to
// out_cap is 0.  The caller computes length (0 past n_tokens), its
// exclusive cumsum out_off and the sum total.
//
// What bounds it on this card: bytes.  The function needs each token's id
// and table length (8 bytes) and its live table lanes (4 bytes a byte),
// and writes out_cap bytes; this kernel also reads the offsets the caller
// computed (4 bytes a token more).  For 65,536 tokens of ~5.5 bytes that
// is about 2 MB, under 1 us at 3.35 TB/s, so at this size a launch is
// latency, not bandwidth.
//
// Design.  The TPU kernel left-compacted each K-token block's K * sw4 byte
// lanes with a binary-gap shift network and stored the block at its offset
// with an aligned read-modify-write; it was correct only because Mosaic
// runs the grid in order, so each block overwrote the junk lanes past the
// previous block's count.  CTAs on the card run concurrently, so here each
// thread owns one (token, lane) pair and stores that one byte, only if the
// lane is live: no store ever lands outside its token's bytes, and no
// compaction is needed.  Consecutive threads read consecutive lanes of a
// token's table row and write consecutive output bytes.  A grid-stride loop
// writes the zeros past `total`.  The 128-lane alignment and the K / NB
// sizing of the TPU kernel were Mosaic's constraints and are not kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
decode_store_kernel(const int32_t* __restrict__ tokens,
                    const int32_t* __restrict__ length,
                    const int32_t* __restrict__ out_off,
                    const int32_t* __restrict__ total_p,
                    const int32_t* __restrict__ bytes32, int sw4_bits,
                    int n_ranks, int T, uint8_t* __restrict__ out,
                    int out_cap) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int i = g >> sw4_bits;
  const int j = g & ((1 << sw4_bits) - 1);
  if (i < T) {
    const int L = length[i];
    if (j < L) {
      int t = tokens[i];
      t = t < 0 ? 0 : (t >= n_ranks ? n_ranks - 1 : t);
      const int dst = out_off[i] + j;
      if (dst < out_cap)
        out[dst] = static_cast<uint8_t>(
            __ldg(bytes32 + (static_cast<size_t>(t) << sw4_bits) + j) & 255);
    }
  }
  const int total = *total_p;
  const int stride = gridDim.x * kThreads;
  for (int k = (total < 0 ? 0 : total) + g; k < out_cap; k += stride)
    out[k] = 0;
}

}  // namespace

extern "C" {

// tokens, length, out_off: (T,) int32; total: (1,) int32; bytes32:
// (n_ranks, 1 << sw4_bits) int32; out: (out_cap,) uint8.  Returns
// cudaGetLastError() after the launch (0 on success), or -1 without a
// launch when out_cap is 0.
int tk_decode_store(const int32_t* tokens, const int32_t* length,
                    const int32_t* out_off, const int32_t* total,
                    const int32_t* bytes32, int sw4_bits, int n_ranks, int T,
                    uint8_t* out, int out_cap, void* stream) {
  if (out_cap <= 0) return -1;  // nothing to launch
  if (sw4_bits < 0 || sw4_bits > 5 || n_ranks <= 0 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long lanes = static_cast<long long>(T) << sw4_bits;
  const long long work = lanes > out_cap ? lanes : out_cap;
  const int blocks = static_cast<int>((work + kThreads - 1) / kThreads);
  decode_store_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      tokens, length, out_off, total, bytes32, sw4_bits, n_ranks, T, out,
      out_cap);
  return static_cast<int>(cudaGetLastError());
}

const char* tk_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
