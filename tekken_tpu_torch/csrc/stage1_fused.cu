// Stage 1 of the unrouted flat encode at byte granularity, for Hopper.
//
// Replaces: tekken_tpu/ops/pallas_stage1.py `_kernel` (launched by
// `_stage1_fn` and `stage1_fused`).  Same outputs, bit for bit, as the plain
// version `stage1_fused_reference` in ops/stage1.py, at EVERY (B, R) lane:
//   plen   (B, R) int32  piece length at a piece start, 0 elsewhere
//   slot   (B, R) int32  word-map probe slot (the hash of zero dwords and
//                        length 0 where no piece starts)
//   ws[n]  (B, R) int32  little-endian content dwords masked to plen
//                        (0 where no piece starts)
// `slot` and `ws` exist only for n_words 3 or 6; n_words 0 writes plen
// alone.  The simple rules (no whitespace run > 1, no digit run > 3) are
// the caller's routing: the flat path takes this kernel for such buffers.
//
// What bounds it on this card: bytes.  It reads 1 byte per lane and writes
// (2 + n_words) * 4 bytes per lane (4 for n_words 0): at B=4096, R=2048,
// n_words=3 about 176 MB, ~53 us at 3.35 TB/s.  The rules are a few dozen
// integer operations per byte.
//
// Design.  The TPU kernel held whole rows in VMEM and found each piece's
// end with a log-doubling min over the row.  Here one CTA walks one row in
// tiles of kThreads lanes (stage1_rules.cuh supplies the rules, the hash
// and the block scan):
//   1. each lane evaluates the simple rules from a halo of neighbour bytes;
//   2. a block-wide scan numbers the tile's piece starts, and the start
//      lanes are scattered into shared memory by number, so each start
//      finds the next one, and its piece length, in one read;
//   3. the tile's last piece may run on for many tiles (a row of letters is
//      one piece): it stays pending, and thread 0 writes it once a later
//      tile, or the row end, supplies its end;
//   4. every other lane writes its own lane of each plane (coalesced).

#include "stage1_rules.cuh"

namespace {

struct FusedOut {
  int32_t* plen;
  int32_t* slot;
  int32_t* ws;      // n_words planes, `plane` apart
  size_t plane;     // B * R
  int n_words;
  uint32_t size_mask;
  uint32_t wseed;
};

// the planes of a piece starting at lane s of the row, L bytes long
__device__ void write_piece(const FusedOut& o, const uint8_t* row,
                            size_t row_off, int s, int L) {
  const size_t at = row_off + s;
  o.plen[at] = L;
  if (!o.n_words) return;
  uint32_t w[6];
  piece_dwords(row, s, L, o.n_words, w);
  o.slot[at] = static_cast<int32_t>(
      word_slot(w[0], w[1], w[2], L, o.wseed, o.size_mask));
  for (int j = 0; j < o.n_words; ++j)
    o.ws[j * o.plane + at] = static_cast<int32_t>(w[j]);
}

// the planes of a lane where no piece starts
__device__ __forceinline__ void write_empty(const FusedOut& o, size_t at,
                                            uint32_t slot0) {
  o.plen[at] = 0;
  if (!o.n_words) return;
  o.slot[at] = static_cast<int32_t>(slot0);
  for (int j = 0; j < o.n_words; ++j) o.ws[j * o.plane + at] = 0;
}

__global__ void __launch_bounds__(kThreads)
stage1_fused_kernel(const uint8_t* __restrict__ byts,
                    const int32_t* __restrict__ lengths, int R, FusedOut o) {
  __shared__ int tstart[kThreads];
  __shared__ int buf[kWarps];

  const int r = blockIdx.x;
  const size_t row_off = static_cast<size_t>(r) * R;
  const uint8_t* row = byts + row_off;
  int len = lengths[r];
  len = len < 0 ? 0 : (len > R ? R : len);
  const GlobalRow grow{row, len};
  const uint32_t slot0 = word_slot(0, 0, 0, 0, o.wseed, o.size_mask);

  int pend = -1;           // the last start seen, awaiting its piece's end
  for (int t0 = 0; t0 < R; t0 += kThreads) {
    const int i = t0 + threadIdx.x;
    const bool bnd = i < len && boundary_simple(grow, i);
    int total;
    const int incl = block_scan(bnd ? 1 : 0, 0, AddOp(), buf, &total);
    if (bnd) tstart[incl - 1] = i;
    __syncthreads();
    if (total > 0 && pend >= 0 && threadIdx.x == 0)
      write_piece(o, row, row_off, pend, tstart[0] - pend);
    if (i < R) {
      if (!bnd)
        write_empty(o, row_off + i, slot0);
      else if (incl < total)
        write_piece(o, row, row_off, i, tstart[incl] - i);
    }
    if (total > 0) pend = tstart[total - 1];
    __syncthreads();
  }
  if (pend >= 0 && threadIdx.x == 0)
    write_piece(o, row, row_off, pend, len - pend);
}

}  // namespace

extern "C" {

// out: (1 + (n_words ? 1 + n_words : 0)) planes of B*R int32 (plen, then
// slot and ws[0..n_words)).  Returns cudaGetLastError() after the launch
// (0 on success), or -1 without a launch for an empty buffer.
int tk_stage1_fused(const uint8_t* byts, const int32_t* lengths, int B, int R,
                    int n_words, unsigned int size_mask, unsigned int wseed,
                    int32_t* out, void* stream) {
  if (B <= 0 || R <= 0) return -1;  // nothing to launch
  if (n_words != 0 && n_words != 3 && n_words != 6)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t plane = static_cast<size_t>(B) * R;
  FusedOut o{out, out + plane, out + 2 * plane, plane, n_words, size_mask,
             wseed};
  stage1_fused_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      byts, lengths, R, o);
  return static_cast<int>(cudaGetLastError());
}

const char* tk_stage1_fused_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
