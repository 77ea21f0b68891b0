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
// end with a log-doubling min over the row.  Here the tile walk of the
// compaction kernel (stage1_tile.cuh) does the same work: a persistent grid
// of 512-thread CTAs, two an SM, walks each row in tiles of 2048 lanes, 4
// lanes a thread, loading the next row's first window while it works.  Per
// tile:
//   1. the tile's bytes and halo are staged once with 16-byte loads;
//   2. the simple rules run on class words looked up once into registers
//      from a 256-entry table in shared memory;
//   3. one block scan numbers the tile's starts into a list in shared
//      memory, so a piece's length is the next start less its own;
//   4. each thread stores its 4 lanes of each plane as one int4 store a
//      plane, marked streaming, content dwords taken from the staged
//      bytes.  Every lane gets a
//      value, so nothing is filled first.  The formula is the same at every
//      lane: at a lane where no piece starts the length is 0, the masks
//      clear every dword and the slot is the hash of zeros.
// A piece that runs past its tile stays pending: its raw dwords are kept
// from the staged window before the next tile replaces it, and thread 0
// writes its lane once a later tile, or the row end, gives its length.
// That lane's group was stored (as no piece) in an earlier tile, before
// the barriers that end it, so the later write is the one that stays.
// Lanes past the last tile that holds bytes hold no piece.  Rows or planes
// that are not 16-byte aligned take byte loads and int32 stores.

#include "stage1_tile.cuh"

namespace {

struct FusedOut {
  int32_t* out;     // plane p at out + p * plane: plen, slot, ws[0..NW)
  size_t plane;     // B * R
  uint32_t size_mask;
  uint32_t wseed;
};

// lanes at .. at+nvalid-1 of plane p (one int4 store when vec, marked
// streaming: the planes are several times the L2 and read by later
// kernels, not this one)
__device__ __forceinline__ void put4(const FusedOut& o, int p, size_t at,
                                     const int32_t* v, bool vec,
                                     int nvalid) {
  int32_t* dst = o.out + p * o.plane + at;
  if (vec) {
    __stcs(reinterpret_cast<int4*>(dst), make_int4(v[0], v[1], v[2], v[3]));
  } else {
    for (int k = 0; k < nvalid; ++k) dst[k] = v[k];
  }
}

// Every plane at lanes at .. at+3: L[k] the piece length at lane k (0
// where no piece starts or one is pending), raw[0..NW] the staged dwords
// from lane at on (lane k's dword j is raw[j], raw[j+1] shifted k bytes).
template <int NW>
__device__ __forceinline__ void store_group(const FusedOut& o, size_t at,
                                            const int* L,
                                            const uint32_t* raw, bool vec,
                                            int nvalid) {
  put4(o, 0, at, L, vec, nvalid);
  if (NW == 0) return;
  int32_t v[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    uint32_t w[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      w[j] = __funnelshift_r(raw[j], raw[j + 1], 8 * k) &
             byte_mask(L[k] - 4 * j);
    v[k] = static_cast<int32_t>(
        word_slot(w[0], w[1], w[2], L[k], o.wseed, o.size_mask));
  }
  put4(o, 1, at, v, vec, nvalid);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      v[k] = static_cast<int32_t>(__funnelshift_r(raw[j], raw[j + 1], 8 * k) &
                                  byte_mask(L[k] - 4 * j));
    put4(o, 2 + j, at, v, vec, nvalid);
  }
}

// the planes of the pending piece at lane at, L long, raw dwords w
template <int NW>
__device__ void store_pending(const FusedOut& o, size_t at, int L,
                              const uint32_t* w) {
  o.out[at] = L;
  if (NW == 0) return;
  uint32_t m[kMaxNw];
#pragma unroll
  for (int j = 0; j < NW; ++j) m[j] = w[j] & byte_mask(L - 4 * j);
  o.out[o.plane + at] = static_cast<int32_t>(
      word_slot(m[0], m[1], m[2], L, o.wseed, o.size_mask));
#pragma unroll
  for (int j = 0; j < NW; ++j)
    o.out[(2 + j) * o.plane + at] = static_cast<int32_t>(m[j]);
}

template <int NW>
__global__ void __launch_bounds__(kThreads, 2)
stage1_fused_kernel(const uint8_t* __restrict__ byts,
                    const int32_t* __restrict__ lengths, int B, int R,
                    bool vec, FusedOut o) {
  __shared__ __align__(16) uint32_t win[kWin / 4];
  __shared__ int lanes[kTile + 2];
  __shared__ int buf[kWarps];
  __shared__ uint32_t pend_w[2][kMaxNw];
  __shared__ int cls[256];       // char_info of each byte value

  // (read first after the first tile's first barrier)
  if (threadIdx.x < 256) cls[threadIdx.x] = char_info(threadIdx.x);

  // A CTA walks rows blockIdx.x, + gridDim.x, ...; the first window of
  // its next row is loaded while it works on this one.
  const bool stager = threadIdx.x < kWin / 16;
  int r = blockIdx.x;
  int len = row_len(lengths, r, R);
  uint4 ahead = stager ? stage16(byts + static_cast<size_t>(r) * R,
                                 16 * threadIdx.x - kHead, len, vec)
                       : make_uint4(0, 0, 0, 0);
  for (; r < B; r += gridDim.x) {
    const size_t row_off = static_cast<size_t>(r) * R;
    const uint8_t* row = byts + row_off;
    const int next = r + gridDim.x;
    const int len_next = next < B ? row_len(lengths, next, R) : 0;

    int pend = -1;       // start lane of the piece pending from a tile
    int pbuf = 0;        // pend_w[pbuf] holds its raw dwords
    int t0 = 0;
    for (;; t0 += kTile) {
      const bool last = t0 + kTile >= len;
      const int win0 = t0 - kHead;

      // 1. stage the window; bytes outside [0, len) read as 0
      if (stager)
        reinterpret_cast<uint4*>(win)[threadIdx.x] =
            t0 == 0 ? ahead
                    : stage16(row, win0 + 16 * threadIdx.x, len, vec);
      const int p_off = pend >= 0 ? 1 : 0;
      if (threadIdx.x == 0 && p_off) lanes[0] = pend;
      __syncthreads();
      if (t0 == 0 && stager && next < B)
        ahead = stage16(byts + static_cast<size_t>(next) * R,
                        16 * threadIdx.x - kHead, len_next, vec);

      // 2-3. start flags of the thread's lanes i0 .. i0+3, numbered
      const int i0 = t0 + kLanes * threadIdx.x;
      const unsigned m = simple_starts(win, cls, i0, len);
      const int n = __popc(m);
      int total;
      const int incl = number_starts(m, i0, p_off, lanes, buf, &total);
      if (last && threadIdx.x == 0) lanes[p_off + total] = len;
      // the tile's last start stays pending past a tile that does not end
      // the row: its owner keeps the raw dwords before the window changes
      if (NW && !last && n > 0 && incl == total)
        window_dwords(win, win0, i0 + 31 - __clz(m), pend_w[pbuf ^ 1]);
      __syncthreads();

      // 4. the piece pending from an earlier tile, if this tile ends it
      if (threadIdx.x == 0 && p_off && (total > 0 || last))
        store_pending<NW>(o, row_off + lanes[0], lanes[1] - lanes[0],
                          pend_w[pbuf]);
      //    and the thread's own lanes
      if (i0 < R) {
        int L[kLanes];
        int e = p_off + incl - n;      // list entry of its first start
#pragma unroll
        for (int k = 0; k < kLanes; ++k) {
          L[k] = 0;
          if (m >> k & 1) {
            if (last || e + 1 < p_off + total) L[k] = lanes[e + 1] - (i0 + k);
            ++e;
          }
        }
        uint32_t raw[NW + 1];
#pragma unroll
        for (int j = 0; j <= NW; ++j) raw[j] = win[threadIdx.x + 4 + j];
        store_group<NW>(o, row_off + i0, L, raw, vec,
                        R - i0 < kLanes ? R - i0 : kLanes);
      }
      if (!last && total > 0) {
        pend = lanes[p_off + total - 1];
        pbuf ^= 1;
      }
      __syncthreads();
      if (last) break;
    }

    // 5. the lanes past the last tile with bytes hold no piece
    const int zero[kLanes] = {0, 0, 0, 0};
    const uint32_t raw0[NW + 1] = {};
    for (int i = t0 + kTile + kLanes * threadIdx.x; i < R;
         i += kLanes * kThreads)
      store_group<NW>(o, row_off + i, zero, raw0, vec,
                      R - i < kLanes ? R - i : kLanes);
    len = len_next;
  }
}

template <int NW>
int launch(const uint8_t* byts, const int32_t* lengths, int B, int R,
           bool vec, const FusedOut& o, cudaStream_t stream) {
  int grid = 0;
  const cudaError_t e = persistent_grid(B, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  stage1_fused_kernel<NW><<<grid, kThreads, 0, stream>>>(byts, lengths, B, R,
                                                         vec, o);
  return static_cast<int>(cudaGetLastError());
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
  const FusedOut o{out, static_cast<size_t>(B) * R, size_mask, wseed};
  const bool vec = R % 16 == 0 && aligned16(byts) && aligned16(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_words) {
    case 0: return launch<0>(byts, lengths, B, R, vec, o, s);
    case 3: return launch<3>(byts, lengths, B, R, vec, o, s);
    case 6: return launch<6>(byts, lengths, B, R, vec, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* tk_stage1_fused_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
