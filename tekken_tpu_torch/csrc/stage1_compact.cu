// Stage 1 of the packed encode with per-row piece compaction, for Hopper.
//
// Replaces: tekken_tpu/ops/pallas_stage1.py `_compact_kernel` (launched by
// `_compact_fn` and `stage1_compact`).  Same outputs, bit for bit, as the
// plain version `stage1_compact_reference` in ops/stage1.py:
//   start  (B, R) int32  row-local byte lane of each piece start
//   plen   (B, R) int32  piece length
//   slot   (B, R) int32  word-map probe slot (0 without a word map)
//   ws[nw] (B, R) int32  little-endian content dwords masked to plen
//   cnt    (B,)   int32  pieces in the row
// Records are left-compacted per row in piece order; every lane past cnt
// holds -1 in every plane.
//
// What bounds it on this card: bytes.  It reads 1 byte per input lane
// (2 with external flags) and writes (3 + nw) * 4 bytes per lane, so
// at B=4096, R=2048, nw=3 it moves ~210 MB: ~63 us at 3.35 TB/s.  Four
// fifths of the writes are the -1 fill past each row's count.  The
// boundary rules are a few dozen integer operations per byte.
//
// Design.  The TPU kernel used a binary-gap shift network and a
// log-doubling min because Mosaic has no scan and no scatter.  Here a CTA
// of 512 threads walks a row in tiles of 2048 lanes, so a row of the
// bench's width is one tile; each thread owns 4 consecutive lanes.  The
// grid is persistent (two CTAs an SM): a CTA takes rows blockIdx.x,
// + gridDim.x, ... and loads the first window of its next row while it
// works on this one.  Per tile (steps 1-3 and the simple rules come from
// stage1_tile.cuh, which the fused kernel shares):
//   1. the tile's bytes, 16 before it and 32 past it, are staged once in
//      shared memory with 16-byte loads (bytes at or past the row's
//      length read as 0);
//   2. boundary flags: the simple rules from the class words of the
//      thread's lanes and the 4 before them, looked up once into
//      registers from a 256-entry table in shared memory; the general
//      rules from row-level scans computed once per row into shared
//      memory, each thread scanning 4 lanes and one block scan a 2048-lane
//      chunk carrying the rest (rows <= 8192 bytes, the bound the rules
//      carry); or the external flags, 4 a thread in one load;
//   3. one block scan of the threads' start counts numbers the tile's
//      pieces, and each thread writes the lanes of its starts into a list
//      in shared memory, so a piece's length is the next entry less its
//      own;
//   4. the finished records are stored one lane a thread (a warp's store
//      is 128 contiguous bytes of a plane), their content dwords read from
//      the staged bytes; at the row end the -1 fill to R, four fifths of
//      the bytes written, follows as int4 stores from the first 16-byte
//      boundary on.  A piece that runs past the tile stays pending; its
//      dwords are taken from the staged bytes before the next tile
//      replaces them, so rows of any length up to 2^21 work.
// Rows whose bytes, flags or planes are not 16-byte aligned take the same
// steps with byte loads and int32 stores.  The hashes are uint32
// arithmetic (the TPU kernel emulated it in int32 with logical shifts).

#include "stage1_tile.cuh"

namespace {

constexpr int kGeneralMaxRow = 8192;
constexpr int kPlanes = 3 + kMaxNw;

enum Rules { kSimple = 0, kGeneral = 1, kExternal = 2 };

// Class words held in shared memory (general rules).
struct SharedRow {
  const int* inf;
  int R;
  __device__ int info(int j) const { return (j >= 0 && j < R) ? inf[j] : 0; }
  __device__ bool change(int j) const {
    if (j < 0) return false;
    if (j >= R) return true;
    return j == 0 || other_class(inf[j], inf[j - 1]);
  }
  __device__ bool change_next(int j) const {
    return j >= R - 1 || other_class(inf[j], inf[j + 1]);
  }
};

// general rules at a valid lane, from the per-row scans in shared memory
__device__ bool boundary_general(const SharedRow& rw, const int* S,
                                 const int* U, const int* F, const int* NC,
                                 int i) {
  const int c = rw.info(i), m1 = rw.info(i - 1), m2 = rw.info(i - 2);
  const bool chg = rw.change(i);
  const bool chg1 = rw.change(i - 1);
  const bool chg2 = rw.change(i - 2);
  const bool chn = rw.change_next(i);
  bool b_ls, b_lc, b_p;
  common_rules(rw, i, c, m1, m2, chg, chg1, chg2, &b_ls, &b_lc, &b_p);

  const int s = S[i];
  const int u_prev = i > 0 ? U[i - 1] : -1;
  const int f = F[i];
  const int f_prev = i > 0 ? F[i - 1] : kBig;
  const int ncp = NC[i];
  const bool next_valid = (rw.info(i + 1) & kValid) != 0;
  const bool prp = s > 0 && (rw.info(s - 1) & kP);

  const bool b_num = (c & kN) && ((i - s) % 3 == 0);
  const bool is_w = (c & kW) != 0;
  const bool is_entry =
      is_w && ((prp && !(c & kNL) && u_prev < s) || (!prp && chg));
  const bool prev_ge_entry = !prp || u_prev >= s;
  const bool b_ws_tail = is_w && !chg && (m1 & kNL) && prev_ge_entry &&
                         f > ncp && !is_entry;
  const bool b_ws_last = is_w && chn && next_valid && !chg && !(m1 & kNL) &&
                         f_prev > ncp;
  return b_num || b_ls || b_lc || b_p || is_entry || b_ws_tail || b_ws_last;
}

// Block-wide exclusive scan in thread order (identity for thread 0);
// *total gets the block aggregate.  `buf` holds kWarps ints.
template <class Op>
__device__ int block_exclusive(int v, int identity, Op op, int* buf,
                               int* total) {
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
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = op(w, y);
    }
    if (lane < kWarps) buf[lane] = w;
  }
  __syncthreads();
  int ex = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) ex = identity;
  if (warp > 0) ex = op(buf[warp - 1], ex);
  *total = buf[kWarps - 1];
  __syncthreads();
  return ex;
}

// Per-row scans of the general rules, into shared memory: S[j] the last
// run change at or before j, U[j] the last valid non-newline lane at or
// before j, F[j] the first newline at or after j, NC[j] the first lane at
// or after j whose successor changes run.  Each thread scans 4
// consecutive lanes itself; one exclusive block scan a 2048-lane chunk
// carries the threads before it (the threads after it, for F and NC,
// whose threads take the chunk's lanes in reverse order).
__device__ void general_scans(const SharedRow& rw, int* S, int* U, int* F,
                              int* NC, int* buf) {
  const int R = rw.R;
  int cs = -1, cu = -1, tot;
  for (int t0 = 0; t0 < R; t0 += kTile) {
    const int j0 = t0 + kLanes * threadIdx.x;
    int ls[kLanes], lu[kLanes], s = -1, u = -1;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int j = j0 + k;
      if (j < R) {
        const int info = rw.info(j);
        if (rw.change(j)) s = j;
        if ((info & kValid) && !(info & kNL)) u = j;
      }
      ls[k] = s;
      lu[k] = u;
    }
    const int es = block_exclusive(s, -1, MaxOp(), buf, &tot);
    const int ts = tot;
    const int eu = block_exclusive(u, -1, MaxOp(), buf, &tot);
    const int ps = es > cs ? es : cs, pu = eu > cu ? eu : cu;
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      if (j0 + k < R) {
        S[j0 + k] = ls[k] > ps ? ls[k] : ps;
        U[j0 + k] = lu[k] > pu ? lu[k] : pu;
      }
    cs = ts > cs ? ts : cs;
    cu = tot > cu ? tot : cu;
  }
  int cf = kBig, cn = kBig;
  for (int t0 = ((R - 1) / kTile) * kTile; t0 >= 0; t0 -= kTile) {
    const int j0 = t0 + kLanes * (kThreads - 1 - threadIdx.x);
    int lf[kLanes], lnc[kLanes], f = kBig, n = kBig;
#pragma unroll
    for (int k = kLanes - 1; k >= 0; --k) {
      const int j = j0 + k;
      if (j < R) {
        if (rw.info(j) & kNL) f = j;
        if (rw.change_next(j)) n = j;
      }
      lf[k] = f;
      lnc[k] = n;
    }
    const int ef = block_exclusive(f, kBig, MinOp(), buf, &tot);
    const int tf = tot;
    const int en = block_exclusive(n, kBig, MinOp(), buf, &tot);
    const int pf = ef < cf ? ef : cf, pn = en < cn ? en : cn;
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      if (j0 + k < R) {
        F[j0 + k] = lf[k] < pf ? lf[k] : pf;
        NC[j0 + k] = lnc[k] < pn ? lnc[k] : pn;
      }
    cf = tf < cf ? tf : cf;
    cn = tot < cn ? tot : cn;
  }
}

struct Outputs {
  int32_t* out;     // plane k at out + k * plane: start, plen, slot, ws..
  size_t plane;     // B * R
  int nw;
  int n_words;
  uint32_t size_mask;
  uint32_t wseed;
};

// The records a tile finishes: record k of the row (lo <= k < n_rec)
// starts at lanes[k - lo] and ends where lanes[k - lo + 1] starts; its raw
// dwords come from the staged window, or from `pend` for the piece
// pending from an earlier tile (k == lo when has_pend).
struct Span {
  const int* lanes;
  const uint32_t* win;    // staged bytes, win0 the row lane of byte 0
  int win0;
  const uint32_t* pend;
  bool has_pend;
  int lo, n_rec;
};

// every plane's value of record k (lo <= k < n_rec)
__device__ __forceinline__ void record_values(const Outputs& o,
                                              const Span& sp, int k,
                                              int32_t* v) {
  const int e = k - sp.lo;
  const int s = sp.lanes[e], L = sp.lanes[e + 1] - s;
  uint32_t w[kMaxNw];
  if (sp.has_pend && e == 0) {
#pragma unroll
    for (int j = 0; j < kMaxNw; ++j) w[j] = sp.pend[j];
  } else {
    window_dwords(sp.win, sp.win0, s, w);
  }
#pragma unroll
  for (int j = 0; j < kMaxNw; ++j) {
    w[j] &= byte_mask(L - 4 * j);
  }
  v[0] = s;
  v[1] = L;
  v[2] = static_cast<int32_t>(
      o.n_words ? word_slot(w[0], w[1], w[2], L, o.wseed, o.size_mask) : 0);
#pragma unroll
  for (int j = 0; j < kMaxNw; ++j) v[3 + j] = static_cast<int32_t>(w[j]);
}

// -1 in every plane at row lanes [a, b), a lane a store
__device__ __forceinline__ void fill_lanes(const Outputs& o, size_t row_off,
                                           int a, int b) {
  for (int k = a + threadIdx.x; k < b; k += kThreads)
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      if (p < 3 + o.nw) o.out[p * o.plane + row_off + k] = -1;
}

// Store row lanes [lo, hi) of every plane: records one lane a thread (a
// warp's store covers 128 contiguous bytes of a plane), then the -1 fill
// from n_rec on.  vec: the planes are 16-byte aligned and R a multiple of
// 4, so the fill is int4 stores from the first 4-lane boundary on.
__device__ void store_span(const Outputs& o, const Span& sp, size_t row_off,
                           int hi, bool vec) {
  const int rec_hi = sp.n_rec < hi ? sp.n_rec : hi;
  for (int k = sp.lo + threadIdx.x; k < rec_hi; k += kThreads) {
    int32_t v[kPlanes];
    record_values(o, sp, k, v);
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      if (p < 3 + o.nw) o.out[p * o.plane + row_off + k] = v[p];
  }
  const int a = rec_hi > sp.lo ? rec_hi : sp.lo;
  if (a >= hi) return;
  if (!vec) {
    fill_lanes(o, row_off, a, hi);
    return;
  }
  const int a4 = ((a + 3) & ~3) < hi ? ((a + 3) & ~3) : hi;
  const int b4 = (hi & ~3) > a4 ? (hi & ~3) : a4;
  fill_lanes(o, row_off, a, a4);
  const int4 m1 = make_int4(-1, -1, -1, -1);
  for (int g = (a4 >> 2) + threadIdx.x; g < (b4 >> 2); g += kThreads) {
    int32_t* at = o.out + row_off + (g << 2);
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      if (p < 3 + o.nw) *reinterpret_cast<int4*>(at + p * o.plane) = m1;
  }
  fill_lanes(o, row_off, b4, hi);
}

template <int kRules>
__global__ void __launch_bounds__(kThreads, 2)
stage1_compact_kernel(const uint8_t* __restrict__ byts,
                      const uint8_t* __restrict__ flags,
                      const int32_t* __restrict__ lengths, int B, int R,
                      bool vec, Outputs o, int32_t* __restrict__ cnt_out) {
  __shared__ __align__(16) uint32_t win[kWin / 4];
  __shared__ int lanes[kTile + 2];
  __shared__ int buf[kWarps];
  __shared__ uint32_t pend_w[2][kMaxNw];
  __shared__ int cls[256];       // char_info of each byte value
  extern __shared__ int dyn[];   // general rules: 5 * R ints + R flags

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

    const uint8_t* gflag = nullptr;
    if (kRules == kGeneral) {
      int* inf = dyn;
      int* S = dyn + R;
      int* U = dyn + 2 * R;
      int* F = dyn + 3 * R;
      int* NC = dyn + 4 * R;
      uint8_t* fl = reinterpret_cast<uint8_t*>(dyn + 5 * R);
      __syncthreads();
      for (int j = threadIdx.x; j < R; j += kThreads)
        inf[j] = j < len ? cls[__ldg(row + j)] : 0;
      __syncthreads();
      const SharedRow srow{inf, R};
      general_scans(srow, S, U, F, NC, buf);
      __syncthreads();   // the last chunk's F and NC, read across threads
      for (int j = threadIdx.x; j < len; j += kThreads)
        fl[j] = boundary_general(srow, S, U, F, NC, j) ? 1 : 0;
      __syncthreads();
      gflag = fl;
    }

    int base = 0;        // records finished or pending before this tile
    int pend = -1;       // start lane of the piece pending from a tile
    int pbuf = 0;        // pend_w[pbuf] holds its raw dwords
    for (int t0 = 0;; t0 += kTile) {
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

      // 2. start flags of the thread's lanes i0 .. i0+3
      const int i0 = t0 + kLanes * threadIdx.x;
      unsigned m = 0;
      if (kRules == kSimple) {
        m = simple_starts(win, cls, i0, len);
      } else if (kRules == kGeneral) {
#pragma unroll
        for (int k = 0; k < kLanes; ++k)
          if (i0 + k < len && gflag[i0 + k]) m |= 1u << k;
      } else if (i0 < len) {
        const uint8_t* f = flags + row_off + i0;
        uint32_t fw;
        if (vec) {
          fw = __ldg(reinterpret_cast<const uint32_t*>(f));
        } else {
          fw = 0;
          for (int k = 0; k < kLanes && i0 + k < R; ++k)
            fw |= static_cast<uint32_t>(__ldg(f + k)) << (8 * k);
        }
#pragma unroll
        for (int k = 0; k < kLanes; ++k)
          if (i0 + k < len && ((fw >> (8 * k)) & 255)) m |= 1u << k;
      }

      // 3. number the tile's starts and list their lanes
      const int n = __popc(m);
      int total;
      const int incl = number_starts(m, i0, p_off, lanes, buf, &total);
      if (last && threadIdx.x == 0) lanes[p_off + total] = len;
      // the tile's last start stays pending past a tile that does not end
      // the row: its owner keeps the raw dwords before the window changes
      if (!last && n > 0 && incl == total)
        window_dwords(win, win0, i0 + 31 - __clz(m), pend_w[pbuf ^ 1]);
      __syncthreads();

      // 4. store the finished records; at the row end, the fill to R
      const Span sp{lanes, win, win0, pend_w[pbuf], p_off == 1, base - p_off,
                    last ? base + total : base + total - 1};
      store_span(o, sp, row_off, last ? R : sp.n_rec, vec);
      base += total;
      if (!last && total > 0) {
        pend = lanes[p_off + total - 1];
        pbuf ^= 1;
      }
      __syncthreads();
      if (last) break;
    }
    if (threadIdx.x == 0) cnt_out[r] = base;
    len = len_next;
  }
}

template <int kRules>
int launch(const uint8_t* byts, const uint8_t* flags, const int32_t* lengths,
           int B, int R, bool vec, const Outputs& o, int32_t* cnt,
           cudaStream_t stream) {
  size_t dyn = 0;
  if (kRules == kGeneral) {
    dyn = static_cast<size_t>(R) * (5 * sizeof(int) + 1);
    const cudaError_t e = cudaFuncSetAttribute(
        stage1_compact_kernel<kRules>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // (general rules on rows over 4096 bytes fit one CTA an SM in shared
  // memory; the rest of the persistent grid then waits its turn)
  int grid = 0;
  const cudaError_t e = persistent_grid(B, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  stage1_compact_kernel<kRules><<<grid, kThreads, dyn, stream>>>(
      byts, flags, lengths, B, R, vec, o, cnt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out: (3 + nw) planes of B*R int32 (start, plen, slot, ws[0..nw)).
// Returns cudaGetLastError() after the launch (0 on success), or -1
// without a launch for an empty buffer.
int tk_stage1_compact(const uint8_t* byts, const uint8_t* flags,
                      const int32_t* lengths, int B, int R, int rules,
                      int n_words, int nw, unsigned int size_mask,
                      unsigned int wseed, int32_t* out, int32_t* cnt,
                      void* stream) {
  if (B <= 0 || R <= 0) return -1;  // nothing to launch
  if (nw < 1 || nw > kMaxNw || (rules == kExternal && flags == nullptr) ||
      (rules == kGeneral && R > kGeneralMaxRow))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t plane = static_cast<size_t>(B) * R;
  const Outputs o{out, plane, nw, n_words, size_mask, wseed};
  const bool vec = R % 16 == 0 && aligned16(byts) && aligned16(out) &&
                   (flags == nullptr || aligned16(flags));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rules) {
    case kSimple:
      return launch<kSimple>(byts, flags, lengths, B, R, vec, o, cnt, s);
    case kGeneral:
      return launch<kGeneral>(byts, flags, lengths, B, R, vec, o, cnt, s);
    case kExternal:
      return launch<kExternal>(byts, flags, lengths, B, R, vec, o, cnt, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* tk_stage1_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
