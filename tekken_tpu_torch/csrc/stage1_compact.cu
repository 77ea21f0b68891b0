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
// at B=4096, R=2048, nw=3 it moves ~210 MB: ~63 us at 3.35 TB/s.  The
// boundary rules are a few dozen integer operations per byte.
//
// Design.  The TPU kernel used a binary-gap shift network and a
// log-doubling min because Mosaic has no scan and no scatter; on CUDA
// one CTA walks one row in tiles of kThreads lanes:
//   1. boundary flags: the simple rules from a halo of neighbour bytes
//      (i-4 .. i+2); the general rules from row-level scans computed once
//      per row into shared memory (rows <= 8192 bytes, the bound the
//      rules carry); or the external flags read from the input;
//   2. a block-wide exclusive scan of the tile's start flags gives each
//      piece its compact id, and the starts are scattered into shared
//      memory by id, so thread k writes record k: consecutive threads
//      write consecutive lanes (coalesced stores);
//   3. a piece's length is the distance to the next start; the last
//      piece of a tile stays pending until a later tile (or the row end)
//      supplies its end, so rows of any length up to 2^21 work;
//   4. lanes cnt..R-1 of every plane are filled with -1.
// The hashes are uint32 arithmetic (the TPU kernel emulated it in int32
// with logical shifts).

#include "stage1_rules.cuh"

namespace {

constexpr int kGeneralMaxRow = 8192;

enum Rules { kSimple = 0, kGeneral = 1, kExternal = 2 };

// Class words and scans held in shared memory (general rules).
struct SharedRow {
  const int* inf;
  int R;
  __device__ int info(int j) const { return (j >= 0 && j < R) ? inf[j] : 0; }
  __device__ bool change(int j) const {
    if (j < 0) return false;
    if (j >= R) return true;
    return j == 0 || group(inf[j]) != group(inf[j - 1]);
  }
  __device__ bool change_next(int j) const {
    return j >= R - 1 || group(inf[j]) != group(inf[j + 1]);
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

struct Outputs {
  int32_t* start;
  int32_t* plen;
  int32_t* slot;
  int32_t* ws;      // nw planes, `plane` apart
  size_t plane;     // B * R
  int nw;
  int n_words;
  uint32_t size_mask;
  uint32_t wseed;
};

// write the record of piece `id` (start lane s, length L) of a row
__device__ void write_record(const Outputs& o, const uint8_t* row,
                             size_t row_off, int id, int s, int L) {
  uint32_t w[6];
  piece_dwords(row, s, L, o.nw, w);
  const uint32_t slot =
      o.n_words ? word_slot(w[0], w[1], w[2], L, o.wseed, o.size_mask) : 0;
  const size_t at = row_off + id;
  o.start[at] = s;
  o.plen[at] = L;
  o.slot[at] = static_cast<int32_t>(slot);
  for (int j = 0; j < o.nw; ++j)
    o.ws[j * o.plane + at] = static_cast<int32_t>(w[j]);
}

// per-row scans of the general rules, into shared memory
__device__ void general_scans(const SharedRow& rw, int* S, int* U, int* F,
                              int* NC, int* buf) {
  const int R = rw.R;
  int cs = -1, cu = -1, tot;
  for (int t0 = 0; t0 < R; t0 += kThreads) {
    const int j = t0 + threadIdx.x;
    const bool in = j < R;
    const int info = rw.info(j);
    const int vs = (in && rw.change(j)) ? j : -1;
    const int vu = (in && (info & kValid) && !(info & kNL)) ? j : -1;
    const int s = block_scan(vs, -1, MaxOp(), buf, &tot);
    const int ts = tot;
    const int u = block_scan(vu, -1, MaxOp(), buf, &tot);
    if (in) {
      S[j] = s > cs ? s : cs;
      U[j] = u > cu ? u : cu;
    }
    cs = ts > cs ? ts : cs;
    cu = tot > cu ? tot : cu;
  }
  // reverse scans: thread k takes lane t0 + kThreads-1-k, so a scan in
  // thread order is a suffix scan in lane order
  int cf = kBig, cn = kBig;
  const int last_tile = ((R - 1) / kThreads) * kThreads;
  for (int t0 = last_tile; t0 >= 0; t0 -= kThreads) {
    const int j = t0 + (kThreads - 1 - threadIdx.x);
    const bool in = j < R;
    const int info = rw.info(j);
    const int vf = (in && (info & kNL)) ? j : kBig;
    const int vn = (in && rw.change_next(j)) ? j : kBig;
    const int f = block_scan(vf, kBig, MinOp(), buf, &tot);
    const int tf = tot;
    const int n = block_scan(vn, kBig, MinOp(), buf, &tot);
    if (in) {
      F[j] = f < cf ? f : cf;
      NC[j] = n < cn ? n : cn;
    }
    cf = tf < cf ? tf : cf;
    cn = tot < cn ? tot : cn;
  }
}

__global__ void __launch_bounds__(kThreads)
stage1_compact_kernel(const uint8_t* __restrict__ byts,
                      const uint8_t* __restrict__ flags,
                      const int32_t* __restrict__ lengths, int R, int rules,
                      Outputs o, int32_t* __restrict__ cnt_out) {
  __shared__ int tstart[kThreads];
  __shared__ int buf[kWarps];
  extern __shared__ int dyn[];   // general rules: 5 * R ints + R flags

  const int r = blockIdx.x;
  const size_t row_off = static_cast<size_t>(r) * R;
  const uint8_t* row = byts + row_off;
  int len = lengths[r];
  len = len < 0 ? 0 : (len > R ? R : len);

  const GlobalRow grow{row, len};
  uint8_t* gflag = nullptr;
  if (rules == kGeneral) {
    int* inf = dyn;
    int* S = dyn + R;
    int* U = dyn + 2 * R;
    int* F = dyn + 3 * R;
    int* NC = dyn + 4 * R;
    gflag = reinterpret_cast<uint8_t*>(dyn + 5 * R);
    for (int j = threadIdx.x; j < R; j += kThreads)
      inf[j] = j < len ? char_info(__ldg(row + j)) : 0;
    __syncthreads();
    const SharedRow srow{inf, R};
    general_scans(srow, S, U, F, NC, buf);
    for (int j = threadIdx.x; j < len; j += kThreads)
      gflag[j] = boundary_general(srow, S, U, F, NC, j) ? 1 : 0;
    __syncthreads();
  }

  int base = 0;            // pieces written or pending before this tile
  int pend_start = -1;     // the last piece seen, awaiting its end
  for (int t0 = 0; t0 < len; t0 += kThreads) {
    const int i = t0 + threadIdx.x;
    bool bnd = false;
    if (i < len) {
      if (rules == kSimple)
        bnd = boundary_simple(grow, i);
      else if (rules == kGeneral)
        bnd = gflag[i] != 0;
      else
        bnd = __ldg(flags + row_off + i) != 0;
    }
    int total;
    const int incl = block_scan(bnd ? 1 : 0, 0, AddOp(), buf, &total);
    if (bnd) tstart[incl - 1] = i;
    __syncthreads();
    if (total > 0) {
      if (pend_start >= 0 && threadIdx.x == 0)
        write_record(o, row, row_off, base - 1, pend_start,
                     tstart[0] - pend_start);
      const int k = threadIdx.x;
      if (k < total - 1)
        write_record(o, row, row_off, base + k, tstart[k],
                     tstart[k + 1] - tstart[k]);
      pend_start = tstart[total - 1];
      base += total;
    }
    __syncthreads();
  }
  if (pend_start >= 0 && threadIdx.x == 0)
    write_record(o, row, row_off, base - 1, pend_start, len - pend_start);

  const int cnt = base;
  for (int lane = cnt + threadIdx.x; lane < R; lane += kThreads) {
    const size_t at = row_off + lane;
    o.start[at] = -1;
    o.plen[at] = -1;
    o.slot[at] = -1;
    for (int j = 0; j < o.nw; ++j) o.ws[j * o.plane + at] = -1;
  }
  if (threadIdx.x == 0) cnt_out[r] = cnt;
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
  if (rules == kGeneral && R > kGeneralMaxRow)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t plane = static_cast<size_t>(B) * R;
  Outputs o{out, out + plane, out + 2 * plane, out + 3 * plane, plane,
            nw, n_words, size_mask, wseed};
  size_t dyn = 0;
  if (rules == kGeneral) {
    dyn = static_cast<size_t>(R) * (5 * sizeof(int) + 1);
    const cudaError_t e = cudaFuncSetAttribute(
        stage1_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  stage1_compact_kernel<<<B, kThreads, dyn,
                          static_cast<cudaStream_t>(stream)>>>(
      byts, flags, lengths, R, rules, o, cnt);
  return static_cast<int>(cudaGetLastError());
}

const char* tk_stage1_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
