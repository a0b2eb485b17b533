// Batched local affine-gap Smith-Waterman for gapped refinement, written for
// Hopper: one warp per pair, an anti-diagonal wavefront held in registers,
// and the DPX max-plus instructions.
//
// Replaces the TPU kernel anchored_fusion_tpu/ops/sw_pallas.py:43 _sw_kernel
// in both of the ways the JAX package drives it:
//   fused (MASKED = false), as _sw_align_fused (:131): forward pass, then a
//     reverse pass over each pair's reversed prefix; validity is
//     code != PAD (5); out (5, B) = score, end_read, end_win,
//     start_read = end_read - reverse end_read,
//     start_win = end_win - reverse end_win.  It computes exactly
//     anchored_fusion_tpu_torch/ops/sw.py::sw_align_fused_plain.
//   forward only (MASKED = true), as sw_end_pallas (:200): validity from the
//     read_valid / window_valid masks; out (3, B) = score, end_read,
//     end_win.  It computes exactly ops/sw.py::sw_end.
//
// Recurrence of ops/sw.py (go = open + extend, ge = extend; NEG = -2^28):
//   s = match / -mismatch where both cells are valid (a valid code >= 4
//   scores a mismatch), NEG where either is not (PAD is not a wall: E, 0 and
//   F pass through);  E = max(H[j-1] - go, E[j-1] - ge);
//   HnoF = max(diag + s, E, 0);  F(i) = max_{k<i} (HnoF(k) - go - (i-1-k) ge);
//   H = max(HnoF, F).
// F here runs down each column as F(i) = max(F(i-1) - ge, HnoF(i-1) - go),
// F(0) = NEG, and crosses from lane to lane as Gotoh's
// F(i) = max(F(i-1) - ge, H(i-1) - go).  Both equal the prefix max whenever
// go >= ge (gap_open >= 0, which the wrapper checks): unrolling the first
// gives the prefix max term by term, and in the second H(i-1) - go =
// max(HnoF(i-1) - go, F(i-1) - go), where F(i-1) - go <= F(i-1) - ge.
// Any s <= NEG gives the same H (diag + s < 0 <= H), so an invalid cell may
// carry NEG twice (row and column), which stays far from overflow.
//
// The best cell.  ops/sw.py keeps the best by strict improvement, column by
// column and, within a column, at the lowest row, starting from 0 at (0, 0).
// That is the least (-H, column, row) over all cells with H > 0, or (0, 0, 0)
// if there is none.  A lane visits its columns in increasing order and keeps
// its own least: per step the largest key H * 32 + (31 - k) over its rows
// (the highest score, then the lowest row), taken only if its score beats
// the lane's best strictly.  One warp reduction (max score, then min column,
// then min row) gives the pair's.  H <= match * min(R, W) < 2^26, which
// the launch checks, keeps the key in an int.
//
// Trailing PAD.  Rows past a pair's last valid read row and columns past its
// last valid window column are not needed: every cell there has s <= NEG,
// so with go, ge >= 0 its H is 0 or at most the H of its E or F source, an
// earlier cell in (column, row) order; it never improves the best, and
// nothing valid depends on it (the DP runs down and right only).  So a pass
// runs ncols + nlanes - 1 steps, nlanes the lanes that hold valid rows, and
// the reverse pass covers rows 0..end_read and columns 0..end_win only.
// Interior PAD cells are computed as pass-through cells.  Every lane
// computes every step, with PAD for a column outside 0..ncols-1: before its
// first column that leaves H = 0 and E at its start value, after its last
// and below the valid rows it computes cells no valid cell reads, so no
// lane branches.
//
// Bound: integer operations.  A pair moves R + W bytes in (twice that with
// masks) and 12 or 20 bytes out, while the DP does about 8 int32 operations
// per cell over up to 2 R W cells; the batch is compute bound by orders of
// magnitude.
//
// Design.  The first port of this kernel (one block per pair, one thread
// per row, a column per block step) paid for every column with a shuffle
// prefix max for F, two block barriers and serial reductions over the
// warps, 2 W times in a chain: latency, not work, set its time.  Here:
// - one warp per pair, kWarps pairs per block and no traffic between warps;
// - lane l owns read rows [l RPL, (l+1) RPL), RPL the smallest power of two
//   >= R / 32; H, E and the row codes live in registers for a whole pass;
// - at step t lane l computes column j = t - l of its rows: the H and F of
//   the row above its strip at column j come from lane l-1 (computed at step
//   t-1) by one __shfl_up_sync pair, and last step's value is the diagonal;
//   lane 0 sees the top boundary (H = 0, F = NEG).  No barrier and no
//   shared-memory scan;
// - per cell: a compare and select for s, IADD3 for diag + s + column
//   penalty, __vimax_s32_relu for HnoF, a max for H, and __viaddmax_s32 with
//   one subtract for each of E (of the next column) and F (of the next row);
//   only F is on the dependent chain down a strip, one DPX instruction a row.
//   The lane's best costs a multiply-add a cell, a __vimax3_s32 per two rows
//   and a __vibmax_s32 per step;
// - the window's staged codes sit in shared memory (W bytes per pair), the
//   next step's code is loaded a step ahead, and the reverse pass reads
//   read[end_read - i] and win[end_win - j] by index arithmetic; no
//   __syncthreads anywhere;
// - rows past 32 * RPL (RPL is at most 32, so past 1,024 rows) are walked
//   in strips of 32 * RPL rows, top to bottom, each a whole wavefront over
//   the columns.  At each column the strip's last row (lane 31) writes its
//   H and F to a per-pair boundary row in global scratch (two rows of W
//   int2, written and read in turns), and the next strip's lane 0 takes
//   that boundary where the first strip sees the top edge (H = 0,
//   F = NEG), its diagonal included.  A strip's best joins the pair's by
//   before(), so the order stays higher score, earlier column, lower row.
//   Only a launch with R > 1,024 compiles the strip code (STRIPS); pairs
//   of up to 1,024 rows run the one-strip loop, which has no boundary
//   branch or store, and never touch the scratch;
// - a block holds fewer than kWarps pairs when kWarps * (R + W) bytes of
//   staged codes would pass the 227 KB of shared memory a block may use.
// The TPU kernel's transposed lane layout, log-step prefix max and scratch
// refs were Mosaic constraints and have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kPad = 5;        // staged code of an invalid cell
constexpr int kN = 4;          // staged code of a valid code >= 4
constexpr int kNoMatch = 99;   // read-side code equal to no window code
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;      // pairs per block, at most
constexpr int kMaxRpl = 32;    // rows a lane holds; taller pairs run strips
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of a block

struct Best {
  int score, col, row;
};

// a before b in the plain version's order: higher score, earlier column,
// lower row
__device__ __forceinline__ bool before(const Best& a, const Best& b) {
  return a.score > b.score ||
         (a.score == b.score &&
          (a.col < b.col || (a.col == b.col && a.row < b.row)));
}

// The least of the 32 lanes' bests, in every lane.
__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Best o{__shfl_xor_sync(kFull, b.score, off),
                 __shfl_xor_sync(kFull, b.col, off),
                 __shfl_xor_sync(kFull, b.row, off)};
    if (before(o, b)) b = o;
  }
  return b;
}

// One DP pass over nrows x ncols cells, in strips of 32 * RPL rows.
// Forward: rd[i], wn[j].  Reverse: rd[rend - i], wn[wend - j].  rd and wn
// hold staged codes (kPad invalid).  bnd: two boundary rows of ncols (H, F)
// pairs, read only when nrows passes one strip.  Without STRIPS, nrows is
// at most one strip and every strip term folds away at compile time.
template <int RPL, bool REVERSE, bool STRIPS>
__device__ Best sw_pass(const int8_t* rd, int nrows, const int8_t* wn,
                        int ncols, int rend, int wend, int match, int mismatch,
                        int go, int ge, int2* bnd) {
  constexpr int kStrip = 32 * RPL;
  const int lane = threadIdx.x & 31;
  const int e0 = max(-go, kNeg - ge);  // E of column 0: H = 0, E = NEG left
  // staged code of window column j; PAD outside the pass's columns
  const auto wcode = [&](int j) {
    return (j >= 0 && j < ncols) ? (int)wn[REVERSE ? wend - j : j] : kPad;
  };
  Best best{0, 0, 0};
  if (nrows <= 0 || ncols <= 0) return best;
  // one strip, and no loop, unless the launch compiled the strips
  const int nstrips = STRIPS ? (nrows + kStrip - 1) / kStrip : 1;
  for (int st = 0; st < nstrips; ++st) {
    const int base = STRIPS ? st * kStrip : 0;
    const int srows = STRIPS ? min(kStrip, nrows - base) : nrows;
    const int2* above = bnd + (st & 1) * ncols;   // the strip above wrote it
    int2* below = bnd + ((st + 1) & 1) * ncols;   // the strip below reads it
    const bool write_below = STRIPS && lane == 31 && st + 1 < nstrips;
    int rcmp[RPL], rbase[RPL], H[RPL], E[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int i = lane * RPL + k;
      const int c =
          i < srows ? rd[REVERSE ? rend - base - i : base + i] : kPad;
      rcmp[k] = c < 4 ? c : kNoMatch;
      rbase[k] = c != kPad ? -mismatch : kNeg;
      H[k] = 0;
      E[k] = e0;
    }
    const int nlanes = (srows + RPL - 1) / RPL;
    const int steps = ncols + nlanes - 1;
    int lastH = 0, lastF = kNeg;  // this lane's last row, its latest column
    int diag0 = 0;                // H above the lane's rows, previous column
    // The lane's best as keys H * 32 + (31 - k): a larger key is a higher
    // score, then a lower row.  bhi = best score * 32 + 31, so only a
    // strictly higher score beats it; bkey is the winning key, bcol its
    // column.
    int bhi = 31, bkey = 31, bcol = 0;
    int w = wcode(-lane);
    for (int t = 0; t < steps; ++t) {
      const int j = t - lane;
      const int wnext = wcode(j + 1);
      int upH = __shfl_up_sync(kFull, lastH, 1);
      int upF = __shfl_up_sync(kFull, lastF, 1);
      if (lane == 0) {
        // the row above the strip: the top edge, or the last row of the
        // strip above
        upH = 0;
        upF = kNeg;
        if (STRIPS && st > 0 && j < ncols) {
          const int2 b = above[j];
          upH = b.x;
          upF = b.y;
        }
      }
      const int colpen = w == kPad ? kNeg : 0;
      int F = (lane || (STRIPS && st)) ? __viaddmax_s32(upF, -ge, upH - go)
                                       : kNeg;
      int diag = diag0;
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const int s = rcmp[k] == w ? match : rbase[k];
        const int hn = __vimax_s32_relu(diag + s + colpen, E[k]);  // HnoF
        const int h = max(hn, F);
        diag = H[k];
        H[k] = h;
        E[k] = __viaddmax_s32(E[k], -ge, h - go);  // E of column j + 1
        if (k + 1 < RPL) F = __viaddmax_s32(F, -ge, hn - go);
      }
      lastH = H[RPL - 1];
      lastF = F;
      if (write_below && j >= 0 && j < ncols) below[j] = make_int2(lastH, F);
      diag0 = upH;
      w = wnext;
      int key = H[0] * 32 + 31;
#pragma unroll
      for (int k = 1; k + 1 < RPL; k += 2)
        key = __vimax3_s32(key, H[k] * 32 + (31 - k),
                           H[k + 1] * 32 + (30 - k));
      if (RPL % 2 == 0) key = max(key, H[RPL - 1] * 32 + (32 - RPL));
      bool keep;
      bhi = __vibmax_s32(bhi, key, &keep) | 31;
      bkey = keep ? bkey : key;
      bcol = keep ? bcol : j;
    }
    const Best b = warp_best(
        Best{bhi >> 5, bcol, base + lane * RPL + 31 - (bkey & 31)});
    if (before(b, best)) best = b;
    if (STRIPS) __syncwarp();  // the boundary row is whole before it is read
  }
  return best;
}

// Copy n codes to shared memory as staged codes; returns the last valid
// index (-1 if none), in every lane.
template <bool MASKED>
__device__ __forceinline__ int stage(const int8_t* __restrict__ src,
                                     const uint8_t* __restrict__ mask, int n,
                                     int8_t* dst) {
  const int lane = threadIdx.x & 31;
  int last = -1;
  for (int i = lane; i < n; i += 32) {
    const int8_t c = src[i];
    const bool v = MASKED ? mask[i] != 0 : c != kPad;
    dst[i] = v ? (c < 4 ? c : (int8_t)kN) : (int8_t)kPad;
    if (v) last = i;
  }
  return __reduce_max_sync(kFull, last);
}

template <int RPL, bool MASKED, bool STRIPS>
__global__ void __launch_bounds__(32 * kWarps)
    sw_kernel(const int8_t* __restrict__ reads, const int8_t* __restrict__ wins,
              const uint8_t* __restrict__ rmask,
              const uint8_t* __restrict__ wmask, int B, int R, int W,
              int match, int mismatch, int go, int ge, int2* scratch,
              int* __restrict__ out) {
  extern __shared__ int8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // whole warps only: nothing below syncs the block
  int8_t* rd = smem + warp * ((R + W + 15) & ~15);
  int8_t* wn = rd + R;
  int2* bnd = scratch ? scratch + (size_t)b * 2 * W : nullptr;
  const size_t ro = (size_t)b * R, wo = (size_t)b * W;
  const int last_r =
      stage<MASKED>(reads + ro, MASKED ? rmask + ro : nullptr, R, rd);
  const int last_w =
      stage<MASKED>(wins + wo, MASKED ? wmask + wo : nullptr, W, wn);
  __syncwarp();

  const Best f = sw_pass<RPL, false, STRIPS>(rd, last_r + 1, wn, last_w + 1,
                                             0, 0, match, mismatch, go, ge,
                                             bnd);
  if (MASKED) {
    if ((threadIdx.x & 31) == 0) {
      out[0 * (size_t)B + b] = f.score;
      out[1 * (size_t)B + b] = f.row;
      out[2 * (size_t)B + b] = f.col;
    }
    return;
  }
  const Best r = sw_pass<RPL, true, STRIPS>(rd, f.row + 1, wn, f.col + 1,
                                            f.row, f.col, match, mismatch, go,
                                            ge, bnd);
  if ((threadIdx.x & 31) == 0) {
    out[0 * (size_t)B + b] = f.score;
    out[1 * (size_t)B + b] = f.row;
    out[2 * (size_t)B + b] = f.col;
    out[3 * (size_t)B + b] = f.row - r.row;
    out[4 * (size_t)B + b] = f.col - r.col;
  }
}

template <int RPL, bool MASKED, bool STRIPS>
int run(const void* reads, const void* wins, const void* rmask,
        const void* wmask, int B, int R, int W, int match, int mismatch,
        int go, int ge, void* scratch, void* out, cudaStream_t stream) {
  // a pair's staged codes; as many pairs a block as its shared memory holds
  const size_t per_pair = (size_t)((R + W + 15) & ~15);
  const int warps = (int)(kMaxSmem / per_pair < (size_t)kWarps
                              ? kMaxSmem / per_pair
                              : (size_t)kWarps);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = warps * per_pair;
  auto kernel = sw_kernel<RPL, MASKED, STRIPS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(B + warps - 1) / warps, 32 * warps, smem, stream>>>(
      (const int8_t*)reads, (const int8_t*)wins, (const uint8_t*)rmask,
      (const uint8_t*)wmask, B, R, W, match, mismatch, go, ge, (int2*)scratch,
      (int*)out);
  return (int)cudaGetLastError();
}

template <bool MASKED>
int dispatch(const void* reads, const void* wins, const void* rmask,
             const void* wmask, int B, int R, int W, int match, int mismatch,
             int gap_open, int gap_extend, void* scratch, void* out,
             void* stream) {
  if (B <= 0) return 0;
  // gap_open >= 0 and gap_extend >= 0 for Gotoh's F and the PAD columns
  // outside a pass; H <= match * min(R, W) < 2^26 keeps H * 32 + 31 in an
  // int; more than one strip needs the boundary scratch
  if (R <= 0 || W <= 0 || gap_open < 0 || gap_extend < 0 ||
      (long long)match * (R < W ? R : W) >= (1LL << 26) ||
      (R > 32 * kMaxRpl && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int go = gap_open + gap_extend, ge = gap_extend;
  const cudaStream_t s = (cudaStream_t)stream;
  if (R > 32 * kMaxRpl) {
    return run<kMaxRpl, MASKED, true>(reads, wins, rmask, wmask, B, R, W,
                                      match, mismatch, go, ge, scratch, out,
                                      s);
  }
  int rpl = 1;
  while (rpl * 32 < R) rpl <<= 1;
#define SW_RUN(N)                                                           \
  case N:                                                                   \
    return run<N, MASKED, false>(reads, wins, rmask, wmask, B, R, W, match, \
                                 mismatch, go, ge, scratch, out, s);
  switch (rpl) {
    SW_RUN(1)
    SW_RUN(2)
    SW_RUN(4)
    SW_RUN(8)
    SW_RUN(16)
    SW_RUN(32)
  }
#undef SW_RUN
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// reads (B, R) int8, wins (B, W) int8, out (5, B) int32, all contiguous on
// the device; scratch (B, 2, W) int2 when R > 1024 (the strips' boundary
// rows), else null; stream is a cudaStream_t.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int sw_align_launch(const void* reads, const void* wins, int B,
                               int R, int W, int match, int mismatch,
                               int gap_open, int gap_extend, void* scratch,
                               void* out, void* stream) {
  return dispatch<false>(reads, wins, nullptr, nullptr, B, R, W, match,
                         mismatch, gap_open, gap_extend, scratch, out,
                         stream);
}

// As sw_align_launch, forward pass only, validity from read_valid (B, R) and
// window_valid (B, W) bytes (bool or uint8, nonzero = valid); out (3, B).
extern "C" int sw_end_launch(const void* reads, const void* wins,
                             const void* read_valid, const void* window_valid,
                             int B, int R, int W, int match, int mismatch,
                             int gap_open, int gap_extend, void* scratch,
                             void* out, void* stream) {
  return dispatch<true>(reads, wins, read_valid, window_valid, B, R, W, match,
                        mismatch, gap_open, gap_extend, scratch, out, stream);
}
