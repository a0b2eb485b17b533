// The anchored aligner's device core as two kernels for Hopper (sm_90a):
//
//   seed_block_max  replaces the XLA program of anchored_fusion_tpu/ops/
//                   diagonal.py:73 diag_match_counts_w and align/aligner.py:353
//                   _block_topk_diagonals' block reduction: every (read,
//                   diagonal) match count as an int8 tensor-core product of
//                   read one-hots and the reference patch matrix, rounded to
//                   bfloat16, reduced in the epilogue to each 128-diagonal
//                   block's maximum and its first arg-max lane.
//   extend_fold     replaces align/aligner.py:272 extend_diagonals (with
//                   ops/kadane.py:33 best_segment) and :300 fold_strands:
//                   the stable top-k of the block maxima (or given offsets),
//                   the reference window of every candidate, the Kadane
//                   maximal segment, the best and runner-up over k and the
//                   fold of the two strands.
//
// seed_block_max is bounded by int8 operations (2 * rows * Rs*4 * D), far
// above its bytes (codes, patch matrix, two int32 per block): the design
// keeps the (rows, D) count matrix out of device memory altogether and
// spends tensor-core work on it.  Each CTA owns 128 rows and one 128-
// diagonal block; the read one-hots are made in registers from the codes
// staged in shared memory (a one-hot group of 4 k-values is one read
// position), the patch matrix's rows for the block are staged in shared
// memory 128 k-values at a time and fed to mma.sync m16n8k32 s8 x s8 -> s32,
// exact for 0/1 operands.  No pipelining yet: a correct first kernel.
//
// extend_fold is bounded by its bytes (reads, block maxima, records); each
// candidate is one thread running Kadane serially over its R positions in
// registers, and one thread per read takes best, runner-up and the strand
// fold from shared memory.
//
// Both kernels launch on the caller's stream; the C entries return
// cudaGetLastError() after the launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPad = 5;
constexpr int kInvalid = -1000;       // ops/kadane.py INVALID
constexpr int kBlock = 128;           // diagonals per block
constexpr int kRows = 128;            // oriented reads per CTA (seed)
constexpr int kChunk = 128;           // k-values per staged chunk
constexpr int kPos = kChunk / 4;      // read positions per chunk
constexpr int kBStride = kChunk + 16; // bytes per staged patch row
constexpr int kAStride = kPos + 4;    // bytes per staged code row
constexpr int kSeedThreads = 256;     // 8 warps: 2 (rows) x 4 (diagonals)
constexpr int kFoldThreads = 256;

__device__ __forceinline__ uint32_t onehot4(int code) {
  // the 4 one-hot bytes of one read position; N and PAD are all zero
  return static_cast<unsigned>(code) < 4u ? (1u << (8 * code)) : 0u;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A non-negative count rounded to bfloat16 (round to nearest, ties to
// even), as torch's and XLA's float32 -> bfloat16 conversion; exact up to
// 256.
__device__ __forceinline__ int bf16_round(int c) {
  uint32_t u = __float_as_uint(static_cast<float>(c));
  u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  return static_cast<int>(__uint_as_float(u));
}

// codes (M, R) int8; w8 (nb*128, Kp) int8, zero past D and past Rs*4;
// bmax, lane (M, nb) int32.  Grid (nb, ceil(M / 128)).
__global__ void __launch_bounds__(kSeedThreads)
seed_block_max_kernel(const int8_t* __restrict__ codes, int M, int R,
                      int stride, int Rs, const int8_t* __restrict__ w8,
                      int D, int Kp, int nb, int* __restrict__ bmax,
                      int* __restrict__ lane_out) {
  __shared__ __align__(16) int8_t sB[kBlock * kBStride];
  __shared__ __align__(16) int8_t sA[kRows * kAStride];
  __shared__ int sKey[4][kRows];
  const int blk = blockIdx.x;
  const int m0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2;  // 64-row half of the CTA's rows
  const int wn = warp & 3;   // 32-diagonal quarter of the block

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int8_t* wblk = w8 + static_cast<size_t>(blk) * kBlock * Kp;
  for (int kc = 0; kc < Kp; kc += kChunk) {
    // the block's 128 patch rows, k-values [kc, kc + 128): 16 bytes a load
    for (int i = tid; i < kBlock * (kChunk / 16); i += kSeedThreads) {
      const int n = i / (kChunk / 16), q = i % (kChunk / 16);
      *reinterpret_cast<uint4*>(sB + n * kBStride + q * 16) =
          *reinterpret_cast<const uint4*>(
              wblk + static_cast<size_t>(n) * Kp + kc + q * 16);
    }
    // the rows' codes at sampled positions [kc/4, kc/4 + 32)
    const int p0 = kc / 4;
    for (int i = tid; i < kRows * kPos; i += kSeedThreads) {
      const int r = i / kPos, p = i % kPos;
      const int row = m0 + r, ri = p0 + p;
      int8_t c = kPad;
      if (row < M && ri < Rs)
        c = codes[static_cast<size_t>(row) * R +
                  static_cast<size_t>(ri) * stride];
      sA[r * kAStride + p] = c;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kChunk / 32; ++ks) {
      // A (16 x 32, row-major): register 0 row g, k 4t..4t+3 = position
      // 8ks + t; 1 row g + 8; 2 row g, position 8ks + 4 + t; 3 row g + 8.
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* r0 = sA + (wm * 64 + mi * 16 + g) * kAStride + ks * 8;
        const int8_t* r1 = r0 + 8 * kAStride;
        a[mi][0] = onehot4(r0[t]);
        a[mi][1] = onehot4(r1[t]);
        a[mi][2] = onehot4(r0[4 + t]);
        a[mi][3] = onehot4(r1[4 + t]);
      }
      // B (32 x 8, column-major): register 0 column g, k 4t..4t+3;
      // register 1 k 16 + 4t..
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* c =
            sB + (wn * 32 + ni * 8 + g) * kBStride + ks * 32 + t * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(c);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(c + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // Epilogue: C register e holds row g + 8 (e >> 1), diagonal lane
  // 2t + (e & 1) of its 8-wide tile.  key = count * 256 + (255 - lane): the
  // maximum key is the maximum count at its first lane.  Lanes at or past D
  // count as -1.
  const int col0 = blk * kBlock;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int best = INT_MIN;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wn * 32 + ni * 8 + t * 2 + e;
          const int v =
              col0 + col < D ? bf16_round(acc[mi][ni][h * 2 + e]) : -1;
          best = max(best, v * 256 + (255 - col));
        }
      }
      best = max(best, __shfl_xor_sync(0xffffffffu, best, 1));
      best = max(best, __shfl_xor_sync(0xffffffffu, best, 2));
      if (t == 0) sKey[wn][wm * 64 + mi * 16 + h * 8 + g] = best;
    }
  }
  __syncthreads();
  if (tid < kRows && m0 + tid < M) {
    const int key = max(max(sKey[0][tid], sKey[1][tid]),
                        max(sKey[2][tid], sKey[3][tid]));
    const size_t o = static_cast<size_t>(m0 + tid) * nb + blk;
    bmax[o] = key >> 8;           // arithmetic: -1 stays -1
    lane_out[o] = 255 - (key & 255);
  }
}

struct Segment {
  int score, start, end, matches;
};

// ops/kadane.py best_segment serially: the end is the earliest maximum
// (moves only on a strict improvement), the start the first position of
// the minimum prefix before it.
__device__ __forceinline__ Segment kadane(const int8_t* __restrict__ read,
                                          const int8_t* __restrict__ win,
                                          int R, int match, int mismatch) {
  int P = 0, Pm = 0, cmin = INT_MAX, amin = 0, pm_amin = 0;
  Segment s{INT_MIN, 0, 0, 0};
  for (int t = 0; t < R; ++t) {
    const int r = __ldg(read + t), w = __ldg(win + t);
    if (P < cmin) {  // the prefix before t sets a strict new minimum
      cmin = P;
      amin = t;
      pm_amin = Pm;
    }
    const bool valid = r != kPad && w != kPad;
    const bool eq = valid && r == w && r < 4;
    P += valid ? (eq ? match : -mismatch) : kInvalid;
    Pm += eq;
    if (P - cmin > s.score) {
      s.score = P - cmin;
      s.end = t;
      s.start = amin;
      s.matches = Pm - pm_amin;
    }
  }
  return s;
}

// flat (2B, R) int8 oriented reads (forward half, then reverse); coord_off
// (2B,) int32; refp (Lp,) int8 with `prepad` PAD codes before position 0.
// Candidates: offs (2B, k) int32, or (offs == nullptr) the stable top-k
// of bmax/lane (2B, nb) int32 over D diagonals.  out (8, B) int32: score,
// read_start, read_end, matches, length, second_score, ref_start, ref_end;
// strand (B,) int8.  Grid ceil(B / (256 / 2k)).
__global__ void __launch_bounds__(kFoldThreads)
extend_fold_kernel(const int8_t* __restrict__ flat,
                   const int* __restrict__ coord_off, int B, int R, int k,
                   const int8_t* __restrict__ refp, long long Lp,
                   long long prepad, const int* __restrict__ offs,
                   const int* __restrict__ bmax,
                   const int* __restrict__ lanes, int nb, int D, int match,
                   int mismatch, int* __restrict__ out,
                   int8_t* __restrict__ strand) {
  __shared__ int s_score[kFoldThreads], s_start[kFoldThreads],
      s_end[kFoldThreads], s_mt[kFoldThreads], s_off[kFoldThreads];
  const int per = 2 * k;
  const int reads = kFoldThreads / per;
  const int tid = threadIdx.x;
  const int lr = tid / per, s = (tid % per) / k, j = tid % k;
  const int b = blockIdx.x * reads + lr;
  const bool active = lr < reads && b < B;
  if (active) {
    const int row = s * B + b;
    int off;
    if (offs != nullptr) {
      off = offs[static_cast<size_t>(row) * k + j];
    } else {
      // rank min(j, kk - 1) of the order (maximum descending, block
      // ascending): pass i takes the first maximum among the blocks that
      // come after pass i - 1's choice
      const int* v = bmax + static_cast<size_t>(row) * nb;
      const int rank = min(j, min(k, nb) - 1);
      int pv = INT_MAX, pb = -1;
      for (int i = 0; i <= rank; ++i) {
        int cv = INT_MIN, cb = 0;
        for (int q = 0; q < nb; ++q) {
          const int x = v[q];
          if ((x < pv || (x == pv && q > pb)) && x > cv) {
            cv = x;
            cb = q;
          }
        }
        pv = cv;
        pb = cb;
      }
      const int idx = min(pb * kBlock + lanes[static_cast<size_t>(row) * nb
                                              + pb], D - 1);
      off = idx - (R - 1);
    }
    long long st = static_cast<long long>(off) + prepad;
    st = st < 0 ? 0 : (st > Lp - R ? Lp - R : st);
    const Segment sg = kadane(flat + static_cast<size_t>(row) * R,
                              refp + st, R, match, mismatch);
    s_score[tid] = sg.score;
    s_start[tid] = sg.start;
    s_end[tid] = sg.end;
    s_mt[tid] = sg.matches;
    s_off[tid] = off;
  }
  __syncthreads();
  if (!active || s != 0 || j != 0) return;
  // best (first maximum) and runner-up (maximum of the others) per strand
  int best[2], second[2];
  for (int h = 0; h < 2; ++h) {
    const int base = tid + h * k;
    int bi = base;
    for (int q = 1; q < k; ++q)
      if (s_score[base + q] > s_score[bi]) bi = base + q;
    int sec = k > 1 ? INT_MIN : 0;
    for (int q = 0; q < k; ++q)
      if (base + q != bi) sec = max(sec, s_score[base + q]);
    best[h] = bi;
    second[h] = sec;
  }
  const bool use_rev = s_score[best[1]] > s_score[best[0]];
  const int c = best[use_rev], o = best[!use_rev];
  const int co = coord_off[use_rev ? B + b : b];
  out[b] = s_score[c];
  out[B + b] = s_start[c] - co;
  out[2 * B + b] = s_end[c] - co;
  out[3 * B + b] = s_mt[c];
  out[4 * B + b] = max(s_end[c] - s_start[c] + 1, 0);
  out[5 * B + b] = max(second[use_rev], s_score[o]);
  out[6 * B + b] = s_off[c] + s_start[c];
  out[7 * B + b] = s_off[c] + s_end[c];
  strand[b] = use_rev ? 1 : 0;
}

}  // namespace

extern "C" int seed_block_max_launch(const void* codes, int M, int R,
                                     int stride, int Rs, const void* w8,
                                     int D, int Kp, int nb, void* bmax,
                                     void* lane, void* stream) {
  const dim3 grid(nb, (M + kRows - 1) / kRows);
  seed_block_max_kernel<<<grid, kSeedThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), M, R, stride, Rs,
      static_cast<const int8_t*>(w8), D, Kp, nb, static_cast<int*>(bmax),
      static_cast<int*>(lane));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int extend_fold_launch(const void* flat, const void* coord_off,
                                  int B, int R, int k, const void* refp,
                                  long long Lp, long long prepad,
                                  const void* offs, const void* bmax,
                                  const void* lane, int nb, int D, int match,
                                  int mismatch, void* out, void* strand,
                                  void* stream) {
  const int reads = kFoldThreads / (2 * k);
  extend_fold_kernel<<<(B + reads - 1) / reads, kFoldThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(flat), static_cast<const int*>(coord_off), B,
      R, k, static_cast<const int8_t*>(refp), Lp, prepad,
      static_cast<const int*>(offs), static_cast<const int*>(bmax),
      static_cast<const int*>(lane), nb, D, match, mismatch,
      static_cast<int*>(out), static_cast<int8_t*>(strand));
  return static_cast<int>(cudaGetLastError());
}
