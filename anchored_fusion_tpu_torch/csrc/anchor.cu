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
//                   fold of the two strands.  Its tile mode replaces align/
//                   genome_xl.py:221 _xl_extend_core (with :200
//                   _xl_windows_and_segments): the same over (row, col)
//                   candidates whose windows are rows of the XL engine's
//                   tiled genome, a row's base 64-bit.
//
// seed_block_max is bounded by int8 operations (2 * rows * Rs*4 * D), far
// above its bytes.  It keeps the (rows, D) count matrix out of device
// memory and runs the product on warpgroup MMAs (wgmma m64nNk32 s8 x s8 ->
// s32, exact for 0/1 operands):
//   - A, the read one-hots, lives in registers (wgmma's register-A
//     operand): a one-hot group of 4 k-values is one read position, so an
//     A register is 1 << 8*code.  Each consumer warpgroup builds its 64
//     rows' A once per work item from codes staged with 16-byte loads, and
//     reuses it over every diagonal tile of the item.
//   - B, the patch matrix, is Toeplitz: diagonal d, k-value 4p+c is
//     [ref[d + p*stride - (R-1)] == c].  A strip E of 4-byte one-hots of the
//     reference, read with a wgmma descriptor whose rows are 16 bytes apart
//     and whose two k-halves are 16 bytes apart (no swizzle, SBO 128 B, LBO
//     16 B), IS the B tile of the diagonals 4*stride apart that start at
//     the strip's first position.  So a 256-diagonal tile is 4*SN streams of
//     64/SN columns each, every stream its own strip of ~1.6 KB instead of a
//     64 KB block of the patch matrix; the strips come from the patch
//     matrix's first 4 bytes of each row (the one-hot of one reference
//     position).  A producer warp writes them into a ring of kStages shared-
//     memory stages behind mbarriers; two consumer warpgroups (128 rows) read
//     each stage.  The producer's warpgroup gives its registers to the
//     consumers (setmaxnreg), so A and two accumulators fit unspilled.
//   - The CTAs are persistent, one a SM, over items (a 128-row tile, a range
//     of diagonal tiles), so few blocks (a short reference) or wide reads
//     still fill the card.
//   - The epilogue works on the accumulator layout: key = count * 256 +
//     (255 - lane), whose maximum is the block maximum at its first lane; a
//     stream's keys reduce while the next stream's MMAs run (two
//     accumulators).  Lanes past D read zero one-hots (count 0, after every
//     real lane of their block), so they never win, as the plain version's
//     -1 never does.
//   Strides other than 1 and 2 run as stride SN in {1, 2} over a read
//   dilated by stride / SN (the skipped positions' one-hots are zero).
//   The k-steps are compile-time (8, 16 or 20: 160 positions at most, the
//   rest of a bucket zero one-hots), so no MMA sits behind a branch.  Wider
//   reads take the K-chunked variant: A rebuilt every kKC k-steps from
//   codes loaded while the previous chunk's MMAs run, every stream's
//   accumulator live, counts rounded to bfloat16.
//
// extend_fold is bounded by its bytes and int32 operations.  A lane takes
// one candidate: a row's k candidates sit on L adjacent lanes (L the power
// of two at or above k, at most 16; past 16 a lane takes several), the
// read's two rows side by side.  The top-k of a row is k arg-max passes over
// its block maxima (16 a lane in registers) by its L lanes, reduced with
// shuffles; the chosen blocks' lanes are loaded together after the passes.
// Each lane then runs Kadane serially (ops/kadane.py best_segment's order:
// the end the earliest maximum, the start the first position of the
// minimum prefix before it) over 128-position pieces of its window, which
// the warp stages in shared memory word-major - lane l loads word l of
// every window, coalesced, and each lane reads its own column without bank
// conflicts - testing 4 codes a word with byte arithmetic.  Best, runner-up
// and the strand fold are shuffle reductions in (score, rank) order.
// (Kadane as a warp-wide scan, 4 positions a lane, ran at 0.18 ms on
// main_path's block-mode batch, and 4-lane scans at 0.12 ms: the scans'
// extra instructions cost more than their shorter chains saved.)
//
// Both kernels launch on the caller's stream; the C entries return
// cudaGetLastError() after the launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPad = 5;
constexpr int kInvalid = -1000;        // ops/kadane.py INVALID
constexpr int kBlock = 128;            // diagonals per block
constexpr int kTileD = 256;            // diagonals per tile: two blocks
constexpr int kConsumers = 2;          // consumer warpgroups, 64 rows each
constexpr int kTileRows = 64 * kConsumers;
constexpr int kSeedThreads = 128 * (kConsumers + 1);  // + a producer group
constexpr int kConsumerRegs = 232;     // setmaxnreg: consumers take what
constexpr int kProducerRegs = 40;      // the producer group gives up
constexpr int kStages = 4;             // shared-memory ring depth
constexpr int kKC = 8;                 // k-steps a chunk (wide reads)
constexpr int kFoldWarps = 8;          // reads a CTA of the extension
constexpr int kMaxK = 128;             // candidates a row (ops/anchor_cuda.py MAX_K)

// The geometry of one instantiation: SN the stream stride (1 or 2), KS the
// k-steps of 8 positions a stage (all of a read's, or a chunk's).
template <int SN, int KS>
struct SeedCfg {
  static constexpr int kStreams = 4 * SN;           // diagonals d = rho mod 4SN
  static constexpr int kNW = 64 / SN;               // columns (diagonals) a stream
  static constexpr int kQ = 4 * kNW + 8 * KS;       // strip words (positions)
  static constexpr int kStripBytes = 4 * kQ;
  static constexpr int kStageBytes = kStreams * kStripBytes;
  static constexpr int kRaw = SN * (kQ - 1) + kStreams;  // words gathered
  static constexpr int kRawWords = (kRaw + 3) & ~3;
  static constexpr int kAcc = kNW / 2;              // accumulator registers
};

// The k-step counts compiled for reads held whole in registers (a read's
// steps are padded up to the next, with zero one-hots); more take chunks.
constexpr int kStepBuckets[3] = {8, 16, 20};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving accumulators across an asynchronous MMA.
template <int N>
__device__ __forceinline__ void pin(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// The B descriptor of a strip at shared address `saddr`: K-major, no
// swizzle, 8-row groups 128 bytes apart (SBO), the two 16-byte k-halves of
// a k32 step 16 bytes apart (LBO); rows of a core matrix are 16 bytes apart.
// Row a, k-byte kb is strip byte 16a + kb.
__device__ __forceinline__ uint64_t strip_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (8ull << 32);
}

template <int NW>
struct Mma;

template <>
struct Mma<64> {
  __device__ __forceinline__ static void run(int (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale));
  }
};

template <>
struct Mma<32> {
  __device__ __forceinline__ static void run(int (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale));
  }
};

__device__ __forceinline__ uint32_t onehot4(uint32_t code) {
  // the 4 one-hot bytes of one read position; N and PAD are all zero
  return code < 4u ? (1u << (8 * code)) : 0u;
}

// A non-negative count rounded to bfloat16 (round to nearest, ties to
// even), as torch's and XLA's float32 -> bfloat16 conversion; exact up to
// 256.
__device__ __forceinline__ int bf16_round(int c) {
  uint32_t u = __float_as_uint(static_cast<float>(c));
  u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  return static_cast<int>(__uint_as_float(u));
}

// Fold one stream's accumulators into the running keys of this thread's
// two rows (h) and the tile's two blocks.  Register i holds row g + 8h
// (h = bit 1 of i), column a = 8j + 2t + e (j = i / 4, e = bit 0): diagonal
// rho + 4SN*a of the tile, lane rho + 4SN*a - 128*blk of block blk.  So
// key = c*256 + ct(j, e) - (rho + 8SN*t) with ct known at compile time.
template <int SN, bool ROUND>
__device__ __forceinline__ void fold_keys(const int (&d)[32 / SN], int rt,
                                          int (&run)[2][2]) {
  constexpr int kS = 4 * SN, kJB = 4 / SN;  // chunks j per block
  int m[2][2] = {{INT_MIN, INT_MIN}, {INT_MIN, INT_MIN}};
#pragma unroll
  for (int i = 0; i < 32 / SN; ++i) {
    const int j = i >> 2, e = i & 1, h = (i >> 1) & 1, blk = j / kJB;
    const int ct = 255 + 128 * blk - kS * (8 * j + e);
    const int c = ROUND ? bf16_round(d[i]) : d[i];
    m[h][blk] = max(m[h][blk], c * 256 + ct);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int b = 0; b < 2; ++b) run[h][b] = max(run[h][b], m[h][b] - rt);
}

// The quad's keys -> bmax and lane of rows r0 + 8h, blocks 2*tile + b.
__device__ __forceinline__ void store_keys(int (&run)[2][2], int r0, int M,
                                           int tile, int nb, int t4,
                                           int* __restrict__ bmax,
                                           int* __restrict__ lane_out) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      int k = run[h][b];
      k = max(k, __shfl_xor_sync(0xffffffffu, k, 1));
      k = max(k, __shfl_xor_sync(0xffffffffu, k, 2));
      run[h][b] = k;
    }
  const int h = t4 >> 1, b = t4 & 1;
  const int row = r0 + 8 * h, blk = 2 * tile + b;
  const int k = h ? (b ? run[1][1] : run[1][0]) : (b ? run[0][1] : run[0][0]);
  if (row < M && blk < nb) {
    const size_t o = static_cast<size_t>(row) * nb + blk;
    bmax[o] = k >> 8;
    lane_out[o] = 255 - (k & 255);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) run[hh][bb] = INT_MIN;
}

// The code of (row, dilated position p) as the product sees it: sampled
// read position p * SN when p is a multiple of sd and inside the read.
__device__ __forceinline__ bool sampled(int p, int sd, int SN, int R) {
  return (sd == 1 || p % sd == 0) && p * SN < R;
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// codes (M, R) int8; w8 (nb*128, Kp) int8 patch matrix (its first 4 bytes
// of row y: the one-hot of reference position y - (R-1)); sd the dilation
// (stride / SN); KSR the read's k-steps of 8 dilated positions (KS of them
// a stage: all when CH is false, a chunk's when true); items of G groups of
// at most TPG diagonal tiles a 128-row tile.  bmax, lane (M, nb) int32.
template <int SN, bool CH, int KS>
__global__ void __launch_bounds__(kSeedThreads, 1)
seed_block_max_kernel(const int8_t* __restrict__ codes, int M, int R, int sd,
                      int KSR, const int8_t* __restrict__ w8, int D, int Kp,
                      int nb, int G, int TPG, int* __restrict__ bmax,
                      int* __restrict__ lane_out) {
  using C = SeedCfg<SN, KS>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  uint8_t* ring = smem + 128;
  uint32_t* raw = reinterpret_cast<uint32_t*>(ring + kStages * C::kStageBytes);
  int8_t* staged = reinterpret_cast<int8_t*>(raw + C::kRawWords);
  const int Rp = (R + 15) & ~15;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int DT = (D + kTileD - 1) / kTileD;
  const int nitems = ((M + kTileRows - 1) / kTileRows) * G;
  const int nch = CH ? (KSR + KS - 1) / KS : 1;
  const int warp = tid >> 5, lane = tid & 31;

  if (warp >= 4 * kConsumers) {
    // Producer group: one warp writes, for each stage (tile, chunk), the
    // strips of every stream, E_rho[q] = onehot of reference position
    // y - (R-1), y = tile*256 + rho + SN*(p0 + q), from the patch matrix's
    // rows (zero past D).
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 4 * kConsumers) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = blockIdx.x; it < nitems; it += gridDim.x) {
      const int g = it % G;
      const int t0 = g * TPG, t1 = min(DT, t0 + TPG);
      for (int t = t0; t < t1; ++t) {
        for (int c = 0; c < nch; ++c) {
          const long long y0 = static_cast<long long>(t) * kTileD +
                               static_cast<long long>(SN) * (c * 8 * KS);
          mbar_wait(empty + stage, phase ^ 1);
          // the gathers, 8 a lane in flight
          for (int i0 = 0; i0 < C::kRaw; i0 += 256) {
            uint32_t v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int i = i0 + 32 * u + lane;
              const long long y = y0 + i;
              v[u] = i < C::kRaw && y < D
                         ? __ldg(reinterpret_cast<const uint32_t*>(
                               w8 + y * static_cast<long long>(Kp)))
                         : 0u;
            }
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (i0 + 32 * u + lane < C::kRaw) raw[i0 + 32 * u + lane] = v[u];
          }
          __syncwarp();
          uint8_t* st = ring + stage * C::kStageBytes;
          constexpr int per = C::kQ / 4;
          for (int i = lane; i < C::kStreams * per; i += 32) {
            const int rho = i / per, q = 4 * (i % per);
            const uint32_t* src = raw + rho + SN * q;
            *reinterpret_cast<uint4*>(st + rho * C::kStripBytes + 4 * q) =
                make_uint4(src[0], src[SN], src[2 * SN], src[3 * SN]);
          }
          // the strips are read by the tensor cores (the async proxy)
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(full + stage);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg takes rows [64wg, 64wg + 64) of the tile.
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2, wq = warp & 3;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int rl = wq * 16 + g8;  // this thread's rows rl, rl + 8 of the 64
  int stage = 0;
  uint32_t phase = 0;
  int run[2][2] = {{INT_MIN, INT_MIN}, {INT_MIN, INT_MIN}};
  int8_t* mine = staged + wg * 64 * Rp;
  for (int it = blockIdx.x; it < nitems; it += gridDim.x) {
    const int rt = it / G, g = it % G;
    const int t0 = g * TPG, t1 = min(DT, t0 + TPG);
    const int row0 = rt * kTileRows + wg * 64;
    const int r0 = row0 + rl;
    if constexpr (!CH) {
      // The warpgroup's 64 rows of codes, 16 bytes a load where the rows
      // allow it, then A for every k-step in registers.
      const int tw = tid & 127;
      named_sync(1 + wg);
      if (((reinterpret_cast<uintptr_t>(codes) | R) & 15) == 0) {
        const int per = R >> 4;
        for (int i = tw; i < 64 * per; i += 128) {
          const int r = i / per, q = i % per;
          uint4 v = make_uint4(0x05050505u, 0x05050505u, 0x05050505u,
                               0x05050505u);
          if (row0 + r < M)
            v = __ldg(reinterpret_cast<const uint4*>(
                          codes + static_cast<size_t>(row0 + r) * R) + q);
          *reinterpret_cast<uint4*>(mine + r * Rp + 16 * q) = v;
        }
      } else {
        for (int i = tw; i < 64 * R; i += 128) {
          const int r = i / R, q = i % R;
          mine[r * Rp + q] =
              row0 + r < M ? codes[static_cast<size_t>(row0 + r) * R + q]
                           : static_cast<int8_t>(kPad);
        }
      }
      named_sync(1 + wg);
      uint32_t a[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          // register x: row rl + 8 (x & 1), position 8ks + t + 4 (x >> 1)
          const int p = 8 * ks + t4 + 4 * (x >> 1);
          const int r = rl + 8 * (x & 1);
          a[ks][x] = sampled(p, sd, SN, R)
                         ? onehot4(static_cast<uint8_t>(mine[r * Rp + p * SN]))
                         : 0u;
        }
      }
      for (int t = t0; t < t1; ++t) {
        mbar_wait(full + stage, phase);
        const uint32_t sb = smem_u32(ring + stage * C::kStageBytes);
        int acc[2][C::kAcc];
        auto mma_stream = [&](int (&d)[C::kAcc], int rho) {
          pin(d);
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            Mma<C::kNW>::run(
                d, a[ks], strip_desc(sb + rho * C::kStripBytes + 32 * ks),
                ks > 0);
          wg_commit();
          pin(d);
        };
        mma_stream(acc[0], 0);
#pragma unroll
        for (int rho = 0; rho < C::kStreams; ++rho) {
          if (rho + 1 < C::kStreams) {
            mma_stream(acc[(rho + 1) & 1], rho + 1);
            wg_wait<1>();
          } else {
            wg_wait<0>();
          }
          pin(acc[rho & 1]);
          fold_keys<SN, false>(acc[rho & 1], rho + 2 * C::kStreams * t4, run);
        }
        // every MMA reading the stage has completed in this warp
        if (lane == 0) mbar_arrive(empty + stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
        store_keys(run, r0, M, t, nb, t4, bmax, lane_out);
      }
    } else {
      for (int t = t0; t < t1; ++t) {
        int acc[C::kStreams][C::kAcc];
        int prev = 0;
        for (int c = 0; c < nch; ++c) {
          // this chunk's codes, 4 a register, loaded while the previous
          // chunk's MMAs run
          uint32_t cw[KS];
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            uint32_t w = 0;
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int p = (c * KS + ks) * 8 + t4 + 4 * (x >> 1);
              const int row = r0 + 8 * (x & 1);
              const uint32_t code =
                  row < M && sampled(p, sd, SN, R)
                      ? static_cast<uint8_t>(__ldg(
                            codes + static_cast<size_t>(row) * R +
                            static_cast<size_t>(p) * SN))
                      : static_cast<uint32_t>(kPad);
              w |= code << (8 * x);
            }
            cw[ks] = w;
          }
          mbar_wait(full + stage, phase);
          wg_wait<0>();  // the previous chunk's MMAs, which read a
          if (c > 0 && lane == 0) mbar_arrive(empty + prev);
          uint32_t a[KS][4];
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              a[ks][x] = onehot4((cw[ks] >> (8 * x)) & 0xffu);
          const uint32_t sb = smem_u32(ring + stage * C::kStageBytes);
#pragma unroll
          for (int rho = 0; rho < C::kStreams; ++rho) pin(acc[rho]);
          wg_fence();
#pragma unroll
          for (int rho = 0; rho < C::kStreams; ++rho)
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
              Mma<C::kNW>::run(
                  acc[rho], a[ks],
                  strip_desc(sb + rho * C::kStripBytes + 32 * ks),
                  c > 0 || ks > 0);
          wg_commit();
#pragma unroll
          for (int rho = 0; rho < C::kStreams; ++rho) pin(acc[rho]);
          prev = stage;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        wg_wait<0>();
        if (lane == 0) mbar_arrive(empty + prev);
#pragma unroll
        for (int rho = 0; rho < C::kStreams; ++rho) {
          pin(acc[rho]);
          fold_keys<SN, true>(acc[rho], rho + 2 * C::kStreams * t4, run);
        }
        store_keys(run, r0, M, t, nb, t4, bmax, lane_out);
      }
    }
  }
}

// The 4 codes at p (PAD from a word at or past `end`), from the two aligned
// words around them: a word holding no byte before `end` is not read.
__device__ __forceinline__ uint32_t word_at(const int8_t* p,
                                            const int8_t* end) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t e = reinterpret_cast<uintptr_t>(end);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const uint32_t lo =
      reinterpret_cast<uintptr_t>(w) < e ? __ldg(w) : 0x05050505u;
  const uint32_t hi =
      reinterpret_cast<uintptr_t>(w + 1) < e ? __ldg(w + 1) : 0x05050505u;
  return __funnelshift_r(lo, hi, 8 * static_cast<uint32_t>(a & 3));
}

// 0x80 in every zero byte of x, 0 elsewhere.
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x | 0x7f7f7f7fu);
}


struct Segment {
  int score, start, end, matches;
};

// A row's best candidate so far: its segment, offset and rank, and the
// maximum score of the row's other candidates.
struct Best {
  Segment s;
  int off, rank, second;
};

// Of two rows' summaries over disjoint candidates, the one whose best comes
// first in (score descending, rank ascending); the other's scores join the
// runner-up.
__device__ __forceinline__ Best merge_best(const Best& a, const Best& b) {
  const bool a_wins =
      a.s.score > b.s.score || (a.s.score == b.s.score && a.rank < b.rank);
  Best w = a_wins ? a : b;
  w.second = max(max(a.second, b.second), a_wins ? b.s.score : a.s.score);
  return w;
}

__device__ __forceinline__ Best shfl_xor_best(const Best& x, int o) {
  Best y;
  y.s.score = __shfl_xor_sync(0xffffffffu, x.s.score, o);
  y.s.start = __shfl_xor_sync(0xffffffffu, x.s.start, o);
  y.s.end = __shfl_xor_sync(0xffffffffu, x.s.end, o);
  y.s.matches = __shfl_xor_sync(0xffffffffu, x.s.matches, o);
  y.off = __shfl_xor_sync(0xffffffffu, x.off, o);
  y.rank = __shfl_xor_sync(0xffffffffu, x.rank, o);
  y.second = __shfl_xor_sync(0xffffffffu, x.second, o);
  return y;
}

struct FoldSmem {
  uint32_t win[32][33];   // this piece of the 32 lanes' windows, word-major
  int off[2 * kMaxK];     // the row groups' chosen blocks, then offsets
};

// flat (2B, R) int8 oriented reads (forward half, then reverse); coord_off
// (2B,) int32; refp (Lp,) int8 with `prepad` PAD codes before position 0.
// Candidates: offs (2B, k) int32, or (offs == nullptr) the stable top-k
// of bmax/lane (2B, nb) int32 over D diagonals.  out (8, B) int32: score,
// read_start, read_end, matches, length, second_score, ref_start, ref_end;
// strand (B,) int8.  Tile mode (rows != nullptr): refp holds Lp / W tile
// rows of W codes, candidate j is (rows[., j], offs[., j]) with `prepad`
// the tiles' halo, and out is (10, B) (extend_fold_tiles_launch).  A lane a candidate: L lanes (a power of two, at most
// 16, at or above the row's distinct candidates) a row, the read's two
// rows side by side, 16 / L reads a warp;
// grid ceil(B / (kFoldWarps * 16 / L)).
__global__ void __launch_bounds__(32 * kFoldWarps)
extend_fold_kernel(const int8_t* __restrict__ flat,
                   const int* __restrict__ coord_off, int B, int R, int k,
                   int L, const int8_t* __restrict__ refp, long long Lp,
                   long long prepad, const int* __restrict__ offs,
                   const int* __restrict__ bmax,
                   const int* __restrict__ lanes, int nb, int D, int match,
                   int mismatch, int* __restrict__ out,
                   int8_t* __restrict__ strand,
                   const int* __restrict__ rows, long long W) {
  __shared__ FoldSmem sm[kFoldWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a row's kk distinct candidates (block mode: ranks past the blocks
  // repeat the last, and only reach the runner-up)
  const int kk = offs != nullptr ? k : min(k, nb);
  const int rg = lane / L, gl = lane & (L - 1);  // row group, lane in it
  const int h = rg & 1;
  const int rpw = 16 / L;                        // reads a warp
  const int b0 = (blockIdx.x * kFoldWarps + warp) * rpw;
  if (b0 >= B) return;
  const int b = b0 + (rg >> 1);
  const bool live = b < B;
  const size_t row = static_cast<size_t>(h) * B + (live ? b : B - 1);
  FoldSmem& S = sm[warp];
  int* offw = S.off + rg * kk;  // (32 / L) * kk <= 2 * kMaxK

  if (offs == nullptr) {
    // the stable top-k of the row: pass j takes the first maximum among
    // the blocks after (pv, pb) in the order (maximum descending, block
    // ascending), by the row's L lanes; 16 maxima a lane stay in registers
    const int* v = bmax + row * nb;
    const int nc = min(16, (nb - gl + L - 1) / L);  // cached a lane
    int cache[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i >= nc) break;
      cache[i] = __ldg(v + gl + L * i);
    }
    int pv = INT_MAX, pb = -1;
    for (int j = 0; j < kk; ++j) {
      int cv = INT_MIN, cq = INT_MAX;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (i >= nc) break;
        const int q = gl + L * i, x = cache[i];
        if ((x < pv || (x == pv && q > pb)) && x > cv) {
          cv = x;
          cq = q;
        }
      }
      for (int q = gl + 16 * L; q < nb; q += L) {
        const int x = __ldg(v + q);
        if ((x < pv || (x == pv && q > pb)) && x > cv) {
          cv = x;
          cq = q;
        }
      }
      for (int o = 1; o < L; o <<= 1) {
        const int ov = __shfl_xor_sync(0xffffffffu, cv, o);
        const int oq = __shfl_xor_sync(0xffffffffu, cq, o);
        if (ov > cv || (ov == cv && oq < cq)) {
          cv = ov;
          cq = oq;
        }
      }
      pv = cv;
      pb = cq;
      if (gl == 0) offw[j] = pb;
    }
    __syncwarp();
    // the chosen blocks' lanes, loaded together
    for (int j = gl; j < kk; j += L) {
      const int blk = offw[j];
      offw[j] = min(blk * kBlock + __ldg(lanes + row * nb + blk), D - 1) -
                (R - 1);
    }
  } else {
    for (int j = gl; j < k; j += L) offw[j] = __ldg(offs + row * k + j);
  }
  __syncwarp();

  const int8_t* rd = flat + row * R;
  const int8_t* flat_end = flat + static_cast<size_t>(2) * B * R;
  const bool aligned = ((reinterpret_cast<uintptr_t>(flat) | R) & 3) == 0;
  const int gain = match + mismatch;  // a match's score over a mismatch's
  const int8_t* ref_end = refp + Lp;
  const int npiece = (R + 127) >> 7;
  Best mine{{INT_MIN, 0, 0, 0}, 0, INT_MAX, INT_MIN};
  int last = INT_MIN;  // the score of rank kk - 1, on its lane
  for (int j = gl; j - gl < kk; j += L) {
    const bool act = j < kk;
    const int jj = act ? j : kk - 1;
    const int off = offw[jj];
    // the window's row: the reference, or (tile mode) its tile row
    const long long lim = rows != nullptr ? W : Lp;
    long long st = static_cast<long long>(off) + prepad;
    st = st < 0 ? 0 : (st > lim - R ? lim - R : st);
    if (rows != nullptr)
      st += static_cast<long long>(__ldg(rows + row * k + jj)) * W;
    // windows whose staged words all lie inside refp load unguarded
    const bool clear = __all_sync(
        0xffffffffu, st + 128LL * npiece + 8 <= Lp);
    int T = 0, Pm = 0, cmin = INT_MAX, amin = 0, pma = 0;
    Segment sg{INT_MIN, 0, 0, 0};
    for (int pc = 0; pc < npiece; ++pc) {
      // the 32 lanes' windows, word-major: lane l loads word l of each
      // window (coalesced; 32 / nw2 windows a pass when a piece holds
      // nw2 < 32 words), each lane then reads its own column
      const int nw = min(32, (R - 128 * pc + 3) >> 2);
      const int nw2 = nw > 16 ? 32 : (nw > 8 ? 16 : (nw > 4 ? 8 : 4));
      const int wl = lane & (nw2 - 1), ws = lane / nw2;
      __syncwarp();
#pragma unroll 8
      for (int x0 = 0; x0 < 32; x0 += 32 / nw2) {
        const long long sx = __shfl_sync(0xffffffffu, st, x0 + ws);
        const int8_t* p = refp + sx + 128 * pc + 4 * wl;
        uint32_t wv;
        if (clear) {
          const uint32_t* w = reinterpret_cast<const uint32_t*>(
              reinterpret_cast<uintptr_t>(p) & ~uintptr_t(3));
          wv = __funnelshift_r(__ldg(w), __ldg(w + 1),
                               8 * static_cast<uint32_t>(
                                   reinterpret_cast<uintptr_t>(p) & 3));
        } else {
          wv = word_at(p, ref_end);
        }
        S.win[wl][x0 + ws] = wv;
      }
      __syncwarp();
#pragma unroll 4
      for (int l = 0; l < 32; ++l) {
        const int p0 = 128 * pc + 4 * l;
        if (p0 >= R) break;
        const uint32_t w4 = S.win[l][lane];
        const uint32_t r4 =
            aligned ? __ldg(reinterpret_cast<const uint32_t*>(rd + p0))
                    : word_at(rd + p0, flat_end);
        // byte flags: a match (equal and a base) and an invalid position
        // (PAD on either side)
        const uint32_t eqm = zero_bytes((r4 ^ w4) | (r4 & 0xfcfcfcfcu));
        const uint32_t inv = zero_bytes(r4 ^ 0x05050505u) |
                             zero_bytes(w4 ^ 0x05050505u);
        // one position, branch-free: the prefix before t a new minimum,
        // then the segment ending at t an improvement
        auto step = [&](int i) {
          const int t = p0 + i;
          const int eq = (eqm >> (8 * i + 7)) & 1;
          const int sc =
              (inv >> (8 * i + 7)) & 1 ? kInvalid : eq * gain - mismatch;
          const bool nm = T < cmin;
          cmin = nm ? T : cmin;
          amin = nm ? t : amin;
          pma = nm ? Pm : pma;
          T += sc;
          Pm += eq;
          const int v = T - cmin;
          const bool up = v > sg.score;
          sg.score = up ? v : sg.score;
          sg.start = up ? amin : sg.start;
          sg.end = up ? t : sg.end;
          sg.matches = up ? Pm - pma : sg.matches;
        };
        if (p0 + 4 <= R) {
          step(0);
          step(1);
          step(2);
          step(3);
        } else {
#pragma unroll
          for (int i = 0; i < 3; ++i)
            if (p0 + i < R) step(i);
        }
      }
    }
    if (act) mine = merge_best(mine, Best{sg, off, j, INT_MIN});
    if (j == kk - 1) last = sg.score;
  }
  // the row's best and runner-up over its L lanes (with the repeats of
  // rank kk - 1), then the strand fold with the other row of the read
  // (lane ^ L)
  for (int o = 1; o < L; o <<= 1) {
    mine = merge_best(mine, shfl_xor_best(mine, o));
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  }
  if (kk < k) mine.second = max(mine.second, last);
  if (k == 1) mine.second = 0;
  const Best other = shfl_xor_best(mine, L);
  if (!live || h != 0 || gl != 0) return;
  const bool use_rev = other.s.score > mine.s.score;
  const Best& w = use_rev ? other : mine;
  const int co = coord_off[use_rev ? B + b : b];
  if (rows != nullptr) {
    // tile mode: genome_xl.py XL_FIELDS, the row of the best candidate
    // and the columns of its ends
    const size_t rb = use_rev ? static_cast<size_t>(B) + b : b;
    int* o = out + b;
    const size_t s = B;
    o[0] = w.s.score;
    o[s] = use_rev ? 1 : 0;
    o[2 * s] = w.s.start - co;
    o[3 * s] = w.s.end - co;
    o[4 * s] = w.s.matches;
    o[5 * s] = max(w.s.end - w.s.start + 1, 0);
    o[6 * s] = max(w.second, use_rev ? mine.s.score : other.s.score);
    o[7 * s] = __ldg(rows + rb * k + w.rank);
    o[8 * s] = w.off + w.s.start;
    o[9 * s] = w.off + w.s.end;
    return;
  }
  out[b] = w.s.score;
  out[static_cast<size_t>(B) + b] = w.s.start - co;
  out[static_cast<size_t>(2) * B + b] = w.s.end - co;
  out[static_cast<size_t>(3) * B + b] = w.s.matches;
  out[static_cast<size_t>(4) * B + b] = max(w.s.end - w.s.start + 1, 0);
  out[static_cast<size_t>(5) * B + b] =
      max(w.second, use_rev ? mine.s.score : other.s.score);
  out[static_cast<size_t>(6) * B + b] = w.off + w.s.start;
  out[static_cast<size_t>(7) * B + b] = w.off + w.s.end;
  strand[b] = use_rev ? 1 : 0;
}

// How a launch of the seeding kernel is laid out: the stream stride SN and
// dilation sd, the read's k-steps and the steps a stage (its bucket, or a
// chunk), the variant, the item split and the grid.
struct SeedPlan {
  int SN, sd, KSR, KS, chunked, G, TPG, grid, smem;
};

template <int SN, bool CH, int KS>
size_t seed_smem(int R) {
  using C = SeedCfg<SN, KS>;
  return 128 + kStages * C::kStageBytes + 4 * C::kRawWords +
         (CH ? 0 : static_cast<size_t>(kTileRows) * ((R + 15) & ~15));
}

// The instantiations: (SN, bucket) for reads held whole, (SN, chunk).
template <typename F>
cudaError_t seed_dispatch(const SeedPlan& p, F&& f) {
  if (p.SN == 1) {
    if (p.chunked) return f.template run<1, true, kKC>();
    if (p.KS == 8) return f.template run<1, false, 8>();
    if (p.KS == 16) return f.template run<1, false, 16>();
    return f.template run<1, false, 20>();
  }
  if (p.chunked) return f.template run<2, true, kKC>();
  if (p.KS == 8) return f.template run<2, false, 8>();
  if (p.KS == 16) return f.template run<2, false, 16>();
  return f.template run<2, false, 20>();
}

struct SmemOf {
  int R;
  size_t bytes = 0;
  template <int SN, bool CH, int KS>
  cudaError_t run() {
    bytes = seed_smem<SN, CH, KS>(R);
    return cudaSuccess;
  }
};

SeedPlan seed_plan(int M, int R, int stride, int Rs, int D, int sms) {
  SeedPlan p;
  p.SN = stride % 2 == 0 ? 2 : 1;
  p.sd = stride / p.SN;
  p.KSR = static_cast<int>((static_cast<long long>(Rs) * p.sd + 7) / 8);
  p.chunked = p.KSR > kStepBuckets[2];
  p.KS = kKC;
  if (!p.chunked)
    for (int b = 2; b >= 0; --b)
      if (p.KSR <= kStepBuckets[b]) p.KS = kStepBuckets[b];
  const int DT = (D + kTileD - 1) / kTileD;
  const int RT = (M + kTileRows - 1) / kTileRows;
  // split each row tile's diagonal tiles into G groups: at least ~4 items
  // a CTA, each as long as that allows (A is built once an item)
  p.G = min(DT, max(1, (4 * sms + RT - 1) / RT));
  p.TPG = (DT + p.G - 1) / p.G;
  p.G = (DT + p.TPG - 1) / p.TPG;
  const long long items = static_cast<long long>(RT) * p.G;
  p.grid = static_cast<int>(items < sms ? items : sms);
  SmemOf sm{R};
  seed_dispatch(p, sm);
  p.smem = static_cast<int>(sm.bytes);
  return p;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

struct SeedLaunch {
  const SeedPlan& p;
  const int8_t* codes;
  int M, R;
  const int8_t* w8;
  int D, Kp, nb;
  int *bmax, *lane;
  cudaStream_t stream;
  template <int SN, bool CH, int KS>
  cudaError_t run() {
    auto kernel = seed_block_max_kernel<SN, CH, KS>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<p.grid, kSeedThreads, p.smem, stream>>>(
        codes, M, R, p.sd, p.KSR, w8, D, Kp, nb, p.G, p.TPG, bmax, lane);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int seed_block_max_launch(const void* codes, int M, int R,
                                     int stride, int Rs, const void* w8,
                                     int D, int Kp, int nb, void* bmax,
                                     void* lane, void* stream) {
  const SeedPlan p = seed_plan(M, R, stride, Rs, D, sm_count());
  SeedLaunch l{p, static_cast<const int8_t*>(codes), M, R,
               static_cast<const int8_t*>(w8), D, Kp, nb,
               static_cast<int*>(bmax), static_cast<int*>(lane),
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(seed_dispatch(p, l));
}

// The seeding kernel's plan for a shape (no launch): SN, sd, the read's
// k-steps, the steps a stage, chunked, G, TPG, grid and dynamic
// shared-memory bytes, in that order.
extern "C" int seed_block_max_plan(int M, int R, int stride, int Rs, int D,
                                   int* out) {
  const SeedPlan p = seed_plan(M, R, stride, Rs, D, sm_count());
  const int v[9] = {p.SN, p.sd,  p.KSR, p.KS,  p.chunked,
                    p.G,  p.TPG, p.grid, p.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return static_cast<int>(cudaGetLastError());
}

extern "C" int extend_fold_launch(const void* flat, const void* coord_off,
                                  int B, int R, int k, const void* refp,
                                  long long Lp, long long prepad,
                                  const void* offs, const void* bmax,
                                  const void* lane, int nb, int D, int match,
                                  int mismatch, void* out, void* strand,
                                  void* stream) {
  const int kk = offs != nullptr ? k : (k < nb ? k : nb);
  int L = 1;
  while (L < kk && L < 16) L <<= 1;
  const int reads = kFoldWarps * (16 / L);
  extend_fold_kernel<<<(B + reads - 1) / reads, 32 * kFoldWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(flat), static_cast<const int*>(coord_off), B,
      R, k, L, static_cast<const int8_t*>(refp), Lp, prepad,
      static_cast<const int*>(offs), static_cast<const int*>(bmax),
      static_cast<const int*>(lane), nb, D, match, mismatch,
      static_cast<int*>(out), static_cast<int8_t*>(strand), nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// Tile mode (the XL engine): candidates (rows, cols) (2B, k) int32 of the
// tiled genome tiles (T+1 rows of W codes, total = (T+1) * W), the window
// of (row, col) tiles[row, clamp(col + halo, 0, W - R) : ... + R]; out
// (10, B) int32 rows of genome_xl.py XL_FIELDS.
extern "C" int extend_fold_tiles_launch(const void* flat,
                                        const void* coord_off, int B, int R,
                                        int k, const void* tiles,
                                        long long total, long long W,
                                        long long halo, const void* rows,
                                        const void* cols, int match,
                                        int mismatch, void* out,
                                        void* stream) {
  int L = 1;
  while (L < k && L < 16) L <<= 1;
  const int reads = kFoldWarps * (16 / L);
  extend_fold_kernel<<<(B + reads - 1) / reads, 32 * kFoldWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(flat), static_cast<const int*>(coord_off), B,
      R, k, L, static_cast<const int8_t*>(tiles), total, halo,
      static_cast<const int*>(cols), nullptr, nullptr, 0, 0, match, mismatch,
      static_cast<int*>(out), nullptr, static_cast<const int*>(rows), W);
  return static_cast<int>(cudaGetLastError());
}
