// The genome engines' seeding as one kernel for Hopper (sm_90a):
//
//   seed_vote  replaces the XLA programs of anchored_fusion_tpu/align/
//              genome.py:35 _seed_diagonals (flat engine, and the seeding of
//              parallel/sharded_genome.py:120 _shard_best) and align/
//              genome_xl.py:176 _xl_seed_core (XL engine): index/kmer.py:236
//              pack_read_kmers_strided, :262 lookup_hits_table, :348
//              vote_diagonals and :317 vote_diagonals2.  For each oriented
//              read row: the base-4 keys of its k-mers at offsets 0, s,
//              2s, ..., the first H slots of each key's bucket in the
//              direct-address table, the hits' diagonals (diag mode: the
//              int32 position - offset; tile mode: the (row, col) pair of
//              the tiled genome), a sort of the row's Q*H diagonals, the
//              run-length vote (a run's end carries its length; runs on the
//              sentinel 2^30 score 0) and the stable top-k by (votes
//              descending, diagonal ascending).
//
// It is bounded by its bytes: the read codes, two table entries a valid
// k-mer, the position slots it reads and the outputs; every gather lands on
// its own 32-byte sector of a table and position array that do not fit L2
// at hg38.  This first version keeps the (rows, Q*H) diagonal matrix and
// every sort buffer out of device memory: one block takes one row, with its
// keys, bucket ranges, 64-bit sort keys and run counts in shared memory;
// the sort is a block-wide bitonic network; the run ends are a neighbour
// compare and their lengths a binary search for the run's first slot; the
// top-k is top_k block-wide arg-max passes over (votes, -slot).  Rows whose
// workspace passes the shared-memory budget run the same code over a
// global scratch buffer that the wrapper allocates, a block walking over
// rows.  Diagonals sort as unsigned 64-bit keys: the int32 diagonal (diag
// mode) or the (row, col) pair (tile mode) with their sign bits flipped;
// the padding to a power of two is the largest key and lies past every
// counted slot.
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;            // the vote sentinel
constexpr int kEmptyDiag = -(1 << 29);   // align/genome.py EMPTY_DIAG
constexpr int kMaxThreads = 512;
constexpr unsigned long long kPadKey = ~0ull;

__device__ __forceinline__ unsigned flip(int x) {
  return static_cast<unsigned>(x) ^ 0x80000000u;
}

__device__ __forceinline__ int unflip(unsigned x) {
  return static_cast<int>(x ^ 0x80000000u);
}

// floor division by a positive divisor, as torch's // on int32
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

// The maximum over the block (blockDim a multiple of 32), on every thread.
__device__ __forceinline__ unsigned long long block_max(
    unsigned long long x, unsigned long long* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = umax64(x, __shfl_xor_sync(~0u, x, o));
  const int nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int i = 1; i < nw; ++i) x = umax64(x, red[i]);
  __syncthreads();
  return x;
}

// flat (N, R) int8 oriented reads; offsets (Q,) int32, the k-mer offsets
// subtracted from the hits (k-mer q's key starts at q * stride); table
// (nT,) int32; keys_sorted (M,) int32, read only when kb < k; pos (M,)
// int32.  A row's workspace (ws bytes): P sort keys (u64), P run counts,
// then the Q k-mer keys, bucket starts and ends (int32); in shared memory,
// or at scratch + blockIdx.x * ws.  out0 (N, top_k) int32: the diagonals
// (diag mode) or the rows; out1 (N, top_k) int32: the columns (tile mode).
template <bool kTile>
__global__ void __launch_bounds__(kMaxThreads)
seed_vote_kernel(const int8_t* __restrict__ flat, int N, int R, int k, int kb,
                 int stride, int Q, const int* __restrict__ offsets,
                 const int* __restrict__ table, long long nT,
                 const int* __restrict__ keys_sorted,
                 const int* __restrict__ pos, long long M, int H, int top_k,
                 int P, int rowdiv, int stride_idx, int T,
                 unsigned char* scratch, long long ws, int* __restrict__ out0,
                 int* __restrict__ out1) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long red[kMaxThreads / 32];
  unsigned char* w = scratch != nullptr ? scratch + blockIdx.x * ws : smem;
  unsigned long long* key = reinterpret_cast<unsigned long long*>(w);
  int* cnt = reinterpret_cast<int*>(w + 8LL * P);
  int* qkey = cnt + P;
  int* qlo = qkey + Q;
  int* qhi = qlo + Q;
  const int n = Q * H;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int shift = 2 * (k - kb);

  for (int row = blockIdx.x; row < N; row += gridDim.x) {
    const int8_t* rd = flat + static_cast<size_t>(row) * R;
    // the row's k-mer keys and bucket ranges; an invalid k-mer (a code
    // >= 4 in it) takes the empty range
    for (int q = tid; q < Q; q += nt) {
      const int8_t* p = rd + static_cast<size_t>(q) * stride;
      unsigned kv = 0;
      bool bad = false;
      for (int j = 0; j < k; ++j) {
        const int c = p[j];
        kv = kv * 4u + static_cast<unsigned>(c < 4 ? c : 0);
        bad |= c >= 4;
      }
      int lo = 0, hi = 0;
      if (!bad) {
        long long b = kb < k ? (static_cast<int>(kv) >> shift)
                             : static_cast<int>(kv);
        b = b < 0 ? 0 : (b > nT - 2 ? nT - 2 : b);
        lo = __ldg(table + b);
        hi = __ldg(table + b + 1);
      }
      qkey[q] = static_cast<int>(kv);
      qlo[q] = lo;
      qhi[q] = hi;
    }
    __syncthreads();
    // a sort key a hit slot: slot j of k-mer q is valid iff lo + j < hi
    // (and, kb < k, its stored key is the k-mer's); invalid slots vote on
    // the sentinel, slots past Q*H are padding
    for (int e = tid; e < P; e += nt) {
      unsigned long long v = kPadKey;
      if (e < n) {
        const int q = e / H;
        const int s = static_cast<int>(static_cast<unsigned>(qlo[q]) +
                                       static_cast<unsigned>(e - q * H));
        bool ok = s < qhi[q];
        int hv = 0;
        if (ok) {
          const long long idx = s < 0 ? 0 : (s > M - 1 ? M - 1 : s);
          if (kb < k) ok = __ldg(keys_sorted + idx) == qkey[q];
          if (ok) hv = __ldg(pos + idx);
        }
        const int off = __ldg(offsets + q);
        if (!kTile) {
          v = flip(ok ? static_cast<int>(static_cast<unsigned>(hv) -
                                         static_cast<unsigned>(off))
                      : kBig);
        } else {
          int r = kBig, c = kBig;
          if (ok) {
            r = floordiv(hv, rowdiv);
            c = (hv - r * rowdiv) * stride_idx - off;
          }
          v = (static_cast<unsigned long long>(flip(r)) << 32) | flip(c);
        }
      }
      key[e] = v;
    }
    __syncthreads();
    // bitonic sort, ascending
    for (int size = 2; size <= P; size <<= 1) {
      for (int half = size >> 1; half > 0; half >>= 1) {
        for (int i = tid; i < (P >> 1); i += nt) {
          const int a = 2 * i - (i & (half - 1));
          const int b = a + half;
          const unsigned long long x = key[a], y = key[b];
          if ((x > y) == ((a & size) == 0)) {
            key[a] = y;
            key[b] = x;
          }
        }
        __syncthreads();
      }
    }
    // the vote: a run's last slot carries its length, found by a binary
    // search for the run's first slot; runs on the sentinel score 0
    for (int i = tid; i < n; i += nt) {
      const unsigned long long v = key[i];
      int c = 0;
      if (i == n - 1 || key[i + 1] != v) {
        const int d = kTile ? unflip(static_cast<unsigned>(v >> 32))
                            : unflip(static_cast<unsigned>(v));
        if (d != kBig) {
          int lo = 0, hi = i;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (key[mid] < v) lo = mid + 1;
            else hi = mid;
          }
          c = i - lo + 1;
        }
      }
      cnt[i] = c;
    }
    __syncthreads();
    // the stable top-k: pass j takes the largest (votes, ~slot) below the
    // last pass's; a pass that finds no vote leaves the rest empty
    unsigned long long prev = kPadKey;
    int* o0 = out0 + static_cast<size_t>(row) * top_k;
    int* o1 = kTile ? out1 + static_cast<size_t>(row) * top_k : nullptr;
    for (int j = 0; j < top_k; ++j) {
      unsigned long long best = 0;
      for (int i = tid; i < n; i += nt) {
        const int c = cnt[i];
        if (c > 0) {
          const unsigned long long x =
              (static_cast<unsigned long long>(c) << 32) |
              static_cast<unsigned>(~i);
          if (x < prev && x > best) best = x;
        }
      }
      best = block_max(best, red);
      if (best == 0) {
        for (int t = j + tid; t < top_k; t += nt) {
          o0[t] = kTile ? T : kEmptyDiag;
          if (kTile) o1[t] = 0;
        }
        break;
      }
      if (tid == 0) {
        const unsigned long long v =
            key[~static_cast<unsigned>(best & 0xffffffffull)];
        if (kTile) {
          const int r = unflip(static_cast<unsigned>(v >> 32));
          o0[j] = r < 0 ? 0 : (r > T - 1 ? T - 1 : r);
          o1[j] = unflip(static_cast<unsigned>(v));
        } else {
          o0[j] = unflip(static_cast<unsigned>(v));
        }
      }
      prev = best;
    }
    __syncthreads();  // the workspace is the next row's
  }
}

}  // namespace

// One launch over N rows: grid blocks of `threads` (a multiple of 32, at
// most 512), each row's workspace of ws bytes in dynamic shared memory
// (scratch == nullptr) or in scratch (grid * ws bytes).
extern "C" int seed_vote_launch(const void* flat, int N, int R, int k, int kb,
                                int stride, int Q, const void* offsets,
                                const void* table, long long nT,
                                const void* keys_sorted, const void* pos,
                                long long M, int H, int top_k, int P,
                                int tile, int rowdiv, int stride_idx, int T,
                                void* scratch, long long ws, int grid,
                                int threads, void* out0, void* out1,
                                void* stream) {
  auto kernel = tile ? seed_vote_kernel<true> : seed_vote_kernel<false>;
  const int smem = scratch != nullptr ? 0 : static_cast<int>(ws);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(flat), N, R, k, kb, stride, Q,
      static_cast<const int*>(offsets), static_cast<const int*>(table), nT,
      static_cast<const int*>(keys_sorted), static_cast<const int*>(pos), M,
      H, top_k, P, rowdiv, stride_idx, T,
      static_cast<unsigned char*>(scratch), ws, static_cast<int*>(out0),
      static_cast<int*>(out1));
  return static_cast<int>(cudaGetLastError());
}
