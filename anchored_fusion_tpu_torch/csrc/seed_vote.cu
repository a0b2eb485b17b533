// The genome engines' seeding as two kernels for Hopper (sm_90a):
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
//              the tiled genome), a sort of the row's diagonals, the
//              run-length vote (a run's end carries its length; a run on
//              the sentinel 2^30 scores 0) and the stable top-k by (votes
//              descending, diagonal ascending).
//
// It is bounded by its gathers: two table entries a valid k-mer and a
// position (and, for a prefix table, a key) a hit slot, each on its own
// 32-byte sector of arrays that do not fit L2 at hg38.  So the design
// keeps many independent sectors in flight and does little else (on an
// H100 the gathers take about half of a tile-mode launch at the XL
// engine's shapes, the 64-bit register sort, vote and top-k the rest):
//
//   seed_vote_warp_kernel  a warp a row, eight rows a block.  The warp
//     stages the row's codes in shared memory with 16-byte loads, builds
//     its k-mer keys there (four k-mers a lane), issues every k-mer's two
//     table loads before it reads any, and lists the row's in-range hit
//     slots at places given by a warp prefix sum.  It then issues every
//     slot's position (and key) load, eight a lane, before it uses one,
//     and compacts the valid hits by ballots: the invalid slots are
//     dropped, not sorted as sentinels.  The h hits (at most 256) sort in
//     registers, a lane holding up to eight: strides below a lane's share
//     run inside the lane, larger ones by __shfl_xor_sync; no barrier.  A
//     run's end is a compare with the next key, its start a warp max-scan
//     of the new-run indices, and the top-k is top_k warp arg-max
//     reductions of (votes, -index).  Diag keys are 32-bit, tile keys
//     64-bit.  A row with more in-range slots than the warp holds is
//     appended to a device-side list by an atomic counter.
//   seed_vote_rows_kernel  a block a row for those rows (or for every row
//     when the warp kernel is not launched: more than 128 k-mers, or rows
//     wider than 2,048): k-mer ranges and their prefix sum, a slot a
//     thread gathered into the h compacted keys, a block bitonic sort in
//     shared memory or, for rows past its budget, in a global scratch
//     slice (there the strides below a chunk that shared memory holds run
//     chunk by chunk in it, and only the larger ones in place), run starts
//     by a block max-scan and top-k block arg-max passes.  It reads the
//     list's length on the device: the host never waits.
//
// Compaction keeps the answer: equal keys are indistinguishable, so the
// sorted row of the valid hits is the sorted row of all slots with the
// sentinels cut out, and a run on the sentinel scores 0 either way (a valid
// diagonal, or tile row, equal to 2^30 too).  Ties go to the lower sorted
// index, the lower diagonal, as stable_topk.  Keys sort as unsigned: the
// int32 diagonal, or the (row, col) pair, with its sign bits flipped.
// Padding to a power of two is the largest key and lies past the h counted
// places, so a real key equal to it still counts right.
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError() after the launches.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;            // the vote sentinel
constexpr int kEmptyDiag = -(1 << 29);   // align/genome.py EMPTY_DIAG
constexpr int kWarpRows = 8;             // warps (rows) a warp-kernel block
constexpr int kLaneKmers = 4;            // k-mers a lane holds: Q <= 128
constexpr int kLaneKeys = 8;             // keys a lane sorts
constexpr int kWarpHits = 32 * kLaneKeys;
constexpr int kSlotBytes = 12;           // a listed slot: index, offset, key
constexpr int kRowThreads = 256;         // threads a rows-kernel block

struct Args {
  const int8_t* flat;  // (N, R) oriented reads
  int N, R, k, kb, stride, Q;
  const int* offsets;  // (Q,) the k-mer offsets subtracted from the hits
  const int* table;    // (nT,) bucket starts
  long long nT;
  const int* keys_sorted;  // (M,) read only when kb < k
  const int* pos;          // (M,)
  long long M;
  int H, top_k, rowdiv, sidx, T;  // tile geometry (tile mode)
  int* out0;  // (N, top_k) diagonals, or rows (tile mode)
  int* out1;  // (N, top_k) columns (tile mode)
};

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

template <typename K>
__device__ __forceinline__ K kmin(K a, K b) { return a < b ? a : b; }
template <typename K>
__device__ __forceinline__ K kmax(K a, K b) { return a < b ? b : a; }

// The sort key of a hit at index position hv of a k-mer at offset off: the
// diagonal (diag mode) or the (row, col) pair (tile mode), sign-flipped.
template <bool kTile>
__device__ __forceinline__ unsigned long long hit_key(int hv, int off,
                                                      const Args& a) {
  if (!kTile) {
    return flip(static_cast<int>(static_cast<unsigned>(hv) -
                                 static_cast<unsigned>(off)));
  }
  const int r = floordiv(hv, a.rowdiv);
  const int c = static_cast<int>(
      (static_cast<unsigned>(hv) -
       static_cast<unsigned>(r) * static_cast<unsigned>(a.rowdiv)) *
          static_cast<unsigned>(a.sidx) -
      static_cast<unsigned>(off));
  return (static_cast<unsigned long long>(flip(r)) << 32) | flip(c);
}

template <bool kTile>
__device__ __forceinline__ bool on_sentinel(unsigned long long key) {
  return unflip(kTile ? static_cast<unsigned>(key >> 32)
                      : static_cast<unsigned>(key)) == kBig;
}

template <bool kTile>
__device__ __forceinline__ void write_vote(const Args& a, int row, int j,
                                           unsigned long long key) {
  const size_t o = static_cast<size_t>(row) * a.top_k + j;
  if (kTile) {
    const int r = unflip(static_cast<unsigned>(key >> 32));
    a.out0[o] = r < 0 ? 0 : (r > a.T - 1 ? a.T - 1 : r);
    a.out1[o] = unflip(static_cast<unsigned>(key));
  } else {
    a.out0[o] = unflip(static_cast<unsigned>(key));
  }
}

template <bool kTile>
__device__ __forceinline__ void write_empty(const Args& a, int row, int j) {
  const size_t o = static_cast<size_t>(row) * a.top_k + j;
  a.out0[o] = kTile ? a.T : kEmptyDiag;
  if (kTile) a.out1[o] = 0;
}

// The base-4 key of the k codes at p (a code >= 4 counts 0 and makes the
// k-mer invalid) and its bucket range [lo, hi); an invalid k-mer takes the
// empty range.
__device__ __forceinline__ void kmer_range(const int8_t* p, const Args& a,
                                           int& key, int& lo, int& hi) {
  unsigned kv = 0;
  bool bad = false;
  for (int j = 0; j < a.k; ++j) {
    const int c = p[j];
    kv = kv * 4u + static_cast<unsigned>(c < 4 ? c : 0);
    bad |= c >= 4;
  }
  key = static_cast<int>(kv);
  lo = hi = 0;
  if (!bad) {
    long long b = a.kb < a.k ? (key >> (2 * (a.k - a.kb))) : key;
    b = b < 0 ? 0 : (b > a.nT - 2 ? a.nT - 2 : b);
    lo = __ldg(a.table + b);
    hi = __ldg(a.table + b + 1);
  }
}

// The in-range slots of a bucket: j < H with lo + j < hi.
__device__ __forceinline__ int slot_count(int lo, int hi, int H) {
  const long long n = static_cast<long long>(hi) - lo;
  return n < 0 ? 0 : (n > H ? H : static_cast<int>(n));
}

__device__ __forceinline__ long long clamp_slot(long long s, long long M) {
  return s < 0 ? 0 : (s > M - 1 ? M - 1 : s);
}

// ------------------------------------------------------------- warp path

// One stage of the warp's bitonic sort, ascending, of its 32 * L keys, key
// i = lane * L + t in v[t] — the pairs kStride apart in runs of kSize —
// then the stages after it.  Strides below L run inside the lane, the
// others by __shfl_xor_sync; every stage is generated at compile time, so
// v stays in registers.
template <int L, int kSize, int kStride, typename K>
__device__ __forceinline__ void warp_sort(K (&v)[L], int lane) {
  if constexpr (kStride >= L) {
#pragma unroll
    for (int t = 0; t < L; ++t) {
      const int i = lane * L + t;
      const K o = __shfl_xor_sync(~0u, v[t], kStride / L);
      const bool up = (i & kSize) == 0, lower = (i & kStride) == 0;
      v[t] = lower == up ? kmin(v[t], o) : kmax(v[t], o);
    }
  } else {
#pragma unroll
    for (int t = 0; t < L; ++t) {
      if ((t & kStride) == 0) {
        const bool up = ((lane * L + t) & kSize) == 0;
        const K x = v[t], y = v[t ^ kStride];
        if ((x > y) == up) {
          v[t] = y;
          v[t ^ kStride] = x;
        }
      }
    }
  }
  if constexpr (kStride > 1)
    warp_sort<L, kSize, kStride / 2>(v, lane);
  else if constexpr (kSize < 32 * L)
    warp_sort<L, 2 * kSize, kSize>(v, lane);
}

// Sort, vote and top-k of a row's h compacted keys (h <= 32 * L) in the
// warp's registers; writes the row's top_k outputs.
template <bool kTile, int L, typename K>
__device__ __forceinline__ void warp_vote(const K* keys, int h, int lane,
                                          const Args& a, int row) {
  K v[L];
#pragma unroll
  for (int t = 0; t < L; ++t) {
    const int i = lane * L + t;
    v[t] = i < h ? keys[i] : static_cast<K>(~0ull);
  }
  warp_sort<L, 2, 1>(v, lane);
  // run starts: the largest new-run index at or before each key, a lane's
  // own then a warp max-scan of the lanes before it
  const K before = __shfl_up_sync(~0u, v[L - 1], 1);
  const K after = __shfl_down_sync(~0u, v[0], 1);
  int st[L];
  int m = -1;
#pragma unroll
  for (int t = 0; t < L; ++t) {
    const int i = lane * L + t;
    if (i == 0 || (t ? v[(t + L - 1) & (L - 1)] : before) != v[t]) m = i;
    st[t] = m;
  }
  int scan = m;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(~0u, scan, d);
    if (lane >= d) scan = max(scan, o);
  }
  int carry = __shfl_up_sync(~0u, scan, 1);
  if (lane == 0) carry = -1;
  // a run's end carries its length; (votes, -index) packed in 32 bits
  unsigned packed[L];
#pragma unroll
  for (int t = 0; t < L; ++t) {
    const int i = lane * L + t;
    const bool end = i == h - 1 ||
                     (i < h - 1 &&
                      (t < L - 1 ? v[(t + 1) & (L - 1)] : after) != v[t]);
    const int votes = i - max(st[t], carry) + 1;
    packed[t] = end && !on_sentinel<kTile>(v[t])
                    ? (static_cast<unsigned>(votes) << 16) | (0xffffu - i)
                    : 0u;
  }
  // the stable top-k: pass j takes the largest packed value below the last
  // pass's; a pass that finds no vote leaves the rest empty
  unsigned prev = ~0u;
  for (int j = 0; j < a.top_k; ++j) {
    unsigned best = 0;
#pragma unroll
    for (int t = 0; t < L; ++t)
      if (packed[t] < prev && packed[t] > best) best = packed[t];
    best = __reduce_max_sync(~0u, best);
    if (best == 0) {
      for (int e = j + lane; e < a.top_k; e += 32)
        write_empty<kTile>(a, row, e);
      return;
    }
    const int i = 0xffff - static_cast<int>(best & 0xffffu);
    K sel = v[0];
#pragma unroll
    for (int t = 1; t < L; ++t)
      if (t == (i & (L - 1))) sel = v[t];
    sel = __shfl_sync(~0u, sel, i / L);
    if (lane == (j & 31)) write_vote<kTile>(a, row, j, sel);
    prev = best;
  }
}

// Per warp in dynamic shared memory: the row's codes (R rounded up to 16
// bytes), then kWarpHits listed slots (index, offset, key, int32 each),
// whose first bytes the compacted keys later take.
template <bool kTile>
__global__ void __launch_bounds__(kWarpRows * 32)
seed_vote_warp_kernel(const Args a, int cap, int* __restrict__ spill) {
  using K = typename std::conditional<kTile, unsigned long long,
                                      unsigned>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpRows + warp;
  if (row >= a.N) return;
  const int rp = (a.R + 15) & ~15;
  unsigned char* wb = smem + warp * (rp + kSlotBytes * kWarpHits);
  int8_t* codes = reinterpret_cast<int8_t*>(wb);
  int* s_idx = reinterpret_cast<int*>(wb + rp);
  int* s_off = s_idx + kWarpHits;
  int* s_key = s_off + kWarpHits;
  K* s_sorted = reinterpret_cast<K*>(wb + rp);

  const int8_t* rd = a.flat + static_cast<size_t>(row) * a.R;
  if ((a.R & 15) == 0 && (reinterpret_cast<uintptr_t>(rd) & 15) == 0) {
    for (int i = lane; i < (a.R >> 4); i += 32)
      reinterpret_cast<int4*>(codes)[i] =
          __ldg(reinterpret_cast<const int4*>(rd) + i);
  } else {
    for (int i = lane; i < a.R; i += 32) codes[i] = rd[i];
  }
  __syncwarp();

  // k-mers q = lane * kq + t: keys, then every table load before any use
  const int kq = (a.Q + 31) >> 5;
  int kkey[kLaneKmers], klo[kLaneKmers], khi[kLaneKmers], koff[kLaneKmers];
#pragma unroll
  for (int t = 0; t < kLaneKmers; ++t) {
    const int q = lane * kq + t;
    kkey[t] = klo[t] = khi[t] = koff[t] = 0;
    if (t < kq && q < a.Q) {
      kmer_range(codes + q * a.stride, a, kkey[t], klo[t], khi[t]);
      koff[t] = __ldg(a.offsets + q);
    }
  }
  int kn[kLaneKmers];
  int mine = 0;
#pragma unroll
  for (int t = 0; t < kLaneKmers; ++t) {
    kn[t] = slot_count(klo[t], khi[t], a.H);
    mine += kn[t];
  }
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(~0u, incl, d);
    if (lane >= d) incl += o;
  }
  const int S = __shfl_sync(~0u, incl, 31);
  if (S > cap) {  // past the warp: the rows kernel takes it
    if (lane == 0) spill[1 + atomicAdd(spill, 1)] = row;
    return;
  }
  if (S == 0) {
    for (int e = lane; e < a.top_k; e += 32) write_empty<kTile>(a, row, e);
    return;
  }
  // the in-range slots listed at the warp prefix
  int e = incl - mine;
#pragma unroll
  for (int t = 0; t < kLaneKmers; ++t) {
    for (int j = 0; j < kn[t]; ++j, ++e) {
      s_idx[e] = static_cast<int>(
          clamp_slot(static_cast<long long>(klo[t]) + j, a.M));
      s_off[e] = koff[t];
      s_key[e] = kkey[t];
    }
  }
  __syncwarp();
  // every slot's loads in flight before any is used: slot t * 32 + lane
  int hv[kLaneKeys], ks[kLaneKeys], off[kLaneKeys], want[kLaneKeys];
#pragma unroll
  for (int t = 0; t < kLaneKeys; ++t) {
    const int s = t * 32 + lane;
    hv[t] = ks[t] = off[t] = want[t] = 0;
    if (s < S) {
      const int idx = s_idx[s];
      hv[t] = __ldg(a.pos + idx);
      if (a.kb < a.k) {
        ks[t] = __ldg(a.keys_sorted + idx);
        want[t] = s_key[s];
      }
      off[t] = s_off[s];
    }
  }
  __syncwarp();  // the slot list is read: the keys take its place
  // compaction by ballots: the valid hits' keys at [0, h)
  int h = 0;
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int t = 0; t < kLaneKeys; ++t) {
    const bool ok = t * 32 + lane < S && ks[t] == want[t];
    const unsigned m = __ballot_sync(~0u, ok);
    if (ok)
      s_sorted[h + __popc(m & below)] =
          static_cast<K>(hit_key<kTile>(hv[t], off[t], a));
    h += __popc(m);
  }
  __syncwarp();
  if (h == 0) {
    for (int x = lane; x < a.top_k; x += 32) write_empty<kTile>(a, row, x);
  } else if (h <= 32) {
    warp_vote<kTile, 1>(s_sorted, h, lane, a, row);
  } else if (h <= 64) {
    warp_vote<kTile, 2>(s_sorted, h, lane, a, row);
  } else if (h <= 128) {
    warp_vote<kTile, 4>(s_sorted, h, lane, a, row);
  } else {
    warp_vote<kTile, 8>(s_sorted, h, lane, a, row);
  }
}

// ------------------------------------------------------------- rows path

// The maximum over the block, on every thread.
__device__ __forceinline__ unsigned long long block_max(
    unsigned long long x, unsigned long long* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = kmax(x, __shfl_xor_sync(~0u, x, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int i = 1; i < kRowThreads / 32; ++i) x = kmax(x, red[i]);
  __syncthreads();
  return x;
}

// The exclusive prefix of x over the block, and the total.
__device__ __forceinline__ int block_scan(int x, int* red, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(~0u, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) red[w] = incl;
  __syncthreads();
  int base = 0;
  total = 0;
  for (int i = 0; i < kRowThreads / 32; ++i) {
    if (i < w) base += red[i];
    total += red[i];
  }
  __syncthreads();
  return base + incl - x;
}

// The largest x over the threads before this one (-1 for thread 0).
__device__ __forceinline__ int block_max_scan(int x, int* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(~0u, incl, d);
    if (lane >= d) incl = max(incl, o);
  }
  if (lane == 31) red[w] = incl;
  __syncthreads();
  int excl = __shfl_up_sync(~0u, incl, 1);
  if (lane == 0) excl = -1;
  for (int i = 0; i < w; ++i) excl = max(excl, red[i]);
  __syncthreads();
  return excl;
}

// One bitonic stage over n keys in place (the pairs half apart, ascending
// where the lower key's index & size is 0), then a barrier.
__device__ __forceinline__ void bitonic_stage(unsigned long long* key, int n,
                                              int size, int half) {
  for (int i = threadIdx.x; i < (n >> 1); i += kRowThreads) {
    const int x0 = 2 * i - (i & (half - 1));
    const int x1 = x0 + half;
    const unsigned long long x = key[x0], y = key[x1];
    if ((x > y) == ((x0 & size) == 0)) {
      key[x0] = y;
      key[x1] = x;
    }
  }
  __syncthreads();
}

// The stages of sizes size_lo..size_hi with strides below C, on each chunk
// of C keys of key (global) staged in ch (shared): the same compare-
// exchanges as bitonic_stage, each in the chunk that holds both keys, the
// direction by the key's place in the whole row.
__device__ __forceinline__ void chunk_pass(unsigned long long* key,
                                           unsigned long long* ch, int n,
                                           int C, int size_lo, int size_hi) {
  for (int b = 0; b < n; b += C) {
    for (int i = threadIdx.x; i < C; i += kRowThreads) ch[i] = key[b + i];
    __syncthreads();
    for (int size = size_lo; size <= size_hi; size <<= 1) {
      for (int half = min(size, C) >> 1; half > 0; half >>= 1) {
        for (int i = threadIdx.x; i < (C >> 1); i += kRowThreads) {
          const int x0 = 2 * i - (i & (half - 1));
          const int x1 = x0 + half;
          const unsigned long long x = ch[x0], y = ch[x1];
          if ((x > y) == (((b + x0) & size) == 0)) {
            ch[x0] = y;
            ch[x1] = x;
          }
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < C; i += kRowThreads) key[b + i] = ch[i];
    __syncthreads();
  }
}

// A block a row, over the rows listed by the warp kernel (spill != nullptr)
// or over every row.  The row's k-mer area (Q bucket starts, Q keys, Q + 1
// slot prefixes) lies in shared memory (kmer_shared) or at the start of
// the block's scratch slice; the sort area (P keys and P run counts for P
// the power of two at or above the row's in-range slots) in the shared
// memory after it where it fits, else in the scratch slice.
template <bool kTile>
__global__ void __launch_bounds__(kRowThreads, 4)
seed_vote_rows_kernel(const Args a, const int* __restrict__ spill,
                      int kmer_shared, long long smem_bytes,
                      unsigned char* scratch, long long ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long red[kRowThreads / 32];
  __shared__ int ired[kRowThreads / 32];
  __shared__ int s_h;
  const int tid = threadIdx.x, nt = kRowThreads;
  const long long kmer_bytes = (12LL * a.Q + 4 + 15) & ~15LL;
  unsigned char* slice = scratch != nullptr ? scratch + blockIdx.x * ws
                                            : nullptr;
  unsigned char* kmer = kmer_shared ? smem : slice;
  int* qlo = reinterpret_cast<int*>(kmer);
  int* qkey = qlo + a.Q;
  int* qpre = qkey + a.Q;
  unsigned char* sort_sh = smem + (kmer_shared ? kmer_bytes : 0);
  const long long sort_room = smem_bytes - (kmer_shared ? kmer_bytes : 0);
  unsigned char* sort_gl =
      slice != nullptr ? slice + (kmer_shared ? 0 : kmer_bytes) : nullptr;
  const int nrows = spill != nullptr ? spill[0] : a.N;

  for (int w = blockIdx.x; w < nrows; w += gridDim.x) {
    const int row = spill != nullptr ? spill[1 + w] : w;
    const int8_t* rd = a.flat + static_cast<size_t>(row) * a.R;
    for (int q = tid; q < a.Q; q += nt) {
      int key, lo, hi;
      kmer_range(rd + static_cast<size_t>(q) * a.stride, a, key, lo, hi);
      qlo[q] = lo;
      qkey[q] = key;
      qpre[q] = slot_count(lo, hi, a.H);
    }
    __syncthreads();
    // the slots' prefix, a thread a chunk of k-mers
    const int per = (a.Q + nt - 1) / nt;
    const int q0 = min(a.Q, tid * per), q1 = min(a.Q, q0 + per);
    int mine = 0;
    for (int q = q0; q < q1; ++q) mine += qpre[q];
    int S;
    int base = block_scan(mine, ired, S);
    for (int q = q0; q < q1; ++q) {
      const int c = qpre[q];
      qpre[q] = base;
      base += c;
    }
    if (tid == 0) {
      qpre[a.Q] = S;
      s_h = 0;
    }
    __syncthreads();
    long long P = 2;
    while (P < S) P <<= 1;
    unsigned char* area = 12 * P <= sort_room ? sort_sh : sort_gl;
    unsigned long long* key = reinterpret_cast<unsigned long long*>(area);
    int* cnt = reinterpret_cast<int*>(area + 8 * P);
    // a slot a thread, four in flight; its k-mer by binary search
    for (int e0 = tid; e0 < S; e0 += 4 * nt) {
      int hv[4], ok[4], off[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * nt;
        ok[u] = 0;
        hv[u] = off[u] = 0;
        if (e < S) {
          int lo = 0, hi = a.Q - 1;
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (qpre[mid] <= e) lo = mid;
            else hi = mid - 1;
          }
          const long long idx = clamp_slot(
              static_cast<long long>(qlo[lo]) + (e - qpre[lo]), a.M);
          ok[u] = a.kb < a.k ? __ldg(a.keys_sorted + idx) == qkey[lo] : 1;
          hv[u] = __ldg(a.pos + idx);
          off[u] = __ldg(a.offsets + lo);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (ok[u]) {
          const int e = a.kb < a.k ? atomicAdd(&s_h, 1) : e0 + u * nt;
          key[e] = hit_key<kTile>(hv[u], off[u], a);
        }
      }
    }
    __syncthreads();
    const int h = a.kb < a.k ? s_h : S;
    if (h == 0) {
      for (int j = tid; j < a.top_k; j += nt) write_empty<kTile>(a, row, j);
      __syncthreads();
      continue;
    }
    int P2 = 2;
    while (P2 < h) P2 <<= 1;
    for (int e = h + tid; e < P2; e += nt) key[e] = ~0ull;
    __syncthreads();
    // bitonic sort, ascending: in place in shared memory; in global
    // scratch, the strides below a chunk of the shared room's keys run
    // chunk by chunk in shared memory and only the larger ones in place
    int C = 1;
    if (area != sort_sh)
      while (C < P2 && 16 * C <= sort_room) C <<= 1;
    if (area == sort_sh || C < 2) {
      for (int size = 2; size <= P2; size <<= 1)
        for (int half = size >> 1; half > 0; half >>= 1)
          bitonic_stage(key, P2, size, half);
    } else {
      unsigned long long* ch = reinterpret_cast<unsigned long long*>(sort_sh);
      chunk_pass(key, ch, P2, C, 2, C);
      for (int size = 2 * C; size <= P2; size <<= 1) {
        for (int half = size >> 1; half >= C; half >>= 1)
          bitonic_stage(key, P2, size, half);
        chunk_pass(key, ch, P2, C, size, size);
      }
    }
    // the vote: a run's last key carries its length; its first is the
    // largest new-run index at or before it (a thread's chunk of keys,
    // then a block max-scan); runs on the sentinel score 0
    {
      const int per = (h + nt - 1) / nt;
      const int i0 = min(h, tid * per), i1 = min(h, i0 + per);
      int last = -1;
      for (int i = i0; i < i1; ++i)
        if (i == 0 || key[i - 1] != key[i]) last = i;
      int start = block_max_scan(last, ired);
      for (int i = i0; i < i1; ++i) {
        const unsigned long long v = key[i];
        if (i == 0 || key[i - 1] != v) start = i;
        cnt[i] = (i == h - 1 || key[i + 1] != v) && !on_sentinel<kTile>(v)
                     ? i - start + 1
                     : 0;
      }
    }
    __syncthreads();
    // the stable top-k: pass j takes the largest (votes, -index) below the
    // last pass's; a pass that finds no vote leaves the rest empty
    unsigned long long prev = ~0ull;
    for (int j = 0; j < a.top_k; ++j) {
      unsigned long long best = 0;
      for (int i = tid; i < h; i += nt) {
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
        for (int t = j + tid; t < a.top_k; t += nt)
          write_empty<kTile>(a, row, t);
        break;
      }
      if (tid == 0)
        write_vote<kTile>(a, row, j,
                          key[~static_cast<unsigned>(best & 0xffffffffull)]);
      prev = best;
    }
    __syncthreads();  // the areas are the next row's
  }
}

// Allow a kernel `bytes` of dynamic shared memory on the current device,
// calling the runtime only when that is more than it was allowed before.
cudaError_t allow_smem(const void* kernel, int slot, int bytes) {
  constexpr int kDevices = 64;
  static int allowed[4][kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && bytes <= allowed[slot][dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kDevices) allowed[slot][dev] = bytes;
  return err;
}

}  // namespace

// One call over N rows.  warp_grid > 0: the warp kernel (warp_grid blocks
// of kWarpRows warps, warp_smem bytes of dynamic shared memory) takes the
// rows of at most cap (<= 256) in-range slots and lists the rest in spill
// ((1 + N) int32: a count, then rows), whose count is cleared first; then
// the rows kernel (block_grid blocks of kRowThreads, block_smem bytes of
// dynamic shared memory, scratch of block_grid * ws bytes or none) takes
// the listed rows.  warp_grid == 0: the rows kernel takes every row.
extern "C" int seed_vote_launch(
    const void* flat, int N, int R, int k, int kb, int stride, int Q,
    const void* offsets, const void* table, long long nT,
    const void* keys_sorted, const void* pos, long long M, int H, int top_k,
    int tile, int rowdiv, int stride_idx, int T, int warp_grid,
    int warp_smem, int cap, void* spill, int block_grid, int block_smem,
    int kmer_shared, void* scratch, long long ws, void* out0, void* out1,
    void* stream) {
  const Args a{static_cast<const int8_t*>(flat), N, R, k, kb, stride, Q,
               static_cast<const int*>(offsets), static_cast<const int*>(table),
               nT, static_cast<const int*>(keys_sorted),
               static_cast<const int*>(pos), M, H, top_k, rowdiv, stride_idx,
               T, static_cast<int*>(out0), static_cast<int*>(out1)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  int* list = nullptr;
  if (warp_grid > 0) {
    if (cap < 0 || cap > kWarpHits)
      return static_cast<int>(cudaErrorInvalidValue);
    list = static_cast<int*>(spill);
    err = cudaMemsetAsync(list, 0, sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto warp =
        tile ? seed_vote_warp_kernel<true> : seed_vote_warp_kernel<false>;
    err = allow_smem(reinterpret_cast<const void*>(warp), tile, warp_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    warp<<<warp_grid, kWarpRows * 32, warp_smem, s>>>(a, cap, list);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto rows = tile ? seed_vote_rows_kernel<true> : seed_vote_rows_kernel<false>;
  err = allow_smem(reinterpret_cast<const void*>(rows), 2 + tile, block_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rows<<<block_grid, kRowThreads, block_smem, s>>>(
      a, list, kmer_shared, block_smem, static_cast<unsigned char*>(scratch),
      ws);
  return static_cast<int>(cudaGetLastError());
}
