"""The genome engines' seeding kernel (csrc/seed_vote.cu) and the tile mode
of the extension kernel (csrc/anchor.cu), through their plain versions,
against the JAX package, exactly.

On the CPU ``seed_vote_plain`` runs on numpy-seeded inputs beside the JAX
package's ``align/genome.py::_seed_diagonals`` (diag mode) and
``align/genome_xl.py::_xl_seed_core`` (tile mode, on nibble-packed reads),
and ``extend_fold_plain``'s tile mode beside ``_xl_extend_core``: every
integer output must be equal.  The cases cover an exact table (kb == k)
and a prefix table (kb < k), H 4, 8, 16 and 32, top_k 1, 4 and 8, query
strides 1 and 6, all-PAD reads, rows with fewer distinct diagonals than
top_k, count ties and buckets longer than H (a tandem repeat), a valid
diagonal equal to the vote sentinel 2^30, and a row wider than the
warp kernel and the rows kernel's shared memory.  Adversarial rows on a
hand-made index add diagonals above 2^30 and below 0, a tile row at 2^30,
rows with every slot valid and rows with none.  The two kernels' steps
(the warp prefix sum and spill test, the slot list, the ballot
compaction, the register/shuffle bitonic network at every h up to the
warp's 256, the max-scan run starts and the arg-max top-k; the rows
kernel's slot prefix, binary-searched gather, block network, run counts
and top-k passes) are emulated in numpy on every route — the warp kernel,
every row listed for the rows kernel, every listed row in global scratch,
a launch split between the two — and held to the plain version and to
JAX.  On a card (marked ``cuda``) both kernels are held equal to their
plain versions on every case and every route.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anchored_fusion_tpu.align import genome as jgen
from anchored_fusion_tpu.align import genome_xl as jxl
from anchored_fusion_tpu.index import kmer as jkm
from anchored_fusion_tpu.ops.encode import pack_nibbles
from anchored_fusion_tpu_torch.align import genome_xl as txl
from anchored_fusion_tpu_torch.align.aligner import both_strands
from anchored_fusion_tpu_torch.index.kmer import read_kmer_offsets
from anchored_fusion_tpu_torch.ops import anchor, anchor_cuda
from anchored_fusion_tpu_torch.ops import seed_vote as sv
from anchored_fusion_tpu_torch.ops import seed_vote_cuda as svc

PAD, N_CODE = 5, 4
_RC = np.array([3, 2, 1, 0, 4, 5], np.int8)
BIG = 2 ** 30
MATCH, MISMATCH = 1, 4
GENOME_BP = 30_000
REPEAT = (12_000, 14_000)        # a 7-base unit repeated: ties, long buckets

# (id, k, kb < k, query stride, H, top_k, R, reads, special)
CASES = [
    ("exact-H4-top1", 8, False, 1, 4, 1, 128, 24, None),
    ("exact-H8-top4", 8, False, 1, 8, 4, 128, 24, None),
    ("exact-H16-top8", 8, False, 6, 16, 8, 128, 24, None),
    ("exact-H32-top4", 8, False, 6, 32, 4, 160, 24, None),
    ("prefix-H4-top4", 11, True, 1, 4, 4, 128, 24, None),
    ("prefix-H8-top8", 11, True, 6, 8, 8, 128, 24, None),
    ("prefix-H32-top1", 11, True, 1, 32, 1, 112, 24, None),
    ("prefix-H16-top4-s6", 11, True, 6, 16, 4, 112, 24, None),
    ("sentinel-diagonal", 8, False, 1, 8, 4, 128, 24, "sentinel"),
    ("wide-row", 8, False, 1, 32, 8, 1024, 8, None),
]
TILE_CASES = [c for c in CASES if not c[2] and c[8] is None]
TILE_C, TILE_HALO, INDEX_STRIDE = 4096, 256, 2


def make_genome(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, GENOME_BP).astype(np.int8)
    lo, hi = REPEAT
    codes[lo:hi] = np.tile(rng.integers(0, 4, 7), -(-(hi - lo) // 7))[
        :hi - lo]
    codes[5_000:5_040] = N_CODE
    codes[rng.integers(0, GENOME_BP, 20)] = N_CODE
    return codes


def make_reads(rng, codes, n: int, R: int) -> np.ndarray:
    """(n, R) int8: reads copied from the genome (a third reverse
    complemented, 1% substitutions, 101 bases or the row), some in the
    repeat, one all PAD, one all N, one with only 12 bases."""
    L = len(codes)
    m = min(R, 101 if R <= 160 else R - 24)
    reads = np.full((n, R), PAD, np.int8)
    for i in range(n):
        s = (int(rng.integers(REPEAT[0], REPEAT[1] - m)) if i % 4 == 1
             else int(rng.integers(0, L - m)))
        seg = codes[s:s + m].copy()
        err = rng.random(m) < 0.01
        seg[err] = (seg[err] + 1) % 4
        if i % 3 == 2:
            seg = _RC[seg][::-1]
        reads[i, :m] = seg
    reads[0] = PAD
    reads[1, :m] = N_CODE
    reads[2, 12:] = PAD
    return reads


def diag_index(codes, k: int, prefix: bool):
    """The JAX package's host build: (keys, pos, table, kb); kb < k when
    ``prefix``, k otherwise."""
    kb = k - 2 if prefix else k
    kv, pos, table, kb = jkm.build_index_arrays(codes, k, bucket_bases=kb)
    assert (kb < k) == prefix
    return kv, pos, table, kb


def case_inputs(case):
    """(flat (2B, R) int8, index arrays, offsets, kb) of a diag-mode case;
    the sentinel case shifts every position so that the forward row of
    read 3 has its true diagonal at 2^30."""
    name, k, prefix, stride, H, top_k, R, n, special = case
    codes = make_genome()
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    reads = make_reads(rng, codes, n, R)
    kv, pos, table, kb = diag_index(codes, k, prefix)
    if special == "sentinel":
        s = int(rng.integers(20_000, 25_000))
        reads[3] = PAD
        reads[3, :101] = codes[s:s + 101]
        pos = (pos + (BIG - s)).astype(np.int32)
    flat, _ = both_strands(torch.from_numpy(reads))
    offs = read_kmer_offsets(R, k, stride)
    return flat, (table, kv, pos), offs, kb


def jax_seed_diag(flat, index, offs, k, kb, stride, H, top_k):
    table, kv, pos = index
    return np.asarray(jgen._seed_diagonals(
        jnp.asarray(flat.numpy()), jnp.asarray(table), jnp.asarray(kv),
        jnp.asarray(pos), jnp.asarray(offs), k, kb, stride, H, top_k))


def port_args(flat, index, offs, k, kb, stride, H, top_k, device="cpu"):
    table, kv, pos = index
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (flat.to(device), t(table), t(kv), t(pos), t(offs), k, kb, stride,
            H, top_k)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_seed_vote_diag_matches_jax(case):
    name, k, prefix, stride, H, top_k, R, n, special = case
    flat, index, offs, kb = case_inputs(case)
    want = jax_seed_diag(flat, index, offs, k, kb, stride, H, top_k)
    args = port_args(flat, index, offs, k, kb, stride, H, top_k)
    got = sv.seed_vote_plain(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the dispatcher runs the plain version on CPU tensors
    assert torch.equal(svc.seed_vote(*args), got)
    # the cases reach the edges they are named for: an all-PAD row, rows
    # with fewer distinct diagonals than top_k
    empty = (got == sv.EMPTY_DIAG).sum(1)
    assert empty[0] == top_k and (empty < top_k).any()
    if top_k > 1:
        assert ((empty > 0) & (empty < top_k)).any()
    if special == "sentinel":
        assert not (got[3] == BIG).any()
    if name == "wide-row":
        p = svc.plan(flat.shape[0], len(offs), H, R)
        assert not p["warp"] and p["scratch_ws"] > 0
        assert p["block_grid"] == flat.shape[0]


def xl_world():
    """The JAX package's merged XL index and tiles of the test genome at
    small tiles: (codes, table, pos_div, tiles, T)."""
    codes = make_genome(1)
    table, pos_div = jxl.build_index_xl(codes, 8, INDEX_STRIDE)
    tiles = jxl.build_tiles_host(codes, TILE_C, TILE_HALO)
    return (codes, np.array(table), np.array(pos_div), np.array(tiles),
            tiles.shape[0] - 1)


@pytest.fixture(scope="module")
def xl():
    return xl_world()


def tile_case(xl, case):
    codes, table, pos_div, tiles, T = xl
    name, k, _, stride, H, top_k, R, n, _ = case
    rng = np.random.default_rng(zlib.crc32(b"tile-" + name.encode()))
    reads = make_reads(rng, codes, n, R)
    # two reads across tile edges, one at the genome's end (last tile row)
    for i, at in zip((4, 5, 6), (TILE_C - 50, 3 * TILE_C - 30,
                                 len(codes) - 101)):
        reads[i] = PAD
        reads[i, :101] = codes[at:at + 101]
    offs = read_kmer_offsets(R, k, stride)
    return reads, offs


def jax_seed_tile(xl, reads, offs, k, stride, H, top_k):
    _, table, pos_div, _, T = xl
    rc, cc = jxl._xl_seed_core(
        jnp.asarray(pack_nibbles(reads)), jnp.asarray(table),
        jnp.asarray(pos_div), jnp.asarray(offs), k=k, kb=k,
        stride_idx=INDEX_STRIDE, stride_q=stride, max_hits=H, top_k=top_k,
        T=T, C=TILE_C, R=reads.shape[1])
    return np.array(rc), np.array(cc)


@pytest.mark.parametrize("case", TILE_CASES, ids=[c[0] for c in TILE_CASES])
def test_seed_vote_tile_matches_jax(xl, case):
    name, k, _, stride, H, top_k, R, n, _ = case
    _, table, pos_div, _, T = xl
    reads, offs = tile_case(xl, case)
    want = jax_seed_tile(xl, reads, offs, k, stride, H, top_k)
    t = torch.from_numpy
    got = txl._xl_seed_core(t(reads), t(table), t(pos_div), t(offs), k=k,
                            kb=k, stride_idx=INDEX_STRIDE, stride_q=stride,
                            max_hits=H, top_k=top_k, T=T, C=TILE_C)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    flat, _ = both_strands(t(reads))
    plain = sv.seed_vote_plain(flat, t(table), t(table[:1]), t(pos_div),
                               t(offs), k, k, stride, H, top_k,
                               tile=(TILE_C // INDEX_STRIDE, INDEX_STRIDE, T))
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    assert (got[0] == T).any() and (got[0] == T - 1).any()


def tile_candidates(xl, case):
    """Voted (rows, cols) of a tile case, then edited: every 5th row's last
    slot empty (row T), a negative column that reads into the halo, a
    candidate on the last tile row."""
    name, k, _, stride, H, top_k, R, n, _ = case
    _, _, _, _, T = xl
    reads, offs = tile_case(xl, case)
    rc, cc = jax_seed_tile(xl, reads, offs, k, stride, H, top_k)
    rc[::5, -1], cc[::5, -1] = T, 0
    rc[7, 0], cc[7, 0] = 1, -(TILE_HALO // 2)
    rc[8, -1], cc[8, -1] = T - 1, TILE_C - 60
    return reads, rc, cc


@pytest.mark.parametrize("top_k", [1, 4, 8])
def test_extend_fold_tile_mode_matches_jax(xl, top_k):
    case = ("tile-extend", 8, False, 1, 8, top_k, 128, 24, None)
    _, _, _, tiles, T = xl
    reads, rc, cc = tile_candidates(xl, case)
    want = np.asarray(jxl._xl_extend_core(
        jnp.asarray(pack_nibbles(reads)), jnp.asarray(tiles), jnp.asarray(rc),
        jnp.asarray(cc), top_k, MATCH, MISMATCH, TILE_HALO, reads.shape[1]))
    t = torch.from_numpy
    got = txl._xl_extend_core(t(reads), t(tiles), t(rc), t(cc), top_k, MATCH,
                              MISMATCH, TILE_HALO)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    flat, co = both_strands(t(reads))
    rec = anchor.extend_fold_plain(flat, co, t(tiles), TILE_HALO, MATCH,
                                   MISMATCH, top_k, offs=t(cc), rows=t(rc))
    assert tuple(rec) == txl.XL_FIELDS
    for f, row in zip(txl.XL_FIELDS, want):
        np.testing.assert_array_equal(rec[f].numpy(), row, f)
    # the dispatcher takes the plain version on CPU tensors
    via = anchor_cuda.extend_fold(flat, co, t(tiles), TILE_HALO, MATCH,
                                  MISMATCH, top_k, offs=t(cc), rows=t(rc))
    assert all(torch.equal(via[f], rec[f]) for f in rec)
    assert (want[0] > 0).any()


# ---------------------------------------------------- the kernel's steps

LANES = 32
U64 = np.uint64


def _flip(x):
    return (np.asarray(x, np.int64) & 0xFFFFFFFF) ^ 0x80000000


def _unflip(u):
    return ((np.asarray(u, np.int64) & 0xFFFFFFFF) ^ 0x80000000).astype(
        np.uint32).view(np.int32).astype(np.int64)


def hit_keys(hv, off, tile):
    """csrc/seed_vote.cu hit_key: the sign-flipped int32 diagonal, or the
    sign-flipped (row, col) pair in 64 bits (int32 arithmetic wraps)."""
    hv = np.asarray(hv, np.int64)
    off = np.asarray(off, np.int64)
    if tile is None:
        return _flip(hv - off).astype(np.uint64)
    rowdiv, sidx, _ = tile
    r = hv // rowdiv
    c = ((hv - r * rowdiv) * sidx - off).astype(np.int64)
    return ((_flip(r).astype(np.uint64) << U64(32))
            | _flip(c).astype(np.uint64))


def primary(key, tile):
    key = np.asarray(key, np.uint64)
    return _unflip(key >> U64(32) if tile is not None else key)


def kmer_ranges(row, k, kb, stride, Q, table):
    """kmer_range for every k-mer of a row: (key, lo, hi) int64, the key in
    int32 arithmetic, an invalid k-mer's range empty."""
    codes = row.astype(np.int64)
    kv = np.zeros(Q, np.int64)
    bad = np.zeros(Q, bool)
    for j in range(k):
        c = codes[np.arange(Q) * stride + j]
        kv = kv * 4 + np.where(c < 4, c, 0)
        bad |= c >= 4
    kv = (kv & 0xFFFFFFFF).astype(np.uint32).view(np.int32).astype(np.int64)
    b = np.clip(kv >> (2 * (k - kb)) if kb < k else kv, 0, len(table) - 2)
    lo = np.where(bad, 0, table[b]).astype(np.int64)
    hi = np.where(bad, 0, table[b + 1]).astype(np.int64)
    return kv, lo, hi


def warp_scan(x, op):
    """An inclusive scan over the 32 lanes by __shfl_up_sync steps."""
    x = np.array(x)
    d = 1
    while d < LANES:
        x[d:] = op(x[d:], x[:-d])
        d *= 2
    return x


def warp_sort(v):
    """The warp kernel's register network on (32, L) keys, key i = lane *
    L + t at v[lane, t]: strides below L inside a lane, the others between
    lanes lane and lane ^ (stride / L) (__shfl_xor_sync)."""
    v = v.copy()
    L = v.shape[1]
    lane = np.arange(LANES)
    i = lane[:, None] * L + np.arange(L)[None, :]
    size = 2
    while size <= LANES * L:
        stride = size // 2
        while stride:
            up = (i & size) == 0
            if stride >= L:
                o = v[lane ^ (stride // L)]
                keep_min = ((i & stride) == 0) == up
                v = np.where(keep_min, np.minimum(v, o), np.maximum(v, o))
            else:
                t = np.arange(L)
                t = t[(t & stride) == 0]
                x, y = v[:, t], v[:, t + stride]
                swap = (x > y) == up[:, t]
                v[:, t], v[:, t + stride] = (np.where(swap, y, x),
                                             np.where(swap, x, y))
            stride //= 2
        size *= 2
    return v


def warp_vote(keys, tile, top_k):
    """warp_vote: the h compacted keys in registers (L a lane, the fewest
    of 1, 2, 4, 8 that hold them), sorted, run starts by a lane's running
    maximum and a warp max-scan, (votes << 16 | 0xffff - i) packed, then
    top_k warp arg-max passes.  Returns the row's top_k keys (None where
    empty)."""
    h = len(keys)
    L = next(x for x in (1, 2, 4, 8) if h <= LANES * x)
    pad = np.iinfo(np.uint64 if tile is not None else np.uint32).max
    v = np.full(LANES * L, pad, np.uint64)
    v[:h] = keys
    v = warp_sort(v.reshape(LANES, L))
    i = np.arange(LANES * L).reshape(LANES, L)
    flat = v.reshape(-1)
    new_run = np.ones(LANES * L, bool)
    new_run[1:] = flat[1:] != flat[:-1]
    local = np.maximum.accumulate(np.where(new_run, np.arange(LANES * L), -1)
                                  .reshape(LANES, L), axis=1)
    scan = warp_scan(local[:, -1], np.maximum)
    carry = np.concatenate([[-1], scan[:-1]])
    start = np.maximum(local, carry[:, None])
    end = np.zeros(LANES * L, bool)
    end[:h - 1] = flat[1:h] != flat[:h - 1]
    end[h - 1] = True
    end = end.reshape(LANES, L)
    votes = i - start + 1
    packed = np.where(end & (primary(v, tile) != BIG),
                      (votes.astype(np.int64) << 16) | (0xFFFF - i), 0)
    out, prev = [None] * top_k, 0xFFFFFFFF
    for j in range(top_k):
        lane_best = np.where(packed < prev, packed, 0).max(axis=1)
        best = int(warp_scan(lane_best, np.maximum)[-1])
        if best == 0:
            break
        x = 0xFFFF - (best & 0xFFFF)
        out[j] = v[x // L, x % L]
        prev = best
    return out


def _stage(key, size, half, lo=0, hi=None):
    """One stage of the rows kernel's network on key[lo:hi]: thread i
    compares places a = lo + 2i - (i & (half - 1)) and a + half, ascending
    where a & size == 0 (a's place in the whole row)."""
    hi = len(key) if hi is None else hi
    i = np.arange((hi - lo) // 2)
    a = lo + 2 * i - (i & (half - 1))
    b = a + half
    x, y = key[a], key[b]
    swap = (x > y) == ((a & size) == 0)
    key[a[swap]], key[b[swap]] = y[swap], x[swap]


def block_sort(keys, C=None):
    """The rows kernel's bitonic sort of a power-of-two row: every stage in
    place (C None), or with chunks of C keys: sizes up to C chunk by chunk,
    then for each larger size the strides from C up in place and the rest
    chunk by chunk."""
    key = keys.copy()
    n = len(key)

    def chunks(sizes):
        # a stride below C pairs keys of one chunk: the kernel's chunks in
        # turn do what each stage does to all chunks at once
        for size in sizes:
            half = min(size, C) // 2
            while half:
                for b in range(0, n, C):
                    _stage(key, size, half, b, b + C)
                half //= 2

    if C is None:
        size = 2
        while size <= n:
            half = size // 2
            while half:
                _stage(key, size, half)
                half //= 2
            size *= 2
        return key
    chunks([1 << e for e in range(1, C.bit_length())])
    size = 2 * C
    while size <= n:
        half = size // 2
        while half >= C:
            _stage(key, size, half)
            half //= 2
        chunks([size])
        size *= 2
    return key


def rows_vote(row, index, offsets, k, kb, stride, H, top_k, tile, p, rng):
    """The rows kernel on one row: k-mer ranges, the slots' prefix, a slot
    a thread with its k-mer by binary search, the valid keys compacted (in
    the order atomics give them: any; here a random one), the bitonic sort
    over the power of two at or above h (in shared memory, or in global
    scratch in place or in chunks of the shared room), run starts by a
    thread's chunk and a block max-scan, top-k passes over (votes << 32 |
    ~i).  Returns (keys, where the sort ran: "shared", "global" or
    "chunked")."""
    table, keys_sorted, pos = index
    Q = len(offsets)
    kv, lo, hi = kmer_ranges(row, k, kb, stride, Q, table)
    cnt = np.clip(hi - lo, 0, H)
    qpre = np.concatenate([[0], np.cumsum(cnt)])
    S = int(qpre[-1])
    P = 2
    while P < S:
        P *= 2
    room = p["block_smem"] - (p["kmer_bytes"] if p["kmer_shared"] else 0)
    area = "shared" if 12 * P <= room else "global"
    e = np.arange(S)
    q = np.searchsorted(qpre[:Q], e, side="right") - 1
    idx = np.clip(lo[q] + e - qpre[q], 0, len(pos) - 1)
    ok = (keys_sorted[idx] == kv[q]) if kb < k else np.ones(S, bool)
    keys = hit_keys(pos[idx], offsets[q], tile)[ok]
    if kb < k:
        keys = keys[rng.permutation(len(keys))]
    h = len(keys)
    if h == 0:
        return [None] * top_k, area
    P2 = 2
    while P2 < h:
        P2 *= 2
    C = 1
    if area == "global":
        while C < P2 and 16 * C <= room:
            C *= 2
        if C >= 2:
            area = "chunked"
    key = block_sort(np.concatenate(
        [keys, np.full(P2 - h, np.iinfo(np.uint64).max, np.uint64)]),
        C if C >= 2 else None)[:h]
    # a thread's chunk of keys, its last new-run index, the block max-scan
    per = -(-h // svc.ROW_THREADS)
    new_run = np.append(True, key[1:] != key[:-1])
    last = np.full(svc.ROW_THREADS, -1)
    for t in range(svc.ROW_THREADS):
        runs = np.flatnonzero(new_run[t * per:(t + 1) * per])
        if len(runs):
            last[t] = t * per + runs[-1]
    carry = np.concatenate([[-1], np.maximum.accumulate(last)[:-1]])
    start = np.maximum.accumulate(np.where(new_run, np.arange(h), -1))
    start = np.maximum(start, np.repeat(carry, per)[:h])
    end = np.append(key[1:] != key[:-1], True) & (primary(key, tile) != BIG)
    votes = np.where(end, np.arange(h) - start + 1, 0)
    packed = (votes.astype(np.uint64) << U64(32)) | (
        ~np.arange(h, dtype=np.uint64) & U64(0xFFFFFFFF))
    out, prev = [None] * top_k, np.iinfo(np.uint64).max
    for j in range(top_k):
        cand = packed[(votes > 0) & (packed < prev)]
        if not len(cand):
            break
        best = cand.max()
        out[j] = key[int(~np.uint32(best & U64(0xFFFFFFFF)))]
        prev = best
    return out, area


def emulate_kernel(flat, table, keys_sorted, pos, offsets, k, kb, stride, H,
                   top_k, tile=None, seed=0):
    """csrc/seed_vote.cu's two kernels, row by row in numpy with the
    wrapper's plan (ops/seed_vote_cuda.py: WARP_HITS, SMEM_BYTES): the
    warp kernel's k-mers (kq a lane), the warp prefix sum of the in-range
    slots, the spill test, the slot list, the gathers (slot t * 32 + lane),
    the ballot compaction and warp_vote; the rows kernel on spilled rows.
    Returns (outputs as seed_vote_plain's, the rows each route took: the
    warp kernel, the warp kernel without a slot, the rows kernel in shared
    memory, in global scratch, or in global scratch by chunks)."""
    flat = flat.numpy()
    N, R = flat.shape
    Q = len(offsets)
    p = svc.plan(N, Q, H, R)
    index = (np.asarray(table), np.asarray(keys_sorted), np.asarray(pos))
    rng = np.random.default_rng(seed)
    routes = {"warp": [], "empty": [], "shared": [], "global": [],
              "chunked": []}
    outs = []
    for r in range(N):
        got = None
        if p["warp"]:
            kq = -(-Q // LANES)
            kv, lo, hi = kmer_ranges(flat[r], k, kb, stride, Q, table)
            cnt = np.clip(hi - lo, 0, H)
            lanes = np.zeros(LANES, np.int64)
            np.add.at(lanes, np.arange(Q) // kq, cnt)
            incl = warp_scan(lanes, np.add)
            S = int(incl[-1])
            if S <= p["warp_hits"]:
                # the slot list: lane by lane at its prefix, k-mer by k-mer
                q = np.repeat(np.arange(Q), cnt)
                assert (np.searchsorted(incl - lanes, np.arange(S),
                                        side="right") - 1
                        == q // kq).all()
                idx = np.clip(lo[q] + np.arange(S)
                              - np.repeat(np.cumsum(cnt) - cnt, cnt), 0,
                              len(pos) - 1)
                ok = (index[1][idx] == kv[q]) if kb < k else np.ones(S, bool)
                key = hit_keys(index[2][idx], offsets[q], tile)
                # ballots, t by t: slot t * 32 + lane
                comp = []
                for t in range(-(-S // LANES)):
                    s = np.arange(t * LANES, min(S, (t + 1) * LANES))
                    comp.extend(key[s[ok[s]]])
                got = (warp_vote(np.array(comp, np.uint64), tile, top_k)
                       if comp else [None] * top_k)
                routes["warp" if S else "empty"].append(r)
        if got is None:
            got, area = rows_vote(flat[r], index, offsets, k, kb, stride, H,
                                  top_k, tile, p, rng)
            routes[area].append(r)
        outs.append(got)
    out0 = np.zeros((N, top_k), np.int64)
    out1 = np.zeros((N, top_k), np.int64)
    for r, got in enumerate(outs):
        for j, key in enumerate(got):
            if key is None:
                out0[r, j] = tile[2] if tile is not None else sv.EMPTY_DIAG
                out1[r, j] = 0
            elif tile is not None:
                out0[r, j] = np.clip(primary(key, tile), 0, tile[2] - 1)
                out1[r, j] = _unflip(np.uint64(key) & U64(0xFFFFFFFF))
            else:
                out0[r, j] = _unflip(key)
    return (out0 if tile is None else (out0, out1)), routes


# The wrapper's knobs that force each route: the warp kernel (as planned),
# every row with a slot listed for the rows kernel, every listed row's sort
# in global scratch with blocks walking rows (in place, or in chunks of a
# small shared room), and a low warp capacity that splits a launch between
# the two kernels.
ROUTES = {
    "warp": {},
    "rows": {"WARP_HITS": 0},
    "global": {"WARP_HITS": 0, "SMEM_BYTES": 0, "BLOCK_GRID": 5},
    "chunked": {"WARP_HITS": 0, "SMEM_BYTES": 512, "BLOCK_GRID": 7},
    "mixed": {"WARP_HITS": 16},
}


def _force(monkeypatch, route):
    for name, value in ROUTES[route].items():
        monkeypatch.setattr(svc, name, value)


def _route_reached(route, routes):
    if route == "warp":
        assert routes["warp"]
    elif route == "rows":
        assert routes["shared"] and not routes["warp"]
    elif route == "global":
        assert routes["global"] and not (routes["warp"] + routes["shared"]
                                         + routes["chunked"])
    elif route == "chunked":
        assert routes["chunked"] and not routes["warp"] + routes["global"]
    else:
        assert routes["warp"] and routes["shared"] + routes["global"]


# Each emulated case on each route; rows of more than 128 k-mers (wide-row)
# take the rows kernel whatever the warp's capacity, so on two routes.
EMULATED = [(c, r) for c in (CASES[1], CASES[5], CASES[8]) for r in ROUTES]
EMULATED += [(CASES[9], r) for r in ("rows", "global", "chunked")]


@pytest.mark.parametrize("case,route", EMULATED,
                         ids=[f"{c[0]}-{r}" for c, r in EMULATED])
def test_kernel_steps_emulated_in_numpy(monkeypatch, case, route):
    name, k, prefix, stride, H, top_k, R, n, special = case
    _force(monkeypatch, route)
    flat, index, offs, kb = case_inputs(case)
    flat = flat[:16]
    args = port_args(flat, index, offs, k, kb, stride, H, top_k)
    want = sv.seed_vote_plain(*args)
    table, kv, pos = index
    got, routes = emulate_kernel(flat, table, kv, pos, offs, k, kb, stride,
                                 H, top_k)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(
        got, jax_seed_diag(flat, index, offs, k, kb, stride, H, top_k))
    if name == "wide-row":
        assert not routes["warp"] + routes["empty"]
        if route == "global":
            assert routes["global"] and not routes["shared"]
        else:
            assert routes["chunked"] and not routes["global"]
    else:
        _route_reached(route, routes)


@pytest.mark.parametrize("route", list(ROUTES))
def test_kernel_steps_emulated_in_numpy_tile_mode(monkeypatch, xl, route):
    _force(monkeypatch, route)
    case = TILE_CASES[2]
    name, k, _, stride, H, top_k, R, n, _ = case
    _, table, pos_div, _, T = xl
    reads, offs = tile_case(xl, case)
    reads = reads[:10]
    flat, _ = both_strands(torch.from_numpy(reads))
    tile = (TILE_C // INDEX_STRIDE, INDEX_STRIDE, T)
    t = torch.from_numpy
    want = sv.seed_vote_plain(flat, t(table), t(table[:1]), t(pos_div),
                              t(offs), k, k, stride, H, top_k, tile=tile)
    got, routes = emulate_kernel(flat, table, table[:1], pos_div, offs, k, k,
                                 stride, H, top_k, tile=tile)
    jax_want = jax_seed_tile(xl, reads, offs, k, stride, H, top_k)
    for g, w, j in zip(got, want, jax_want):
        np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(g, j)
    _route_reached(route, routes)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_warp_network_sorts_every_h(dtype):
    """The register/shuffle network at every h from 1 to the warp's 256,
    with repeats and keys equal to the padding."""
    rng = np.random.default_rng(3)
    pad = np.iinfo(dtype).max
    for h in range(1, 257):
        L = next(x for x in (1, 2, 4, 8) if h <= LANES * x)
        keys = rng.integers(0, max(2, h // 3), h).astype(dtype)
        keys[rng.random(h) < 0.05] = pad
        v = np.full(LANES * L, pad, dtype)
        v[:h] = keys
        got = warp_sort(v.reshape(LANES, L)).reshape(-1)
        np.testing.assert_array_equal(got[:h], np.sort(keys))


def test_block_network_sorts_with_padding():
    """The rows kernel's network in place and by chunks of 2 to P keys."""
    rng = np.random.default_rng(3)
    for n in (1, 5, 64, 100, 1000):
        P = max(2, 1 << (n - 1).bit_length())
        keys = rng.integers(0, 50, n).astype(np.uint64)
        padded = np.concatenate([keys, np.full(P - n, np.iinfo(np.uint64).max,
                                               np.uint64)])
        for C in (None, *[1 << e for e in range(1, P.bit_length())]):
            np.testing.assert_array_equal(block_sort(padded, C)[:n],
                                          np.sort(keys))


# Adversarial rows on a hand-made index of a 4-mer genome: a random stretch
# and a 5-base repeat, every k-mer occurrence g listed at base + g for each
# base below — so a read copied from the stretch votes on the diagonals
# base + start with equal counts (ties), one of them exactly 2^30, one
# above it, one below 0 and one near the int32 limit.  Tile mode at C 1
# puts a tile row at 2^30; at C 64 a copy's hits share one (row, col).
ADV_K, ADV_R = 4, 40
ADV_CASES = [  # (id, kb, H, top_k, tile columns C or None for diag mode)
    ("diag-H4", 4, 4, 8, None),
    ("diag-H16-all-valid", 4, 16, 8, None),
    ("prefix-H8", 3, 8, 8, None),
    ("prefix-H16", 3, 16, 8, None),
    ("tile-H4-row-sentinel", 4, 4, 16, 1),
    ("tile-H16-all-valid", 4, 16, 8, 64),
]
ADV_T = 150


def adversarial_inputs(kb: int, C, seed: int = 5):
    """(flat (16, 40) int8, table, keys_sorted, pos, offsets, tile, reads):
    reads all PAD (no valid slot), from the stretch where a base puts the
    diagonal at 2^30, from the repeat (every slot valid), one k-mer and a
    base (fewer runs than top_k), with N codes, and random copies, both
    strands."""
    rng = np.random.default_rng(seed)
    k = ADV_K
    stretch = rng.integers(0, 4, 160).astype(np.int8)
    genome = np.concatenate([stretch, np.tile(np.array([0, 1, 3, 2, 2],
                                                       np.int8), 40)])
    s0 = 37
    bases = ([0, BIG - s0, BIG + 900, -(10 ** 6), 2 ** 31 - 1 - 500]
             if C is None else [0, BIG - s0, 5_000, 2 ** 31 - 1 - 500])
    g = np.arange(len(genome) - k + 1)
    kv = np.zeros(len(g), np.int64)
    for j in range(k):
        kv = kv * 4 + genome[g + j]
    keys = np.repeat(kv, len(bases))
    pos = (np.repeat(g, len(bases))
           + np.tile(np.array(bases, np.int64), len(g)))
    order = np.lexsort((pos, keys))
    keys, pos = keys[order].astype(np.int32), pos[order].astype(np.int32)
    table = np.zeros(4 ** kb + 1, np.int64)
    np.add.at(table, (keys >> (2 * (k - kb))) + 1, 1)
    table = np.cumsum(table).astype(np.int32)
    reads = np.full((8, ADV_R), PAD, np.int8)
    reads[1] = genome[s0:s0 + ADV_R]
    reads[2] = genome[200:200 + ADV_R]
    reads[3, :k + 1] = genome[90:90 + k + 1]
    reads[4] = genome[60:60 + ADV_R]
    reads[4, ::7] = N_CODE
    for i in (5, 6, 7):
        s = int(rng.integers(0, 160 - ADV_R))
        reads[i] = genome[s:s + ADV_R]
    flat, _ = both_strands(torch.from_numpy(reads))
    offs = read_kmer_offsets(ADV_R, k, 1)
    tile = None if C is None else (C, 1, ADV_T)
    return flat, table, keys, pos, offs, tile, reads


@pytest.mark.parametrize("route", ["warp", "rows", "global", "chunked"])
@pytest.mark.parametrize("case", ADV_CASES, ids=[c[0] for c in ADV_CASES])
def test_kernel_steps_adversarial_rows(monkeypatch, case, route):
    name, kb, H, top_k, C = case
    _force(monkeypatch, route)
    flat, table, keys, pos, offs, tile, reads = adversarial_inputs(kb, C)
    t = torch.from_numpy
    args = (flat, t(table), t(keys), t(pos), t(offs), ADV_K, kb, 1, H, top_k)
    want = sv.seed_vote_plain(*args, tile=tile)
    got, routes = emulate_kernel(flat, table, keys, pos, offs, ADV_K, kb, 1,
                                 H, top_k, tile=tile)
    if tile is None:
        jax_want = jax_seed_diag(flat, (table, keys, pos), offs, ADV_K, kb,
                                 1, H, top_k)
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(got, jax_want)
        first = got
    else:
        jax_want = jxl._xl_seed_core(
            jnp.asarray(pack_nibbles(reads)), jnp.asarray(table),
            jnp.asarray(pos), jnp.asarray(offs), k=ADV_K, kb=ADV_K,
            stride_idx=1, stride_q=1, max_hits=H, top_k=top_k, T=ADV_T, C=C,
            R=ADV_R)
        for g, w, j in zip(got, want, jax_want):
            np.testing.assert_array_equal(g, w.numpy())
            np.testing.assert_array_equal(g, np.asarray(j))
        first = got[0]
    _route_reached(route, routes)
    # no valid slot; fewer runs than top_k
    empty = ADV_T if tile is not None else sv.EMPTY_DIAG
    n_empty = (first == empty).sum(1)
    assert n_empty[0] == top_k and 0 < n_empty[3] < top_k
    if tile is None:
        assert not (first == BIG).any()            # the sentinel scores 0
        assert (first > BIG).any() and (first < 0).any()
    # every slot valid: the repeat row, past the warp's capacity at H 16
    _, lo, hi = kmer_ranges(flat[2].numpy(), ADV_K, kb, 1, len(offs), table)
    if kb == ADV_K:
        assert (hi - lo >= H).all()
    if "all-valid" in name:
        assert 2 in routes["shared"] + routes["global"] + routes["chunked"]


def test_plan_sizes_the_workspace():
    p = svc.plan(16384, 99, 16, 112)        # the XL rescue point
    assert p == {"warp": True, "warp_grid": 2048,
                 "warp_smem": 8 * (112 + 3072), "warp_hits": 256,
                 "slots": 2048, "kmer_bytes": 1200, "kmer_shared": True,
                 "block_smem": 1200 + 12 * 2048, "scratch_ws": 0,
                 "block_grid": 528}
    p = svc.plan(16384, 20, 8, 128)         # the flat engine
    assert (p["warp"], p["slots"], p["scratch_ws"]) == (True, 256, 0)
    p = svc.plan(8, 1017, 32, 1024)         # past the warp and shared memory
    assert not p["warp"] and p["block_grid"] == 8
    assert p["kmer_shared"] and p["block_smem"] == svc.SMEM_BYTES
    assert p["scratch_ws"] == 12 * 32768 > svc.SMEM_BYTES
    p = svc.plan(3, 20, 8, 4096)            # rows wider than the warp stages
    assert not p["warp"] and p["warp_grid"] == 0 and p["block_grid"] == 3


# ---------------------------------------------------- wrapper checks


def test_wrapper_checks_raise():
    case = CASES[1]
    name, k, prefix, stride, H, top_k, R, n, special = case
    flat, index, offs, kb = case_inputs(case)
    args = list(port_args(flat, index, offs, k, kb, stride, H, top_k))
    with pytest.raises(ValueError, match="CUDA tensor"):
        svc.seed_vote_cuda(*args)
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(TypeError):
        svc.seed_vote_cuda(*bad)
    bad = list(args)
    bad[4] = bad[4][:-1]
    with pytest.raises(ValueError, match="offsets"):
        svc.seed_vote(*bad)
    bad = list(args)
    bad[9] = len(offs) * H + 1
    with pytest.raises(ValueError, match="top_k"):
        svc.seed_vote(*bad)
    bad = list(args)
    bad[0] = bad[0][:, :k - 1]
    with pytest.raises(ValueError, match="below k"):
        svc.seed_vote(*bad)
    flat2, co = both_strands(torch.full((2, 64), PAD, dtype=torch.int8))
    tiles = torch.full((3, 200), PAD, dtype=torch.int8)
    rows = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        anchor_cuda.extend_fold_cuda(flat2, co, tiles, 64, 1, 4, 2,
                                     offs=rows, rows=rows)
    with pytest.raises(TypeError):
        anchor_cuda.extend_fold_cuda(flat2.long(), co, tiles, 64, 1, 4, 2,
                                     offs=rows, rows=rows)
    with pytest.raises(ValueError, match="prepad"):
        anchor_cuda.extend_fold(flat2, co, tiles, 32, 1, 4, 2, offs=rows,
                                rows=rows)


# ---------------------------------------------------- the card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _equal_on_card(args, tile=None):
    want = sv.seed_vote_plain(*[a.cpu() if torch.is_tensor(a) else a
                                for a in args], tile=tile)
    before = svc.launches
    got = svc.seed_vote(*args, tile=tile)
    torch.cuda.synchronize()
    assert svc.launches == before + 1
    if tile is None:
        assert torch.equal(got.cpu(), want)
    else:
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_seed_vote_kernel_matches_plain(monkeypatch, case, route):
    _needs_card()
    name, k, prefix, stride, H, top_k, R, n, special = case
    _force(monkeypatch, route)
    flat, index, offs, kb = case_inputs(case)
    _equal_on_card(port_args(flat, index, offs, k, kb, stride, H, top_k,
                             "cuda"))
    # two rows, and a row count off any block multiple
    for rows in (2, 2 * n - 3):
        _equal_on_card(port_args(flat[:rows], index, offs, k, kb, stride, H,
                                 top_k, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", TILE_CASES, ids=[c[0] for c in TILE_CASES])
def test_seed_vote_kernel_tile_mode_matches_plain(monkeypatch, xl, case,
                                                  route):
    _needs_card()
    name, k, _, stride, H, top_k, R, n, _ = case
    _force(monkeypatch, route)
    _, table, pos_div, _, T = xl
    reads, offs = tile_case(xl, case)
    flat, _ = both_strands(torch.from_numpy(reads).cuda())
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    _equal_on_card((flat, c(table), c(table[:1]), c(pos_div), c(offs), k, k,
                    stride, H, top_k),
                   tile=(TILE_C // INDEX_STRIDE, INDEX_STRIDE, T))


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", ADV_CASES, ids=[c[0] for c in ADV_CASES])
def test_seed_vote_kernel_adversarial_rows(monkeypatch, case, route):
    _needs_card()
    name, kb, H, top_k, C = case
    _force(monkeypatch, route)
    flat, table, keys, pos, offs, tile, _ = adversarial_inputs(kb, C)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    _equal_on_card((flat.cuda(), c(table), c(keys), c(pos), c(offs), ADV_K,
                    kb, 1, H, top_k), tile=tile)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [1, 4, 8])
def test_extend_fold_tile_kernel_matches_plain(xl, top_k):
    _needs_card()
    case = ("tile-extend", 8, False, 1, 8, top_k, 128, 24, None)
    _, _, _, tiles, T = xl
    reads, rc, cc = tile_candidates(xl, case)
    flat, co = both_strands(torch.from_numpy(reads))
    t = torch.from_numpy
    want = anchor.extend_fold_plain(flat, co, t(tiles), TILE_HALO, MATCH,
                                    MISMATCH, top_k, offs=t(cc), rows=t(rc))
    before = anchor_cuda.tile_launches
    got = anchor_cuda.extend_fold(flat.cuda(), co.cuda(), t(tiles).cuda(),
                                  TILE_HALO, MATCH, MISMATCH, top_k,
                                  offs=t(cc).cuda(), rows=t(rc).cuda())
    torch.cuda.synchronize()
    assert anchor_cuda.tile_launches == before + 1
    for f in txl.XL_FIELDS:
        assert torch.equal(got[f].cpu(), want[f]), f
