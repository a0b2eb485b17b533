"""The all-hits programs' kernels — the extension's segments mode and the
seeding's top-k epilogue (csrc/anchor.cu) — through their plain versions,
against the JAX package, exactly.

On the CPU the port's four all-hits device programs run on numpy-seeded
inputs beside the JAX package's: the flat engine's
``_genome_align_multi_core`` and the sharded engine's ``_shard_multi``
(offsets into a prepadded genome, empty vote slots at EMPTY_DIAG, offsets
past both ends, repeated offsets), ``_xl_multi_extend_core`` (tile windows,
empty slots on the all-PAD row T, a negative column, the last tile row) on
nibble-packed reads, and ``_align_multi_core`` (the bfloat16 counts' top k,
then the segments of every candidate) at the candidate sites' shapes —
128-wide anchor tiles and 256-wide queries at stride 3 — and at k 1, 16
and 20 (past the kernel's register lists: the plain version), D below 128, D on and off a multiple of 128, all-PAD and all-N rows, a
tie-heavy reference, a reference of period 128 (equal keys in every
block), and 320-wide reads whose counts pass 256 (the K-chunked seeding,
bfloat16 rounding); every integer output must be equal.  With D < k the
JAX package refuses the top-k and the port keeps the D diagonals the plain
version finds.  ``seed_block_topk_plain`` + ``select_topk_plain`` are held
to ``lax.top_k`` of bfloat16 counts; the kernels' index arithmetic — each
thread's top-k lists over the accumulator layout, the quad's merge by
rounds, the keys past D, and the extension's selection ranks, each lane's
register cache and uncached tail, and the lane butterfly — is emulated in
numpy and held to the plain versions.  On a card (marked ``cuda``) both new modes are held equal
to their plain versions on every addressing (offsets, tiles, keys) and
route (block lists of 8 and 16, the K-chunked variant, stride 2), and no
CUDA tensor reaches the plain chains.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anchored_fusion_tpu.align import aligner as jal
from anchored_fusion_tpu.align import genome as jgen
from anchored_fusion_tpu.align import genome_xl as jxl
from anchored_fusion_tpu.config import AlignConfig as JCfg
from anchored_fusion_tpu.index import kmer as jkm
from anchored_fusion_tpu.io.fasta import reference_from_dict
from anchored_fusion_tpu.ops.encode import pack_nibbles
from anchored_fusion_tpu.parallel import sharded_genome as jsh
from anchored_fusion_tpu_torch.align import aligner as tal
from anchored_fusion_tpu_torch.align import genome as tgen
from anchored_fusion_tpu_torch.align import genome_xl as txl
from anchored_fusion_tpu_torch.config import AlignConfig as TCfg
from anchored_fusion_tpu_torch.io.fasta import Reference as TRef
from anchored_fusion_tpu_torch.ops import anchor, anchor_cuda
from anchored_fusion_tpu_torch.ops.encode import one_hot
from anchored_fusion_tpu_torch.ops.seed_vote import EMPTY_DIAG
from anchored_fusion_tpu_torch.parallel import sharded_genome as tsh

PAD, N_CODE = 5, 4
_RC = np.array([3, 2, 1, 0, 4, 5], np.int8)
MATCH, MISMATCH = 1, 4
MULTI = ("score", "start", "end", "matches", "length", "off")
GENOME_BP = 30_000
REPEAT = (12_000, 14_000)          # a 7-base unit repeated: ties
TILE_C, TILE_HALO, INDEX_STRIDE = 4096, 256, 2
BUCKETS, KC, TILE = (8, 16, 20), 8, 256   # csrc/anchor.cu kStepBuckets, kKC, kTileD
I64_MIN, I64_MAX = -(2 ** 63), 2 ** 63 - 1


def make_genome(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, GENOME_BP).astype(np.int8)
    lo, hi = REPEAT
    codes[lo:hi] = np.tile(rng.integers(0, 4, 7), -(-(hi - lo) // 7))[
        :hi - lo]
    codes[5_000:5_040] = N_CODE
    return codes


def genome_reads(rng, codes, n: int, R: int) -> np.ndarray:
    """(n, R) int8 reads from the genome (a third reverse complemented, 2%
    substitutions, some in the repeat, two hanging off the genome's ends
    as N), one all PAD, one all N, one random."""
    L = len(codes)
    m = min(R, 101)
    reads = np.full((n, R), PAD, np.int8)
    for i in range(n):
        s = (int(rng.integers(REPEAT[0], REPEAT[1] - m)) if i % 4 == 1
             else int(rng.integers(0, L - m)))
        seg = codes[s:s + m].copy()
        err = rng.random(m) < 0.02
        seg[err] = (seg[err] + 1) % 4
        if i % 3 == 2:
            seg = _RC[seg][::-1]
        reads[i, :m] = seg
    reads[0] = PAD
    reads[1, :m] = N_CODE
    reads[2, :m] = rng.integers(0, 4, m)
    reads[3, :m] = np.concatenate([np.full(30, N_CODE, np.int8),
                                   codes[:m - 30]])
    reads[4, :m] = np.concatenate([codes[L - m + 30:],
                                   np.full(30, N_CODE, np.int8)])
    return reads


def stack(seg: dict) -> np.ndarray:
    return np.stack([seg[n].numpy() for n in MULTI])


def assert_segments_equal(got: dict, want: dict):
    for n in want:
        assert got[n].dtype == want[n].dtype == torch.int32, n
        assert torch.equal(got[n].cpu(), want[n].cpu()), n


# ------------------------------------------------ flat and sharded engines

@pytest.fixture(scope="module")
def flat_world():
    codes = make_genome(3)
    seq = "".join("ACGTN"[c] for c in codes)
    j = jgen.GenomeAligner(reference_from_dict({"c": seq}), JCfg())
    jref = reference_from_dict({"c": seq})
    t = tgen.GenomeAligner(TRef(list(jref.names), jref.starts.copy(),
                                jref.lengths.copy(), jref.seq.copy()),
                           TCfg(), device="cpu")
    return codes, j, t


@pytest.mark.parametrize("R,H,top_k", [(128, 8, 8), (160, 16, 4),
                                       (128, 4, 1)])
def test_genome_multi_core_matches_jax(flat_world, R, H, top_k):
    """The flat engine's all-hits program: the seeding kernel's plain
    version, then the segments mode's (extend_diagonals_all) on the
    engine's prepadded genome, against _genome_align_multi_core."""
    codes, j, t = flat_world
    rng = np.random.default_rng(R + H + top_k)
    reads = genome_reads(rng, codes, 40, R)
    offsets = jkm.read_kmer_offsets(R, j.k, j.stride)
    want = np.asarray(jgen._genome_align_multi_core(
        jnp.asarray(pack_nibbles(reads)), j.codes, j.index.table,
        j.index.keys_sorted, j.index.pos_sorted, jnp.asarray(offsets), j.k,
        j.index.kb, j.stride, H, top_k, MATCH, MISMATCH, R, j.ref_prepad))
    flat, _ = tal.both_strands(torch.from_numpy(reads))
    offs = tgen._seed_diagonals(flat, t.index, t._offsets(R), t.stride, H,
                                top_k)
    seg = tal.extend_diagonals_all(flat, t.codes, offs, MATCH, MISMATCH,
                                   t.ref_prepad)
    seg["off"] = offs
    np.testing.assert_array_equal(stack(seg), want)
    # empty slots read all-PAD windows: INVALID's score, start = end = 0
    empty = offs == EMPTY_DIAG
    assert empty[0].all() and (seg["score"][empty] == -1000).all()
    assert (seg["start"][empty] == 0).all() and (seg["length"][empty] == 1).all()
    assert (seg["score"] > 50).sum() > 20


@pytest.fixture(scope="module")
def shard_world():
    codes = make_genome(4)
    seq = "".join("ACGTN"[c] for c in codes)
    jref = reference_from_dict({"c": seq})
    j = jsh.ShardedGenomeAligner(jref, n_shards=3, cfg=JCfg(),
                                 device_build=False)
    t = tsh.ShardedGenomeAligner(
        TRef(list(jref.names), jref.starts.copy(), jref.lengths.copy(),
             jref.seq.copy()), n_shards=3, cfg=TCfg(), device_build=False,
        device="cpu")
    return codes, j, t


@pytest.mark.parametrize("top_k", [8, 3])
def test_shard_multi_matches_jax(shard_world, top_k):
    """One shard's all-hits program, every shard: empty slots keep the
    far-negative sentinel offset and read all-PAD windows."""
    codes, j, t = shard_world
    R, H = 128, 8
    reads = genome_reads(np.random.default_rng(top_k), codes, 64, R)
    offsets = jkm.read_kmer_offsets(R, j.k, j.stride)
    for s in range(3):
        want = np.asarray(jsh._shard_multi_one(
            jnp.asarray(reads), jnp.asarray(offsets), j.tbl[s], j.keys[s],
            j.pos[s], j.seq[s], k=j.k, kb=j.kb, stride=j.stride,
            max_hits=H, top_k=top_k, match=MATCH, mismatch=MISMATCH))
        seg = tsh._shard_multi(torch.from_numpy(reads), t._offsets(R),
                               t.shards[s], **t._kw(top_k, H))
        np.testing.assert_array_equal(stack(seg), want)
        assert (seg["off"] == EMPTY_DIAG).any()


# ------------------------------------------------------------- XL tiles

@pytest.fixture(scope="module")
def xl():
    codes = make_genome(1)
    table, pos_div = jxl.build_index_xl(codes, 8, INDEX_STRIDE)
    tiles = np.array(jxl.build_tiles_host(codes, TILE_C, TILE_HALO))
    return codes, np.array(table), np.array(pos_div), tiles, len(tiles) - 1


def xl_candidates(xl, top_k: int, R: int = 128):
    """Voted (rows, cols) of reads from the genome, then edited: every 5th
    row's last slot empty (row T), a negative column that reads into the
    halo, a candidate on the last tile row, a repeated candidate."""
    codes, table, pos_div, _, T = xl
    rng = np.random.default_rng(zlib.crc32(b"xl-multi") + top_k)
    reads = genome_reads(rng, codes, 24, R)
    for i, at in zip((5, 6), (TILE_C - 50, 3 * TILE_C - 30)):
        reads[i] = PAD
        reads[i, :101] = codes[at:at + 101]
    offs = jkm.read_kmer_offsets(R, 8, 1)
    rc, cc = jxl._xl_seed_core(
        jnp.asarray(pack_nibbles(reads)), jnp.asarray(table),
        jnp.asarray(pos_div), jnp.asarray(offs), k=8, kb=8,
        stride_idx=INDEX_STRIDE, stride_q=1, max_hits=8, top_k=top_k, T=T,
        C=TILE_C, R=R)
    rc, cc = np.array(rc), np.array(cc)
    rc[::5, -1], cc[::5, -1] = T, 0
    rc[7, 0], cc[7, 0] = 1, -(TILE_HALO // 2)
    rc[8, -1], cc[8, -1] = T - 1, TILE_C - 60
    rc[9, -1], cc[9, -1] = rc[9, 0], cc[9, 0]
    return reads, rc, cc


@pytest.mark.parametrize("top_k", [1, 4, 8])
def test_xl_multi_extend_core_matches_jax(xl, top_k):
    _, _, _, tiles, T = xl
    reads, rc, cc = xl_candidates(xl, top_k)
    want = np.asarray(jxl._xl_multi_extend_core(
        jnp.asarray(pack_nibbles(reads)), jnp.asarray(tiles),
        jnp.asarray(rc), jnp.asarray(cc), MATCH, MISMATCH, TILE_HALO,
        reads.shape[1]))
    t = torch.from_numpy
    got = txl._xl_multi_extend_core(t(reads), t(tiles), t(rc), t(cc), MATCH,
                                    MISMATCH, TILE_HALO)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0][rc == T] == -1000).all()
    assert (want[0] > 50).sum() > 10


# ------------------------------------------- the candidate sites' program

# (id, reference length, row width R, read length, stride, k, kind)
CASES = [
    ("anchor-tiles-R128-s3", 3000, 128, 128, 3, 8, "mixed"),
    ("queries-R256-s3", 3000, 256, 200, 3, 8, "mixed"),
    ("R128-k8", 1500, 128, 101, 1, 8, "mixed"),
    ("k1", 1500, 128, 101, 1, 1, "mixed"),
    ("k16", 1500, 128, 101, 1, 16, "mixed"),
    ("k20", 1500, 128, 101, 1, 20, "mixed"),
    ("stride2", 1500, 128, 101, 2, 8, "mixed"),
    ("D<128", 60, 64, 50, 1, 8, "mixed"),
    ("D%128==0", 897, 128, 101, 1, 8, "mixed"),
    ("D-off-128", 1000, 128, 101, 1, 8, "mixed"),
    ("ties", 1500, 128, 101, 1, 8, "ties"),
    ("period128", 1500, 128, 101, 1, 8, "period128"),
    ("R320-bf16", 2000, 320, 320, 1, 8, "mixed"),
]


def make_reference(rng, L: int, kind: str) -> np.ndarray:
    if kind == "ties":
        unit = rng.integers(0, 4, 12).astype(np.int8)
        ref = np.tile(unit, -(-L // 12))[:L].copy()
        ref[rng.integers(0, L, L // 100)] = rng.integers(0, 4, L // 100)
        return ref
    if kind == "period128":
        # diagonals 128 apart match alike: equal keys at one lane of every
        # block, so the key alone cannot order the blocks
        return np.tile(rng.integers(0, 4, 128).astype(np.int8),
                       -(-L // 128))[:L].copy()
    ref = rng.integers(0, 4, L).astype(np.int8)
    ref[rng.integers(0, L, 3)] = N_CODE
    return ref


def make_reads(rng, ref: np.ndarray, B: int, R: int, read_len: int):
    """Reads copied from the reference on both strands (clipped by its ends
    as N, with SNPs), junk reads, one all-PAD row and one all-N row."""
    L = len(ref)
    out = np.full((B, R), PAD, np.int8)
    for b in range(B):
        n = min(read_len, L)
        s = int(rng.integers(-n // 3, L - 2 * n // 3))
        seq = np.full(n, N_CODE, np.int8)
        lo, hi = max(s, 0), min(s + n, L)
        seq[lo - s:hi - s] = ref[lo:hi]
        if b % 7 == 3:
            seq = rng.integers(0, 4, n).astype(np.int8)
        elif b % 3:
            snp = rng.random(n) < 0.02
            seq[snp] = (seq[snp] + 1) % 4
        if b % 2:
            seq = _RC[seq][::-1]
        out[b, :n] = seq
    out[0] = PAD
    out[1, :min(read_len, L)] = N_CODE
    return out


def case_inputs(case, device="cpu"):
    name, L, R, read_len, stride, k, kind = case
    rng = np.random.default_rng(sum(map(ord, name)))
    ref = make_reference(rng, L, kind)
    reads = make_reads(rng, ref, 48, R, read_len)
    seed, refp = tal._seed_matrix_cached(ref, R, stride, torch.device(device))
    return ref, reads, seed, refp, stride, k


def old_chain(reads, seed, refp, k, stride):
    """_align_multi_core as the port ran it before the kernels: the float32
    product over every diagonal, the full-row stable sort, then the
    segments of the chosen offsets."""
    R = reads.shape[1]
    flat, _ = tal.both_strands(reads)
    counts = anchor.diag_match_counts_w(flat, seed.f32, stride=stride)
    _, idx = tal.stable_topk(counts.to(torch.bfloat16).float(), k)
    offs = idx.to(torch.int32) - (R - 1)
    seg = anchor.offset_segments(flat, refp, offs, R, MATCH, MISMATCH)
    seg["off"] = offs
    return seg


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_align_multi_core_matches_jax(case):
    ref, reads, seed, refp, stride, k = case_inputs(case)
    R = reads.shape[1]
    got = tal._align_multi_core(torch.from_numpy(reads), seed, refp, k,
                                MATCH, MISMATCH, stride)
    jW, jW2 = jal._seed_matrix_cached(ref, R, stride)
    want = np.asarray(jal._align_multi_core(
        jnp.asarray(reads), jnp.asarray(ref), jW, jW2, k, MATCH, MISMATCH,
        stride))
    np.testing.assert_array_equal(stack(got), want)
    assert_segments_equal(got, old_chain(torch.from_numpy(reads), seed,
                                         refp, k, stride))
    # the keys the selection reads, and the edges the cases are named for
    keys = anchor_cuda.seed_block_topk(
        tal.both_strands(torch.from_numpy(reads))[0], seed, stride, k)
    D = seed.diagonals
    assert keys.shape == (2 * len(reads), -(-D // 128), k)
    if D % 128 and D % 128 < k:
        assert (keys[:, -1, D % 128:] == -1).all()
    if case[0] == "R320-bf16":
        assert ((keys >> 8) > 256).any()
    if case[-1] == "period128":
        sel = anchor.select_topk_plain(keys, k, D)
        assert (sel % 128 == sel[:, :1] % 128).all(dim=1).any()
    assert (want[0] > min(40, case[3] // 2)).sum() > 10


def test_align_multi_core_fewer_diagonals_than_k():
    """D = 6 < k = 8: lax.top_k refuses; the port's plain version and its
    kernels' path (the same selection) keep the 6 diagonals."""
    case = ("D<k", 3, 4, 4, 1, 8, "mixed")
    ref, reads, seed, refp, stride, k = case_inputs(case)
    assert seed.diagonals == 6
    got = tal._align_multi_core(torch.from_numpy(reads), seed, refp, k,
                                MATCH, MISMATCH, stride)
    assert got["score"].shape == (2 * len(reads), 6)
    assert_segments_equal(got, old_chain(torch.from_numpy(reads), seed,
                                         refp, k, stride))
    jW, jW2 = jal._seed_matrix_cached(ref, 4, 1)
    with pytest.raises(ValueError, match="top_k"):
        jal._align_multi_core(jnp.asarray(reads), jnp.asarray(ref), jW, jW2,
                              k, MATCH, MISMATCH, 1)


@pytest.mark.parametrize("D,k", [(6925, 8), (1000, 1), (130, 8), (100, 8),
                                 (257, 16), (40_000, 8)])
def test_block_topk_merge_equals_lax_top_k(D, k):
    """Per-block top-k keys merged in (count descending, diagonal
    ascending) order are lax.top_k of the bfloat16 counts, lower index
    first on ties; counts past 256 round to even."""
    rng = np.random.default_rng(D + k)
    counts = rng.integers(0, 6, (16, D)).astype(np.float32)
    counts[::3, :D // 2] = 3
    counts[1::4] = rng.integers(0, 2, (len(counts[1::4]), D))
    counts[2] = rng.integers(250, 270, D)
    keys = anchor.block_topk_keys(torch.from_numpy(counts), k)
    got = anchor.select_topk_plain(keys, k, D).numpy()
    _, want = jax.lax.top_k(jnp.asarray(counts).astype(jnp.bfloat16), k)
    np.testing.assert_array_equal(got, np.asarray(want))
    _, idx = tal.stable_topk(torch.from_numpy(counts).to(torch.bfloat16)
                             .float(), k)
    np.testing.assert_array_equal(got, idx.numpy())


# ------------------------------------ the kernels' arithmetic, in numpy

def bf16_round(c: np.ndarray) -> np.ndarray:
    u = c.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.int64)


def seed_plan(R: int, stride: int, Rs: int) -> tuple:
    """(SN, the read's k-steps, chunked) of csrc/anchor.cu seed_plan."""
    SN = 2 if stride % 2 == 0 else 1
    KSR = -(-Rs * (stride // SN) // 8)
    return SN, KSR > BUCKETS[-1]


def emulate_topk_epilogue(flat, seed, stride: int, kout: int) -> np.ndarray:
    """The seeding kernel's top-k epilogue on the host: each thread t4 of a
    row's quad inserts the keys of its accumulator columns, stream by
    stream, into a TK-entry list per block (compare-swap, as fold_topk);
    the quad then pops kout maxima (store_topk), keys past D as -1."""
    M, R = flat.shape
    D = seed.diagonals
    nb = -(-D // 128)
    SN, chunked = seed_plan(R, stride, seed.positions)
    S = 4 * SN
    TK = 8 if kout <= 8 else 16
    exact = (one_hot(flat[:, ::stride], torch.float64).reshape(M, -1)
             @ seed.f32.double()).numpy().astype(np.int64)
    cnt = np.zeros((M, -(-D // TILE) * TILE), np.int64)
    cnt[:, :D] = bf16_round(exact) if chunked else exact
    out = np.full((M, nb, kout), -7, np.int64)
    for t in range(-(-D // TILE)):
        lists = np.full((M, 4, 2, TK), I64_MIN, np.int64)
        for rho in range(S):
            # a thread's registers of one of its two rows (h = 0; h = 1 is
            # the row 8 below, the same columns)
            for i in (i for i in range(32 // SN) if not (i >> 1) & 1):
                j, e = i >> 2, i & 1
                blk = j // (4 // SN)
                for t4 in range(4):
                    a = 8 * j + 2 * t4 + e
                    d = t * TILE + rho + S * a
                    key = cnt[:, d] * 256 + 255 - (d - (2 * t + blk) * 128)
                    for x in range(TK):
                        hi = np.maximum(key, lists[:, t4, blk, x])
                        key = np.minimum(key, lists[:, t4, blk, x])
                        lists[:, t4, blk, x] = hi
        for b in range(2):
            if 2 * t + b >= nb:
                continue
            head = lists[:, :, b, :].copy()          # (M, 4, TK)
            for r in range(kout):
                m = head[:, :, 0].max(axis=1)
                pop = head[:, :, 0] == m[:, None]
                assert (pop.sum(axis=1) == 1).all()  # distinct lanes
                head = np.where(pop[:, :, None], np.concatenate(
                    [head[:, :, 1:], np.full((M, 4, 1), I64_MIN)], axis=2),
                    head)
                diag = (2 * t + b) * 128 + 255 - (m & 255)
                out[:, 2 * t + b, r] = np.where(diag < D, m, -1)
    return out


def select_rank(q: int, x: int, kt: int) -> int:
    """csrc/anchor.cu select_rank."""
    if kt == 0:
        return x * 2 ** 32 + (2 ** 31 - 1 - q)
    if x < 0:
        return -1 - q
    diag = (q // kt) * 128 + 255 - (x & 255)
    return (x >> 8) * 2 ** 32 + (2 ** 31 - 1 - diag)


def lane_lists(entries: np.ndarray, L: int, kt: int) -> list:
    """Each lane's ranks for the passes, (cached, tail): entries gl, gl + L,
    ..., the first 16 held in registers, the rest read again every pass."""
    ne, out = len(entries), []
    for gl in range(L):
        nc = max(0, min(16, (ne - gl + L - 1) // L))
        cached = [select_rank(gl + L * i, int(entries[gl + L * i]), kt)
                  for i in range(nc)]
        tail = [select_rank(q, int(entries[q]), kt)
                for q in range(gl + 16 * L, ne, L)]
        out.append((cached, tail))
    return out


def lane_select(entries: np.ndarray, k: int, kt: int, R: int) -> list:
    """The extension kernel's selection of one row by its L lanes (the
    power of two at or above k, at most 16): k passes of the largest rank
    below the last over each lane's cache and tail (lane_lists), a
    butterfly over the lanes; keys mode's offsets diagonal - (R - 1)."""
    L = min(16, 1 << max(k - 1, 0).bit_length())
    lists = lane_lists(entries, L, kt)
    ps, out = I64_MAX, []
    for _ in range(k):
        cs = []
        for cached, tail in lists:
            c = I64_MIN
            for x in cached + tail:
                c = x if ps > x > c else c
            cs.append(c)
        o = 1
        while o < L:
            cs = [max(cs[g], cs[g ^ o]) for g in range(L)]
            o <<= 1
        assert len(set(cs)) == 1
        ps = cs[0]
        lo = 2 ** 31 - 1 - (ps & 0x7FFFFFFF)
        out.append(lo - (R - 1) if kt else lo)
    return out


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in (
    "anchor-tiles-R128-s3", "k1", "k16", "stride2", "D<128", "D%128==0",
    "period128", "R320-bf16")], ids=lambda c: c[0])
def test_topk_epilogue_and_selection_emulated(case):
    ref, reads, seed, refp, stride, k = case_inputs(case)
    R = reads.shape[1]
    flat, _ = tal.both_strands(torch.from_numpy(reads))
    flat = flat[::3].contiguous()
    keys = anchor.seed_block_topk_plain(flat, seed.f32, stride, k)
    np.testing.assert_array_equal(emulate_topk_epilogue(flat, seed, stride,
                                                        k), keys.numpy())
    D = seed.diagonals
    want = anchor.select_topk_plain(keys, k, D).numpy() - (R - 1)
    kk = min(k, D)
    got = [lane_select(keys[r].reshape(-1).numpy(), kk, k, R)
           for r in range(0, len(flat), 4)]
    np.testing.assert_array_equal(np.array(got), want[::4])


def test_selection_tail_and_block_mode_ranks():
    """Rows of ~2,500 keys (hundreds a lane, all but 16 of them in the
    uncached tail) and block mode's ranks (x descending, block ascending;
    past 16 a lane, the same tail loop) under the same int64 selection."""
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 4, (3, 40_000)).astype(np.float32)
    for k in (8, 3):
        keys = anchor.block_topk_keys(torch.from_numpy(counts), k)
        assert keys.shape[1] * k > 16 * 8
        want = anchor.select_topk_plain(keys, k, 40_000).numpy()
        got = [lane_select(keys[r].reshape(-1).numpy(), k, k, 1)
               for r in range(3)]
        np.testing.assert_array_equal(np.array(got), want)
    bmax, lane = anchor.block_max_plain(torch.from_numpy(counts))
    idx = anchor.block_topk_plain(bmax, lane, 4, 40_000)
    for r in range(3):
        blocks = lane_select(bmax[r].numpy(), 4, 0, 1)
        np.testing.assert_array_equal(
            np.array(blocks) * 128 + lane[r, blocks].numpy(), idx[r].numpy())


# ------------------------------------------------------------ the wrappers

def test_wrappers_run_plain_on_cpu_and_check_inputs():
    ref, reads, seed, refp, stride, k = case_inputs(CASES[2])
    R = reads.shape[1]
    flat, _ = tal.both_strands(torch.from_numpy(reads))
    before = (anchor_cuda.topk_launches, anchor_cuda.segment_launches)
    keys = anchor_cuda.seed_block_topk(flat, seed, stride, k)
    seg = anchor_cuda.extend_segments(flat, refp, R, MATCH, MISMATCH,
                                      keys=keys, D=seed.diagonals, k=k)
    # past the kernel's 16 keys a block, the plain version on the CPU; a
    # block holds 128 keys
    many = anchor_cuda.seed_block_topk(flat, seed, stride, 200)
    assert many.shape == (len(flat), keys.shape[1], 128)
    assert torch.equal(many[..., :k], keys)
    offs = seg["off"].contiguous()
    again = anchor_cuda.extend_segments(flat, refp, R, MATCH, MISMATCH,
                                        offs=offs)
    assert (anchor_cuda.topk_launches, anchor_cuda.segment_launches) == before
    assert set(seg) == set(MULTI) and set(again) == set(MULTI[:5])
    for n in again:
        assert torch.equal(again[n], seg[n]), n
    with pytest.raises(ValueError, match="CUDA"):
        anchor_cuda.seed_block_topk_cuda(flat, seed, stride, k)
    with pytest.raises(ValueError, match="CUDA"):
        anchor_cuda.extend_segments_cuda(flat, refp, R, MATCH, MISMATCH,
                                         offs=offs)
    with pytest.raises(ValueError, match="1..16"):
        anchor_cuda.seed_block_topk_cuda(flat, seed, stride, 17)
    with pytest.raises(ValueError, match="below 1"):
        anchor_cuda.seed_block_topk(flat, seed, stride, 0)
    with pytest.raises(ValueError, match="prepad"):
        anchor_cuda.extend_segments(flat, refp, R - 1, MATCH, MISMATCH,
                                    offs=offs)


# -------------------------------------------------------------- the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("the anchored kernels run only on a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_topk_and_keys_segments_on_cuda(case):
    """The seeding's top-k epilogue and the segments mode's keys source
    against their plain versions on the same tensors, and the whole
    program against the CPU's."""
    dev = _cuda()
    ref, reads, seed, refp, stride, k = case_inputs(case, "cuda")
    R = reads.shape[1]
    flat, _ = tal.both_strands(torch.from_numpy(reads).to(dev))
    if k > anchor_cuda.MAX_TOPK:
        # the kernel's register lists refuse it; the CPU runs it
        with pytest.raises(ValueError, match="1..16"):
            tal._align_multi_core(torch.from_numpy(reads).to(dev), seed,
                                  refp, k, MATCH, MISMATCH, stride)
        return
    keys = anchor_cuda.seed_block_topk_cuda(flat, seed, stride, k)
    torch.cuda.synchronize()
    assert torch.equal(keys, anchor.seed_block_topk_plain(flat, seed.f32,
                                                          stride, k))
    args = (flat, refp, R, MATCH, MISMATCH)
    kw = dict(keys=keys, D=seed.diagonals, k=k)
    got = anchor_cuda.extend_segments_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert_segments_equal(got, anchor.extend_segments_plain(*args, **kw))
    _, _, cseed, crefp, _, _ = case_inputs(case)
    cpu = tal._align_multi_core(torch.from_numpy(reads), cseed, crefp, k,
                                MATCH, MISMATCH, stride)
    on = tal._align_multi_core(torch.from_numpy(reads).to(dev), seed, refp,
                               k, MATCH, MISMATCH, stride)
    assert_segments_equal(on, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [1, 4, 8, 40])
def test_offsets_segments_on_cuda(flat_world, top_k):
    """Offsets addressing on the flat engine's prepadded genome: voted
    offsets with EMPTY_DIAG slots, offsets past both ends, repeats."""
    dev = _cuda()
    codes, _, t = flat_world
    R = 128
    reads = genome_reads(np.random.default_rng(top_k), codes, 300, R)
    flat, _ = tal.both_strands(torch.from_numpy(reads).to(dev))
    rng = np.random.default_rng(top_k + 1)
    offs = rng.integers(-R - 30, GENOME_BP + 30, (flat.shape[0], top_k))
    offs[::5, -1] = EMPTY_DIAG
    offs[::3, 0] = offs[::3, -1]
    offs = torch.from_numpy(offs.astype(np.int32)).to(dev)
    codes_d = t.codes.to(dev)
    args = (flat, codes_d, t.ref_prepad, MATCH, MISMATCH)
    got = anchor_cuda.extend_segments_cuda(*args, offs=offs)
    torch.cuda.synchronize()
    assert_segments_equal(got, anchor.extend_segments_plain(*args, offs=offs))


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [1, 4, 8])
def test_tile_segments_on_cuda(xl, top_k):
    dev = _cuda()
    _, _, _, tiles, _ = xl
    reads, rc, cc = xl_candidates(xl, top_k)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    flat, _ = tal.both_strands(t(reads))
    args = (flat, t(tiles), TILE_HALO, MATCH, MISMATCH)
    got = anchor_cuda.extend_segments_cuda(*args, offs=t(cc), rows=t(rc))
    torch.cuda.synchronize()
    assert_segments_equal(got, anchor.extend_segments_plain(
        *args, offs=t(cc), rows=t(rc)))
    on = txl._xl_multi_extend_core(t(reads), t(tiles), t(rc), t(cc), MATCH,
                                   MISMATCH, TILE_HALO)
    cpu = txl._xl_multi_extend_core(*map(torch.from_numpy, (reads, tiles,
                                                            rc, cc)),
                                    MATCH, MISMATCH, TILE_HALO)
    assert torch.equal(on.cpu(), cpu)


@pytest.mark.cuda
def test_no_cuda_tensor_reaches_the_plain_chains(monkeypatch, flat_world,
                                                 shard_world, xl):
    """The four all-hits programs on the card launch the kernels and never
    hand a CUDA tensor to the plain chains (offset_segments, tile_segments,
    the float32 product and the full-row top-k)."""
    dev = _cuda()

    def guard(fn):
        def run(*args, **kw):
            assert not any(isinstance(a, torch.Tensor) and a.is_cuda
                           for a in (*args, *kw.values())), fn.__name__
            return fn(*args, **kw)
        return run

    for mod, name in ((anchor, "offset_segments"), (anchor, "tile_segments"),
                      (anchor, "window_segments"),
                      (anchor, "diag_match_counts_w"), (tal, "stable_topk")):
        monkeypatch.setattr(mod, name, guard(getattr(mod, name)))
    before = (anchor_cuda.topk_launches, anchor_cuda.segment_launches)
    ref, reads, _, _, _, _ = case_inputs(CASES[0])
    hits = tal.align_to_reference_multi(reads, ref, stride=3,
                                        device="cuda")
    want = tal.align_to_reference_multi(reads, ref, stride=3, device="cpu")
    for f in ("score", "q_start", "ref_start", "ref_end"):
        np.testing.assert_array_equal(getattr(hits, f), getattr(want, f))
    codes, _, t = flat_world
    seqs = genome_reads(np.random.default_rng(5), codes, 40, 128)
    on = tgen.GenomeAligner(t.reference, TCfg(), device=dev)
    np.testing.assert_array_equal(on.align_multi(seqs).score,
                                  t.align_multi(seqs).score)
    _, _, ts = shard_world
    sh = tsh.ShardedGenomeAligner(ts.reference, n_shards=3, cfg=TCfg(),
                                  device_build=False, device=dev)
    np.testing.assert_array_equal(sh.align_multi(seqs).score,
                                  ts.align_multi(seqs).score)
    xcodes = xl[0]
    xref = TRef(["c"], np.zeros(1, np.int64),
                np.asarray([len(xcodes)], np.int64), xcodes)
    xcfg = TCfg(genome_kmer=11, index_stride=INDEX_STRIDE)
    multi = [txl.GenomeAlignerXL(xref, cfg=xcfg, tile_c=TILE_C,
                                 halo=TILE_HALO, device=d).align_multi(seqs)
             for d in ("cpu", dev)]
    np.testing.assert_array_equal(multi[1].score, multi[0].score)
    np.testing.assert_array_equal(multi[1].ref_start, multi[0].ref_start)
    after = (anchor_cuda.topk_launches, anchor_cuda.segment_launches)
    assert after[0] > before[0] and after[1] > before[1] + 4
