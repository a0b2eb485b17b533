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
kernel's shared-memory workspace.  The kernel's own steps (sort-key
encoding, bitonic network, run counts by binary search, top-k passes) are
emulated in numpy and held to the plain version.  On a card (marked
``cuda``) both kernels are held equal to their plain versions on every
case, with the global-scratch path forced as well.
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
        p = svc.plan(flat.shape[0], len(offs), H)
        assert not p["shared"] and p["grid"] == flat.shape[0]


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


def bitonic_sort(keys: np.ndarray) -> np.ndarray:
    """csrc/seed_vote.cu's network: for each size and half, thread i
    compares slots a = 2i - (i & (half - 1)) and a + half, ascending where
    a & size == 0."""
    key = keys.copy()
    P = len(key)
    i = np.arange(P // 2)
    size = 2
    while size <= P:
        half = size // 2
        while half:
            a = 2 * i - (i & (half - 1))
            b = a + half
            x, y = key[a], key[b]
            swap = (x > y) == ((a & size) == 0)
            key[a[swap]], key[b[swap]] = y[swap], x[swap]
            half //= 2
        size *= 2
    return key


def emulate_kernel(flat, table, keys_sorted, pos, offsets, k, kb, stride,
                   H, top_k, tile=None):
    """The kernel's algorithm, row by row in numpy with its encodings."""
    flat = flat.numpy().astype(np.int64)
    N, R = flat.shape
    Q = len(offsets)
    n = Q * H
    P = svc.plan(N, Q, H)["slots"]
    M = len(pos)
    flip = lambda x: (np.asarray(x, np.int64) & 0xFFFFFFFF) ^ 0x80000000  # noqa: E731
    unflip = lambda u: ((np.asarray(u, np.int64) ^ 0x80000000)  # noqa: E731
                        .astype(np.uint32).view(np.int32).astype(np.int64))
    out0 = np.zeros((N, top_k), np.int64)
    out1 = np.zeros((N, top_k), np.int64)
    for row in range(N):
        kv = np.zeros(Q, np.int64)
        bad = np.zeros(Q, bool)
        for j in range(k):
            c = flat[row, np.arange(Q) * stride + j]
            kv = kv * 4 + np.where(c < 4, c, 0)
            bad |= c >= 4
        b = np.clip(kv >> (2 * (k - kb)), 0, len(table) - 2)
        lo = np.where(bad, 0, table[b])
        hi = np.where(bad, 0, table[b + 1])
        q = np.arange(n) // H
        s = lo[q] + np.arange(n) % H
        ok = s < hi[q]
        idx = np.clip(s, 0, M - 1)
        if kb < k:
            ok &= keys_sorted[idx] == kv[q]
        hv = np.where(ok, pos[idx], 0).astype(np.int64)
        if tile is None:
            key = flip(np.where(ok, hv - offsets[q], BIG))
        else:
            rowdiv, sidx, T = tile
            r = np.where(ok, hv // rowdiv, BIG)
            c = np.where(ok, (hv - (hv // rowdiv) * rowdiv) * sidx
                         - offsets[q], BIG)
            key = (flip(r) << 32) | flip(c)
        key = bitonic_sort(np.concatenate(
            [key.astype(np.uint64),
             np.full(P - n, np.iinfo(np.uint64).max, np.uint64)]))
        d = unflip(key[:n] >> np.uint64(32) if tile else
                   key[:n] & np.uint64(0xFFFFFFFF))
        end = np.append(key[1:n] != key[:n - 1], True)
        first = np.searchsorted(key[:n], key[:n], side="left")
        cnt = np.where(end & (d != BIG), np.arange(n) - first + 1, 0)
        packed = (cnt.astype(np.uint64) << np.uint64(32)) | (
            ~np.arange(n, dtype=np.uint64) & np.uint64(0xFFFFFFFF))
        prev = np.uint64(np.iinfo(np.uint64).max)
        for j in range(top_k):
            cand = packed[(cnt > 0) & (packed < prev)]
            best = cand.max() if len(cand) else np.uint64(0)
            if best == 0:
                out0[row, j:] = tile[2] if tile else sv.EMPTY_DIAG
                out1[row, j:] = 0
                break
            v = key[int(~np.uint32(best & np.uint64(0xFFFFFFFF)))]
            if tile:
                out0[row, j] = np.clip(unflip(v >> np.uint64(32)), 0,
                                       tile[2] - 1)
                out1[row, j] = unflip(v & np.uint64(0xFFFFFFFF))
            else:
                out0[row, j] = unflip(v & np.uint64(0xFFFFFFFF))
            prev = best
    return out0 if tile is None else (out0, out1)


@pytest.mark.parametrize("case", [CASES[1], CASES[5], CASES[8]],
                         ids=[CASES[i][0] for i in (1, 5, 8)])
def test_kernel_steps_emulated_in_numpy(case):
    name, k, prefix, stride, H, top_k, R, n, special = case
    flat, index, offs, kb = case_inputs(case)
    flat = flat[:16]
    args = port_args(flat, index, offs, k, kb, stride, H, top_k)
    want = sv.seed_vote_plain(*args)
    table, kv, pos = index
    got = emulate_kernel(flat, table, kv, pos, offs, k, kb, stride, H, top_k)
    np.testing.assert_array_equal(got, want.numpy())


def test_kernel_steps_emulated_in_numpy_tile_mode(xl):
    case = TILE_CASES[2]
    name, k, _, stride, H, top_k, R, n, _ = case
    _, table, pos_div, _, T = xl
    reads, offs = tile_case(xl, case)
    flat, _ = both_strands(torch.from_numpy(reads[:10]))
    tile = (TILE_C // INDEX_STRIDE, INDEX_STRIDE, T)
    t = torch.from_numpy
    want = sv.seed_vote_plain(flat, t(table), t(table[:1]), t(pos_div),
                              t(offs), k, k, stride, H, top_k, tile=tile)
    got = emulate_kernel(flat, table, table[:1], pos_div, offs, k, k, stride,
                         H, top_k, tile=tile)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_bitonic_network_sorts_with_padding():
    rng = np.random.default_rng(3)
    for n in (1, 5, 64, 100, 1000):
        P = max(64, 1 << (n - 1).bit_length())
        keys = rng.integers(0, 50, n).astype(np.uint64)
        padded = np.concatenate([keys, np.full(P - n, np.iinfo(np.uint64).max,
                                               np.uint64)])
        np.testing.assert_array_equal(bitonic_sort(padded)[:n], np.sort(keys))


def test_plan_sizes_the_workspace():
    p = svc.plan(16384, 99, 16)             # the XL rescue point
    assert p == {"slots": 2048, "workspace_bytes": 25776, "shared": True,
                 "grid": 16384, "threads": 512}
    p = svc.plan(16384, 20, 8)              # the flat engine
    assert (p["slots"], p["threads"], p["shared"]) == (256, 128, True)
    p = svc.plan(8, 1017, 32)               # past the shared-memory budget
    assert not p["shared"] and p["grid"] == 8
    assert p["workspace_bytes"] > svc.SMEM_BYTES


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
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_seed_vote_kernel_matches_plain(monkeypatch, case, shared):
    _needs_card()
    name, k, prefix, stride, H, top_k, R, n, special = case
    if not shared:
        monkeypatch.setattr(svc, "SMEM_BYTES", 0)     # every row in scratch
        monkeypatch.setattr(svc, "SCRATCH_BLOCKS", 5)  # blocks walk rows
    flat, index, offs, kb = case_inputs(case)
    _equal_on_card(port_args(flat, index, offs, k, kb, stride, H, top_k,
                             "cuda"))
    # two rows, and a row count off any block multiple
    for rows in (2, 2 * n - 3):
        _equal_on_card(port_args(flat[:rows], index, offs, k, kb, stride, H,
                                 top_k, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("case", TILE_CASES, ids=[c[0] for c in TILE_CASES])
def test_seed_vote_kernel_tile_mode_matches_plain(monkeypatch, xl, case,
                                                  shared):
    _needs_card()
    name, k, _, stride, H, top_k, R, n, _ = case
    if not shared:
        monkeypatch.setattr(svc, "SMEM_BYTES", 0)
    _, table, pos_div, _, T = xl
    reads, offs = tile_case(xl, case)
    flat, _ = both_strands(torch.from_numpy(reads).cuda())
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    _equal_on_card((flat, c(table), c(table[:1]), c(pos_div), c(offs), k, k,
                    stride, H, top_k),
                   tile=(TILE_C // INDEX_STRIDE, INDEX_STRIDE, T))


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
