"""The index arithmetic of the anchored kernels (csrc/anchor.cu), emulated
in numpy step by step and held exactly to the plain versions and the JAX
package.

- Seeding: the kernel never reads the patch matrix as a matrix.  It builds,
  for every 256-diagonal tile and every stream rho (diagonals rho mod
  4*SN), a strip of 4-byte one-hots from the first 4 bytes of the patch
  matrix's rows, and lets the tensor cores read row a of the B tile at
  strip byte 16a (the Toeplitz form).  Strides other than 1 and 2 run as
  SN in {1, 2} over a dilated read; wide reads round counts to bfloat16;
  the block maximum and its first lane ride in one key, folded per thread
  with compile-time column constants.  ``emulate_seed`` does exactly that
  and must give ``seed_block_max_plain``'s (bmax, lane).
- Extension: a lane a candidate.  Its Kadane (``kernel_kadane``: 4 codes
  a word tested with the kernel's byte flags, then best_segment's
  serial order) against the port's ``ops/kadane.py`` and JAX's
  ``best_segment`` on tie-heavy rows; a row's top-k as arg-max passes by
  its L lanes (``lane_topk``) against ``block_topk_plain`` and JAX's
  ``_block_topk_diagonals``; the best and runner-up as each lane's fold
  and a butterfly over the row's lanes (repeated ranks folded into the
  runner-up) against ``best_of_k``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from anchored_fusion_tpu.align import aligner as jal
from anchored_fusion_tpu.ops import kadane as jkadane
from anchored_fusion_tpu_torch.align import aligner as tal
from anchored_fusion_tpu_torch.bench import anchor_bench as ab
from anchored_fusion_tpu_torch.ops import anchor, anchor_cuda, kadane

PAD, N_CODE, INVALID = 5, 4, -1000
MATCH, MISMATCH = 1, 4
BUCKETS, KC, TILE = (8, 16, 20), 8, 256   # csrc/anchor.cu kStepBuckets, kKC, kTileD
I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


# ------------------------------------------------------------------ seeding

def bf16_round(c: np.ndarray) -> np.ndarray:
    """The kernel's round-to-nearest-even of non-negative counts."""
    u = c.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.int64)


def seed_plan(R: int, stride: int, Rs: int) -> tuple:
    """(SN, dilation, the read's k-steps, the steps a stage, chunked)."""
    SN = 2 if stride % 2 == 0 else 1
    sd = stride // SN
    KSR = -(-Rs * sd // 8)
    if KSR > BUCKETS[-1]:
        return SN, sd, KSR, KC, True
    return SN, sd, KSR, min(b for b in BUCKETS if b >= KSR), False


def emulate_seed(codes: np.ndarray, w8: np.ndarray, D: int, stride: int):
    """The seeding kernel's arithmetic on the host: (bmax, lane)."""
    M, R = codes.shape
    Rs = -(-R // stride)
    nb = -(-D // 128)
    SN, sd, KSR, KS, chunked = seed_plan(R, stride, Rs)
    S, NW = 4 * SN, 64 // SN
    nch = -(-KSR // KS) if chunked else 1
    # the one-hot word of reference position y - (R-1): row y's first 4 bytes
    word = np.ascontiguousarray(w8[:D, :4]).view(np.uint32)[:, 0]
    # A: dilated position p reads column p * SN when sampled (zero one-hots
    # past the read fill the last bucket or chunk)
    p = np.arange(8 * KS * nch)
    ok = (p % sd == 0) & (p * SN < R)
    code = np.where(ok, codes[:, np.minimum(p * SN, R - 1)], PAD)
    A = (code[:, :, None] == np.arange(4)).reshape(M, -1).astype(np.int64)
    bmax = np.full((M, nb), I32_MIN, np.int64)
    lane = np.zeros((M, nb), np.int64)
    Q = 4 * NW + 8 * KS
    t4 = np.arange(4)
    for t in range(-(-D // TILE)):
        run = np.full((M, 2), I32_MIN, np.int64)
        for rho in range(S):
            cnt = np.zeros((M, NW), np.int64)
            for c in range(nch):
                # stage (t, c): strip rho, y = t*256 + rho + SN*(p0 + q)
                y = t * TILE + rho + SN * (c * 8 * KS + np.arange(Q))
                strip = np.where(y < D, word[np.minimum(y, D - 1)], 0)
                sbytes = strip.astype("<u4").view(np.uint8)
                # B row a = strip bytes [16a, 16a + 32 KS)
                rows = np.stack([sbytes[16 * a:16 * a + 32 * KS]
                                 for a in range(NW)]).astype(np.int64)
                cnt += A[:, 32 * KS * c:32 * KS * (c + 1)] @ rows.T
            if chunked:
                cnt = bf16_round(cnt)
            for a in range(NW):
                j, rem = divmod(a, 8)
                tt, e = divmod(rem, 2)
                blk = j // (4 // SN)
                ct = 255 + 128 * blk - S * (8 * j + e)
                rt = rho + 2 * S * tt
                d = t * TILE + rho + S * a
                # the compile-time split equals 255 - lane in the block
                assert ct - rt == 255 - (d - (2 * t + blk) * 128)
                assert 0 <= d - (2 * t + blk) * 128 < 128 and tt in t4
                run[:, blk] = np.maximum(run[:, blk], cnt[:, a] * 256 + ct - rt)
        for b in range(2):
            if 2 * t + b < nb:
                bmax[:, 2 * t + b] = run[:, b] >> 8
                lane[:, 2 * t + b] = 255 - (run[:, b] & 255)
    return bmax, lane


# (id, reference length, row width R, read length, stride, rows)
SEED_CASES = [
    ("R128", 700, 128, 101, 1, 130),
    ("R101-odd-width", 640, 101, 101, 1, 66),
    ("R160", 500, 160, 150, 1, 40),
    ("R200-chunked", 400, 200, 180, 1, 40),
    ("R320-bf16", 700, 320, 320, 1, 24),
    ("stride2", 700, 128, 101, 2, 130),
    ("stride2-R101", 500, 101, 101, 2, 34),
    ("stride3-dilated", 600, 128, 101, 3, 34),
    ("stride4-dilated", 600, 128, 101, 4, 34),
    ("one-block", 40, 64, 60, 1, 34),
    ("D%256==0", 897 + 128, 128, 101, 1, 20),
    ("two-rows", 300, 128, 101, 1, 2),
]


def seed_inputs(case):
    name, L, R, read_len, stride, rows = case
    rng = np.random.default_rng(sum(map(ord, name)))
    ref = rng.integers(0, 4, L).astype(np.int8)
    ref[rng.integers(0, L, 3)] = N_CODE
    if L > 260:
        ref[100:260] = np.tile(rng.integers(0, 4, 8), 20)   # ties
    reads = np.full((rows, R), PAD, np.int8)
    for b in range(rows):
        n = min(read_len, L)
        s = int(rng.integers(-n // 3, L - 2 * n // 3))
        seq = np.full(n, N_CODE, np.int8)
        lo, hi = max(s, 0), min(s + n, L)
        seq[lo - s:hi - s] = ref[lo:hi]
        if b % 5 == 4:
            seq = rng.integers(0, 4, n).astype(np.int8)
        reads[b, :n] = seq
    reads[0] = PAD
    if rows > 2:
        reads[2, :read_len] = N_CODE
    return ref, reads, stride


@pytest.mark.parametrize("case", SEED_CASES, ids=[c[0] for c in SEED_CASES])
def test_seed_strips_reproduce_patch_matrix_and_block_max(case):
    ref, reads, stride = seed_inputs(case)
    R = reads.shape[1]
    seed, _ = tal._seed_matrix_cached(ref, R, stride, torch.device("cpu"))
    D, K = seed.diagonals, 4 * seed.positions
    w8 = seed.i8.numpy()
    # the strips' source: row y's first word is the one-hot of ref[y-(R-1)]
    pos = np.arange(D) - (R - 1)
    inside = (pos >= 0) & (pos < len(ref))
    code = np.where(inside, ref[np.clip(pos, 0, len(ref) - 1)], PAD)
    np.testing.assert_array_equal(
        w8[:D, :4], (code[:, None] == np.arange(4)).astype(np.int8))
    # and the Toeplitz rows rebuild the patch matrix itself (stride 1 and
    # 2, SN streams): diagonal d, k 4p+c from the strip of d's stream
    SN, sd, _, KS, _ = seed_plan(R, stride, seed.positions)
    if sd == 1 and K <= 8 * KS:
        word = np.ascontiguousarray(w8[:D, :4]).view(np.uint32)[:, 0]
        S = 4 * SN
        for d in range(0, D, 37):
            rho, a = d % S, d // S % (64 // SN)
            y0 = d - S * a                              # the stream's start
            y = y0 + SN * np.arange(4 * (64 // SN) + 8 * KS)
            strip = np.where(y < D, word[np.minimum(y, D - 1)], 0)
            row = strip.astype("<u4").view(np.uint8)[16 * a:16 * a + K]
            np.testing.assert_array_equal(row, w8[d, :K].view(np.uint8))
    want = anchor.seed_block_max_plain(torch.from_numpy(reads), seed.f32,
                                       stride)
    got = emulate_seed(reads, w8, D, stride)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    if R >= 300:
        assert (got[0] > 256).any()


# ---------------------------------------------------------------- extension

def zero_bytes(x: int) -> int:
    """csrc/anchor.cu zero_bytes: 0x80 in every zero byte of a word."""
    m = 0xFFFFFFFF
    return ~((((x & 0x7F7F7F7F) + 0x7F7F7F7F) & m) | x | 0x7F7F7F7F) & m


def kernel_kadane(read: np.ndarray, win: np.ndarray, match=MATCH,
                  mismatch=MISMATCH) -> dict:
    """csrc/anchor.cu's extension of one candidate: 4 codes a word tested
    with byte arithmetic, then Kadane serially in best_segment's order."""
    R = len(read)
    pad = -(-R // 4) * 4 - R
    rw = np.concatenate([read, np.full(pad, PAD, np.int8)]).view("<u4")
    ww = np.concatenate([win, np.full(pad, PAD, np.int8)]).view("<u4")
    T = Pm = amin = pma = 0
    cmin = I32_MAX
    seg = (I32_MIN, 0, 0, 0)
    for l, (r4, w4) in enumerate(zip(rw.tolist(), ww.tolist())):
        eqm = zero_bytes((r4 ^ w4) | (r4 & 0xFCFCFCFC))
        inv = zero_bytes(r4 ^ 0x05050505) | zero_bytes(w4 ^ 0x05050505)
        for i in range(4):
            t = 4 * l + i
            if t >= R:
                break
            bit = 0x80 << (8 * i)
            eq = int(eqm & bit != 0)
            sc = match if eq else (INVALID if inv & bit else -mismatch)
            if T < cmin:
                cmin, amin, pma = T, t, Pm
            T += sc
            Pm += eq
            if T - cmin > seg[0]:
                seg = (T - cmin, amin, t, Pm - pma)
    return dict(zip(("score", "start", "end", "matches"), seg))


def tie_heavy_rows(draw_codes: list, R: int, period: int) -> tuple:
    """A read and a window of R codes built from a short unit with PAD and
    N runs: many equal prefix minima and equal segment scores."""
    unit = np.asarray(draw_codes[:period], np.int8)
    read = np.tile(unit, -(-R // period))[:R].copy()
    win = np.roll(read, len(draw_codes) % period)
    rest = np.asarray(draw_codes[period:], np.int64)
    for k, v in enumerate(rest):
        at = int(v * 7919 + k * 104729) % R
        if v % 3 == 0:
            read[at] = PAD
        elif v % 3 == 1:
            win[at] = N_CODE
        else:
            win[at] = (win[at] + 1) % 4
    return read, win


@settings(max_examples=80, deadline=None)
@given(R=st.sampled_from([20, 32, 101, 128, 160, 320]),
       period=st.integers(1, 6),
       codes=st.lists(st.integers(0, 5), min_size=6, max_size=40),
       tail=st.integers(0, 40))
def test_kernel_kadane_matches_best_segment(R, period, codes, tail):
    codes = [min(c, 3) for c in codes[:period]] + codes[period:]
    read, win = tie_heavy_rows(codes, R, period)
    if tail:
        read[R - tail:] = PAD                   # reads shorter than the row
    got = kernel_kadane(read, win)
    valid = torch.from_numpy((read != PAD) & (win != PAD))
    sc, ism = kadane.segment_scores(torch.from_numpy(read),
                                    torch.from_numpy(win), valid,
                                    MATCH, MISMATCH)
    port = kadane.best_segment(sc, ism)
    jax_seg = jkadane.best_segment(jnp.asarray(sc.numpy()),
                                   jnp.asarray(ism.numpy()))
    for n in got:
        assert got[n] == int(port[n]) == int(jax_seg[n]), n


def lane_topk(bmax: np.ndarray, lane: np.ndarray, k: int, D: int) -> list:
    """csrc/anchor.cu's top-k of one row by its L lanes: k arg-max passes
    in (maximum descending, block ascending) order, lane gl scanning
    blocks gl, gl + L, ..., a butterfly over the lanes; ranks past the
    blocks repeating the last; the diagonal of each."""
    nb = len(bmax)
    kk = min(k, nb)
    L = min(16, 1 << max(kk - 1, 0).bit_length())
    pv, pb, out = I32_MAX, -1, []
    for _ in range(kk):
        cv = [I32_MIN] * L
        cq = [I32_MAX] * L
        for gl in range(L):
            for q in range(gl, nb, L):
                x = int(bmax[q])
                if (x < pv or (x == pv and q > pb)) and x > cv[gl]:
                    cv[gl], cq[gl] = x, q
        o = 1
        while o < L:
            pairs = [(cv[g ^ o], cq[g ^ o]) for g in range(L)]
            for g, (ov, oq) in enumerate(pairs):
                if ov > cv[g] or (ov == cv[g] and oq < cq[g]):
                    cv[g], cq[g] = ov, oq
            o <<= 1
        assert len(set(zip(cv, cq))) == 1
        pv, pb = cv[0], cq[0]
        out.append(min(pb * 128 + int(lane[pb]), D - 1))
    return out + [out[-1]] * (k - kk)


def merge_best(a: tuple, b: tuple) -> tuple:
    """csrc/anchor.cu merge_best on (score, rank, second)."""
    a_wins = a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])
    w, lo = (a, b) if a_wins else (b, a)
    return (w[0], w[1], max(a[2], b[2], lo[0]))


@settings(max_examples=60, deadline=None)
@given(scores=st.lists(st.integers(-3, 3), min_size=1, max_size=40),
       repeats=st.integers(0, 5))
def test_lane_fold_matches_best_of_k(scores, repeats):
    """A row's best (first maximum) and runner-up (the second of a stable
    descending sort) as the kernel takes them over its kk distinct
    candidates: each lane folds its ranks gl, gl + L, ... in order, a
    butterfly over the L lanes, then the k - kk repeats of rank kk - 1
    (fewer blocks than k) join the runner-up."""
    kk = len(scores)
    k = kk + repeats
    L = min(16, 1 << max(kk - 1, 0).bit_length())
    lanes = []
    for gl in range(L):
        m = (I32_MIN, I32_MAX, I32_MIN)
        for j in range(gl, kk, L):
            m = merge_best(m, (scores[j], j, I32_MIN))
        lanes.append(m)
    o = 1
    while o < L:
        lanes = [merge_best(lanes[g], lanes[g ^ o]) for g in range(L)]
        o <<= 1
    assert len(set(lanes)) == 1
    score, rank, second = lanes[0]
    if kk < k:
        second = max(second, scores[-1])
    if k == 1:
        second = 0
    full = scores + [scores[-1]] * repeats
    sc = torch.tensor([full], dtype=torch.int32)
    seg = {n: sc for n in ("score", "start", "end", "matches", "length")}
    want = anchor.best_of_k(seg, torch.arange(k, dtype=torch.int32)[None])
    assert (score, rank, second) == (int(want["score"]), int(want["off"]),
                                     int(want["second"]))


@pytest.mark.parametrize("D,k", [(6925, 4), (6925, 8), (200, 4), (130, 8),
                                 (100, 1), (4200, 33)],
                         ids=["main", "k8", "nb<k", "nb2-k8", "one-block",
                              "k33"])
def test_lane_topk_matches_block_topk(D, k):
    rng = np.random.default_rng(D + k)
    # integer counts with many ties between and inside blocks
    counts = rng.integers(0, 6, (24, D)).astype(np.float32)
    counts[::3, : D // 2] = 3
    counts[1::4] = rng.integers(0, 2, (len(counts[1::4]), D))
    bmax, lane = anchor.block_max_plain(torch.from_numpy(counts))
    want = anchor.block_topk_plain(bmax, lane, k, D).numpy()
    jidx = np.asarray(jal._block_topk_diagonals(jnp.asarray(counts), k))
    np.testing.assert_array_equal(want, jidx)
    got = np.array([lane_topk(bmax[i].numpy(), lane[i].numpy(), k, D)
                    for i in range(len(counts))])
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("shape", ab.EDGE_SHAPES,
                         ids=[s[0] for s in ab.EDGE_SHAPES])
def test_anchor_kernels_edge_shapes_on_cuda(shape):
    """Rows off the 128-row tile, 1,024-wide reads (the K-chunked seeding,
    8 pieces of the extension's scan), a one-block reference and stride 3,
    both kernels equal to their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("the anchored kernels run only on a CUDA device")
    rng = np.random.default_rng(sum(map(ord, shape[0])))
    flat, co, seed, refp, stride, k = ab.shape_inputs(rng, shape)
    R = flat.shape[1]
    got = anchor_cuda.seed_block_max_cuda(flat, seed, stride)
    torch.cuda.synchronize()
    want = anchor.seed_block_max_plain(flat, seed.f32, stride)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    args = (flat, co, refp, R, MATCH, MISMATCH, k)
    cand = dict(bmax=want[0], lane=want[1], D=seed.diagonals)
    rec = anchor_cuda.extend_fold_cuda(*args, **cand)
    torch.cuda.synchronize()
    plain = anchor.extend_fold_plain(*args, **cand)
    for n in plain:
        assert torch.equal(rec[n], plain[n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["block", "offsets"])
def test_extend_fold_many_candidates_on_cuda(mode):
    """k = 40 (five rounds of eight candidates a warp), in block mode on a
    3-block reference (ranks past the blocks repeat the last) and in
    offsets mode."""
    if not torch.cuda.is_available():
        pytest.skip("the anchored kernels run only on a CUDA device")
    rng = np.random.default_rng(40)
    shape = ("k40", 300, 128, 101, 200, 1, 40, "random")
    flat, co, seed, refp, stride, k = ab.shape_inputs(rng, shape)
    R = flat.shape[1]
    args = (flat, co, refp, R, MATCH, MISMATCH, k)
    if mode == "block":
        bmax, lane = anchor.seed_block_max_plain(flat, seed.f32, stride)
        cand = dict(bmax=bmax, lane=lane, D=seed.diagonals)
    else:
        offs = rng.integers(-R - 20, 220, (flat.shape[0], k))
        cand = dict(offs=torch.from_numpy(offs.astype(np.int32)).cuda())
    rec = anchor_cuda.extend_fold_cuda(*args, **cand)
    torch.cuda.synchronize()
    plain = anchor.extend_fold_plain(*args, **cand)
    for n in plain:
        assert torch.equal(rec[n], plain[n]), n
