"""The port's Smith-Waterman against the JAX package's, exactly.

Inputs are made from a seed with numpy and go through the JAX functions
(``ops.sw`` on its lax.scan path, ``refine._sw_align_fast`` on its CPU
branch) and the port's plain version; every integer output must be equal.
A numpy model of the CUDA kernel's schedule (csrc/sw.cu) is held against
both here; the kernel itself is held against the plain version on the card.
"""

import numpy as np
import pytest
import torch

from anchored_fusion_tpu.align.refine import _sw_align_fast
from anchored_fusion_tpu.config import AlignConfig
from anchored_fusion_tpu.ops import sw as jsw
from anchored_fusion_tpu_torch.ops import sw as tsw
from anchored_fusion_tpu_torch.ops import sw_cuda

PAD = 5
FIELDS = ("score", "end_read", "end_win", "start_read", "start_win")


def _numpy_sw(read, win, match=1, mismatch=4, go=7, ge=1):
    """Golden full DP (tests/test_sw_pallas.py) on ACGT-only sequences."""
    R, W = len(read), len(win)
    H = np.zeros((R + 1, W + 1), np.int32)
    E = np.full((R + 1, W + 1), -10**6, np.int32)
    F = E.copy()
    best = 0
    for i in range(1, R + 1):
        for j in range(1, W + 1):
            s = match if read[i - 1] == win[j - 1] else -mismatch
            E[i][j] = max(H[i][j - 1] - go, E[i][j - 1] - ge)
            F[i][j] = max(H[i - 1][j] - go, F[i - 1][j] - ge)
            H[i][j] = max(0, H[i - 1][j - 1] + s, E[i][j], F[i][j])
            best = max(best, H[i][j])
    return best


def sw_inputs(seed, B, R, lr):
    """Reads of ``lr`` bases in R-wide rows, windows W = R + 32 holding each
    read with implanted indels, SNPs, N bases, PAD tails and all-PAD rows."""
    rng = np.random.default_rng(seed)
    W = R + 32
    reads = rng.integers(0, 4, (B, R)).astype(np.int8)
    reads[:, lr:] = PAD
    wins = rng.integers(0, 4, (B, W)).astype(np.int8)
    for b in range(B):
        seg = reads[b, :lr].copy()
        kind = b % 4
        p = int(rng.integers(lr // 4, 3 * lr // 4))
        if kind == 1:
            seg = np.concatenate([seg[:p], seg[p + 3:]])           # deletion
        elif kind == 2:
            seg = np.concatenate([seg[:p], rng.integers(0, 4, 2).astype(
                np.int8), seg[p:]])                                # insertion
        elif kind == 3:
            seg[p] = (seg[p] + 1) % 4                              # SNP
        o = int(rng.integers(0, W - lr + 1))
        seg = seg[:W - o]
        wins[b, o:o + len(seg)] = seg
        if b % 5 == 0:
            reads[b, int(rng.integers(0, lr))] = 4
        if b % 7 == 0:
            wins[b, int(rng.integers(0, W))] = 4
        if b % 6 == 0:
            wins[b, W - int(rng.integers(1, 24)):] = PAD
        if b % 9 == 0:
            reads[b, :] = PAD
    return reads, wins


# (B, R, read length): odd and even R, B not a multiple of 64
CASES = [(37, 33, 30), (21, 48, 48), (13, 101, 95)]


def edge_inputs(name):
    """Edge and tie-heavy batches: (reads, windows)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "R=1":                          # one row, W < 32
        return (rng.integers(0, 6, (11, 1)).astype(np.int8),
                rng.integers(0, 6, (11, 20)).astype(np.int8))
    if name.startswith("R="):                  # R not a multiple of RPL*32
        R = int(name[2:])
        return sw_inputs(R, 11, R, R - R // 4)
    if name == "W<32":
        reads = rng.integers(0, 4, (9, 40)).astype(np.int8)
        reads[:, 35:] = PAD
        wins = rng.integers(0, 4, (9, 20)).astype(np.int8)
        wins[::2, 3:15] = reads[::2, 10:22]
        wins[3, 17:] = PAD
        return reads, wins
    if name == "all-PAD":                      # all-PAD reads, windows, both
        reads, wins = sw_inputs(3, 6, 33, 30)
        reads[0:2] = PAD
        wins[2:4] = PAD
        reads[4], wins[4] = PAD, PAD
        return reads, wins
    if name == "short-read":                   # a few bases in a wide row
        reads, wins = sw_inputs(4, 8, 64, 64)
        for b in range(8):
            reads[b, 3 + b:] = PAD
        return reads, wins
    if name == "all-A":
        return (np.zeros((5, 40), np.int8),
                np.zeros((5, 72), np.int8))
    if name in ("period-2", "period-3"):
        p = int(name[-1])
        reads = np.tile(np.arange(p, dtype=np.int8), 64)[None, :50]
        reads = np.repeat(reads, 6, 0)
        wins = np.tile(np.arange(p, dtype=np.int8), 64)[None, :90]
        wins = np.repeat(wins, 6, 0)
        for b in range(6):                     # shift phase, some PAD
            wins[b] = np.roll(wins[b], b)
            reads[b, 50 - 3 * b:] = PAD
        return reads, wins
    if name == "repeat-read":                  # equal best in one column,
        reads = np.full((8, 128), PAD, np.int8)  # rows in different lanes
        wins = rng.integers(0, 4, (8, 160)).astype(np.int8)
        for b in range(8):
            x = rng.integers(0, 4, 30).astype(np.int8)
            gap = 4 + 9 * b
            reads[b, :30] = x
            reads[b, 30:30 + gap] = rng.integers(0, 4, gap)
            reads[b, 30 + gap:60 + gap] = x
            wins[b, 50 + b:80 + b] = x
        return reads, wins
    if name == "single-match":                 # one window A: the best is
        reads = np.ones((6, 128), np.int8)     # a tie of rows in one column
        wins = np.full((6, 160), 2, np.int8)
        for b, rows in enumerate([(1, 2), (0, 3), (5, 6), (4, 100),
                                  (9, 10, 11), range(128)]):
            reads[b, list(rows)] = 0
            wins[b, 7 + 13 * b] = 0
        return reads, wins
    if name == "identical":                    # one read repeated in a batch
        reads, wins = sw_inputs(6, 4, 48, 45)
        return np.repeat(reads[:1], 7, 0), np.repeat(wins[:1], 7, 0)
    raise KeyError(name)


EDGES = ["R=1", "R=31", "R=33", "R=128", "W<32", "all-PAD", "short-read",
         "all-A", "period-2", "period-3", "repeat-read", "single-match",
         "identical"]


# ------------------------------------------------ model of csrc/sw.cu

NEG = -(2 ** 28)
LANES = np.arange(32)


def _staged(codes, valid):
    return np.where(valid, np.where(codes < 4, codes, 4), PAD).astype(np.int64)


def _last_valid(valid):
    n = valid.shape[1]
    return np.where(valid.any(1), n - 1 - np.argmax(valid[:, ::-1], 1), -1)


def _model_strip(rd, wn, ncols, reverse, rend, wend, rpl, base, srows,
                 first, above_h, above_f, match, mismatch, go, ge):
    """One strip of 32*rpl rows starting at row ``base`` (``srows`` of them
    valid per pair): lane l holds rows base + [l*rpl, (l+1)*rpl) and
    computes column t - l at step t from the H and F its left neighbour
    lane produced at step t - 1; lane 0 takes the strip above's last row
    (``above_h``/``above_f`` by column; the top edge H = 0, F = NEG on the
    first strip).  Every lane computes every step, with PAD columns outside
    the pass; F runs down the lane as max(F - ge, HnoF - go); a strict
    per-lane best, then the lanes' reduction.  Returns the strip's best
    (score, row, col) and its last row's H and F by column."""
    B, R = rd.shape
    W = above_h.shape[1]
    bi = np.arange(B)[:, None]
    rows = LANES[:, None] * rpl + np.arange(rpl)[None, :]          # (32, rpl)
    grow = base + rows
    src = rend[:, None, None] - grow[None] if reverse else grow[None]
    c = np.where(rows[None] < srows[:, None, None],
                 rd[bi[:, :, None], np.clip(src, 0, R - 1)], PAD)
    rcmp = np.where(c < 4, c, 99)
    rbase = np.where(c != PAD, -mismatch, NEG)
    H = np.zeros((B, 32, rpl), np.int64)
    E = np.full((B, 32, rpl), max(-go, NEG - ge), np.int64)
    nlanes = (srows + rpl - 1) // rpl
    steps = np.where((srows > 0) & (ncols > 0), ncols + nlanes - 1, 0)
    last_h = np.zeros((B, 32), np.int64)
    last_f = np.full((B, 32), NEG, np.int64)
    diag0 = np.zeros((B, 32), np.int64)
    best = np.zeros((B, 32), np.int64)
    bcol = np.zeros((B, 32), np.int64)
    brow = np.zeros((B, 32), np.int64)
    below_h = np.zeros((B, W), np.int64)
    below_f = np.full((B, W), NEG, np.int64)
    for t in range(int(steps.max(initial=0))):
        up_h = np.concatenate([last_h[:, :1], last_h[:, :-1]], 1)  # shfl_up
        up_f = np.concatenate([last_f[:, :1], last_f[:, :-1]], 1)
        j = np.broadcast_to(t - LANES, (B, 32))
        # lane 0: the row above the strip at column t
        top = (t < ncols) & (not first)
        up_h[:, 0] = np.where(top, above_h[:, min(t, W - 1)], 0)
        up_f[:, 0] = np.where(top, above_f[:, min(t, W - 1)], NEG)
        # every lane computes every step: a column outside the pass is PAD
        inside = (j >= 0) & (j < ncols[:, None]) & (t < steps[:, None])
        col = np.clip(wend[:, None] - j if reverse else j, 0, wn.shape[1] - 1)
        w = np.where(inside, wn[bi, col], PAD)
        colpen = np.where(w == PAD, NEG, 0)
        F = np.maximum(up_f - ge, up_h - go)
        if first:
            F[:, 0] = NEG
        diag = diag0
        for k in range(rpl):
            s = np.where(rcmp[:, :, k] == w, match, rbase[:, :, k])
            hn = np.maximum(np.maximum(diag + s + colpen, E[:, :, k]), 0)
            h = np.maximum(hn, F)
            diag = H[:, :, k].copy()
            H[:, :, k] = h
            E[:, :, k] = np.maximum(E[:, :, k] - ge, h - go)
            if k + 1 < rpl:
                F = np.maximum(F - ge, hn - go)
        last_h = H[:, :, -1].copy()
        last_f = F
        j31 = t - 31
        if 0 <= j31 < W:
            keep = (j31 < ncols) & (t < steps)
            below_h[:, j31] = np.where(keep, last_h[:, 31], below_h[:, j31])
            below_f[:, j31] = np.where(keep, last_f[:, 31], below_f[:, j31])
        diag0 = up_h
        cm = H.max(2)
        better = (cm > best) & (t < steps[:, None])
        best = np.where(better, cm, best)
        bcol = np.where(better, j, bcol)
        brow = np.where(better, LANES[None] * rpl + np.argmax(H == cm[:, :, None], 2),
                        brow)
    for off in (16, 8, 4, 2, 1):                     # shfl_xor reduction
        p = LANES ^ off
        o = (best[:, p], bcol[:, p], brow[:, p])
        take = (o[0] > best) | ((o[0] == best) & (
            (o[1] < bcol) | ((o[1] == bcol) & (o[2] < brow))))
        best = np.where(take, o[0], best)
        bcol = np.where(take, o[1], bcol)
        brow = np.where(take, o[2], brow)
    return best[:, 0], base + brow[:, 0], bcol[:, 0], below_h, below_f


def _model_pass(rd, nrows, wn, ncols, reverse, rend, wend, rpl, match,
                mismatch, go, ge):
    """One pass of the kernel's warp schedule, for every pair at once: the
    rows in strips of 32*rpl, top to bottom (:func:`_model_strip`), each
    strip's best joining the pair's by (higher score, earlier column, lower
    row)."""
    B = rd.shape[0]
    strip = 32 * rpl
    nstrips = np.where(ncols > 0, (nrows + strip - 1) // strip, 0)
    best = np.zeros(B, np.int64)
    brow = np.zeros(B, np.int64)
    bcol = np.zeros(B, np.int64)
    above_h = np.zeros((B, wn.shape[1]), np.int64)
    above_f = np.full((B, wn.shape[1]), NEG, np.int64)
    for st in range(int(nstrips.max(initial=0))):
        srows = np.clip(nrows - st * strip, 0, strip)
        sb, sr, sc, above_h, above_f = _model_strip(
            rd, wn, ncols, reverse, rend, wend, rpl, st * strip, srows,
            st == 0, above_h, above_f, match, mismatch, go, ge)
        take = (st < nstrips) & ((sb > best) | ((sb == best) & (
            (sc < bcol) | ((sc == bcol) & (sr < brow)))))
        best = np.where(take, sb, best)
        brow = np.where(take, sr, brow)
        bcol = np.where(take, sc, bcol)
    return best, brow, bcol


def kernel_model(reads, wins, read_valid=None, window_valid=None, match=1,
                 mismatch=4, gap_open=6, gap_extend=1, max_rpl=32):
    """What csrc/sw.cu computes: fused (5, B) without masks, forward-only
    (3, B) with them.  ``max_rpl`` is the kernel's cap on rows a lane
    holds (32); a lower cap runs short rows in several strips."""
    masked = read_valid is not None
    rv = read_valid if masked else reads != PAD
    wv = window_valid if masked else wins != PAD
    rd, wn = _staged(reads, rv), _staged(wins, wv)
    R = reads.shape[1]
    rpl = 1
    while rpl * 32 < R and rpl < max_rpl:
        rpl *= 2
    go, ge = gap_open + gap_extend, gap_extend
    kw = dict(rpl=rpl, match=match, mismatch=mismatch, go=go, ge=ge)
    zero = np.zeros(len(reads), np.int64)
    score, er, ej = _model_pass(rd, _last_valid(rv) + 1, wn,
                                _last_valid(wv) + 1, False, zero, zero, **kw)
    if masked:
        return np.stack([score, er, ej])
    _, sr, sj = _model_pass(rd, er + 1, wn, ej + 1, True, er, ej, **kw)
    return np.stack([score, er, ej, er - sr, ej - sj])


def random_masks(seed, reads, wins):
    """Validity masks with random interior False cells, some rows all False
    and a few PAD codes marked valid: sw_end's masks need not equal
    ``code != PAD``."""
    rng = np.random.default_rng(seed)
    rv = (reads != PAD) & (rng.random(reads.shape) > 0.1)
    wv = (wins != PAD) & (rng.random(wins.shape) > 0.1)
    rv |= rng.random(reads.shape) < 0.03       # a valid PAD code: mismatch
    wv |= rng.random(wins.shape) < 0.03
    rv[::7] = False
    wv[3::11] = False
    return rv, wv


def all_inputs(case):
    if isinstance(case, str):
        return edge_inputs(case)
    B, R, lr = case
    return sw_inputs(B * 5 + R, B, R, lr)


@pytest.mark.parametrize("B,R,lr", CASES)
def test_sw_end_matches_jax(B, R, lr):
    reads, wins = sw_inputs(B * R, B, R, lr)
    rv, wv = reads != PAD, wins != PAD
    want = [np.asarray(x) for x in jsw.sw_end(reads, wins, rv, wv)]
    got = tsw.sw_end(torch.from_numpy(reads), torch.from_numpy(wins),
                     torch.from_numpy(rv), torch.from_numpy(wv))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("B,R,lr", CASES)
def test_sw_align_matches_jax(B, R, lr):
    reads, wins = sw_inputs(B + R, B, R, lr)
    rv, wv = reads != PAD, wins != PAD
    want = jsw.sw_align(reads, wins, rv, wv)
    got = tsw.sw_align(torch.from_numpy(reads), torch.from_numpy(wins),
                       torch.from_numpy(rv), torch.from_numpy(wv))
    for k in ("score", "score_rev") + FIELDS[1:]:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


@pytest.mark.parametrize("B,R,lr", CASES)
def test_fused_plain_matches_refine_cpu_branch(B, R, lr):
    reads, wins = sw_inputs(B * 3 + R, B, R, lr)
    want = _sw_align_fast(reads, wins, reads != PAD, wins != PAD,
                          AlignConfig())
    before = sw_cuda.launches
    got = sw_cuda.sw_align_fused(torch.from_numpy(reads),
                                 torch.from_numpy(wins))
    # a CPU tensor takes the plain version and launches nothing
    assert sw_cuda.launches == before
    assert got.shape == (5, B) and got.dtype == torch.int32
    for i, k in enumerate(FIELDS):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[k]), k)


def test_plain_sw_matches_numpy_golden():
    rng = np.random.default_rng(0)
    B, R, W = 12, 32, 48
    reads = rng.integers(0, 4, (B, R)).astype(np.int8)
    wins = rng.integers(0, 4, (B, W)).astype(np.int8)
    for b in range(B):
        o = int(rng.integers(0, W - 20))
        wins[b, o:o + 16] = reads[b, 8:24]
        if b % 3 == 0:
            wins[b, o + 5] = (wins[b, o + 5] + 1) % 4
    golden = np.asarray([_numpy_sw(reads[b], wins[b]) for b in range(B)])
    got = tsw.sw_align_fused_plain(torch.from_numpy(reads),
                                   torch.from_numpy(wins))
    np.testing.assert_array_equal(got[0].numpy(), golden)


@pytest.mark.parametrize("case", CASES + EDGES, ids=str)
def test_kernel_model_matches_plain_and_jax(case):
    reads, wins = all_inputs(case)
    got = kernel_model(reads, wins)
    plain = tsw.sw_align_fused_plain(torch.from_numpy(reads),
                                     torch.from_numpy(wins)).numpy()
    np.testing.assert_array_equal(got, plain)
    want = _sw_align_fast(reads, wins, reads != PAD, wins != PAD,
                          AlignConfig())
    for i, k in enumerate(FIELDS):
        np.testing.assert_array_equal(got[i], np.asarray(want[k]), k)


@pytest.mark.parametrize("case", CASES + EDGES, ids=str)
def test_kernel_model_forward_masked_matches_sw_end(case):
    reads, wins = all_inputs(case)
    rv, wv = random_masks(len(reads), reads, wins)
    got = kernel_model(reads, wins, rv, wv)
    want = tsw.sw_end(*map(torch.from_numpy, (reads, wins, rv, wv)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_kernel_model_other_scores_match_plain():
    reads, wins = sw_inputs(17, 15, 40, 36)
    kw = dict(match=2, mismatch=3, gap_open=0, gap_extend=2)
    got = kernel_model(reads, wins, **kw)
    want = tsw.sw_align_fused_plain(torch.from_numpy(reads),
                                    torch.from_numpy(wins), **kw).numpy()
    np.testing.assert_array_equal(got, want)


STRIP_EDGES = ["R=1", "R=33", "W<32", "all-PAD", "short-read",
               "single-match", "repeat-read"]


@pytest.mark.parametrize("case", CASES + STRIP_EDGES, ids=str)
def test_kernel_model_strips_match_plain(case):
    """Rows walked in strips (here of 32 or 64 rows: a lane holds one or
    two), each strip's lane 0 starting from the strip above's last row, as
    csrc/sw.cu walks pairs taller than 1,024 rows: the same records."""
    reads, wins = all_inputs(case)
    got = kernel_model(reads, wins, max_rpl=1)
    plain = tsw.sw_align_fused_plain(torch.from_numpy(reads),
                                     torch.from_numpy(wins)).numpy()
    np.testing.assert_array_equal(got, plain)
    rv, wv = random_masks(len(reads) + 1, reads, wins)
    got = kernel_model(reads, wins, rv, wv, max_rpl=2)
    want = tsw.sw_end(*map(torch.from_numpy, (reads, wins, rv, wv)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def long_rows(seed, B, R, kind):
    """Pairs of R-wide rows past one strip of 1,024: random reads implanted
    with indels (``random``), or runs of one base against windows of it,
    where the best ties over many rows and columns (``ties``)."""
    if kind == "random":
        return sw_inputs(seed, B, R, R - 7)
    rng = np.random.default_rng(seed)
    reads = np.zeros((B, R), np.int8)
    wins = np.zeros((B, R + 32), np.int8)
    for b in range(B):
        reads[b, int(rng.integers(900, R)):] = PAD
        wins[b, int(rng.integers(0, R)):] = int(rng.integers(0, 4))
    return reads, wins


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_kernel_model_long_rows_match_jax(kind):
    """R = 1152, two strips at the kernel's 32 rows a lane: the model of
    csrc/sw.cu equals the plain SW and the JAX package's refine branch."""
    reads, wins = long_rows(11, 2, 1152, kind)
    got = kernel_model(reads, wins)
    plain = tsw.sw_align_fused_plain(torch.from_numpy(reads),
                                     torch.from_numpy(wins)).numpy()
    np.testing.assert_array_equal(got, plain)
    want = _sw_align_fast(reads, wins, reads != PAD, wins != PAD,
                          AlignConfig())
    for i, k in enumerate(FIELDS):
        np.testing.assert_array_equal(got[i], np.asarray(want[k]), k)


def test_refine_result_long_rows_matches_jax_cpu_branch():
    """Refinement of 1,152-wide rows (past one strip) on the CPU: the
    port's refine_result against the JAX package's (its CPU branch,
    refine.py:68-88), from the same ungapped records."""
    from anchored_fusion_tpu.align.aligner import AlignmentResult as JRes
    from anchored_fusion_tpu.align.refine import refine_result as j_refine
    from anchored_fusion_tpu_torch.align.aligner import align_to_reference
    from anchored_fusion_tpu_torch.align.refine import refine_result
    from anchored_fusion_tpu_torch.config import AlignConfig as TCfg
    rng = np.random.default_rng(8)
    ref = rng.integers(0, 4, 6000).astype(np.int8)
    R = 1152
    reads = np.full((6, R), PAD, np.int8)
    for b in range(6):
        o = int(rng.integers(0, 4700))
        seg = ref[o:o + 1100].copy()
        if b % 2:
            seg = np.concatenate([seg[:500], seg[503:]])       # deletion
        else:
            seg = np.concatenate([seg[:600], [1, 2], seg[600:1090]])
        reads[b, :len(seg)] = seg
    cfg = TCfg(gapped_refine=False)
    res = align_to_reference(reads, ref, cfg, device="cpu")
    assert res.mapped.sum() >= 4
    jres = JRes(**{k: np.array(v) for k, v in vars(res).items()})
    want = j_refine(jres, reads, ref, AlignConfig(), cfg.min_align_score,
                    0.0, cfg.min_seg_len)
    got = refine_result(res, reads, ref, TCfg(), cfg.min_align_score, 0.0,
                        cfg.min_seg_len, device="cpu")
    assert (got.score > res.score).sum() >= 4     # the gaps were bridged
    for k in vars(want):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)


def test_cuda_wrapper_bounds_follow_the_key():
    """Any read width up to MAX_W passes the wrapper's checks (the CPU
    tensors then stop it); the key bound match * min(R, W) < 2^26 and
    MAX_W do not."""
    r = torch.full((2, 1152), PAD, dtype=torch.int8)
    w = torch.full((2, 1216), PAD, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        sw_cuda.sw_align_fused_cuda(r, w)
    with pytest.raises(ValueError, match="2\\^26"):
        sw_cuda.sw_align_fused_cuda(r, w, match=1 << 16)
    big = torch.full((1, sw_cuda.MAX_W + 1), PAD, dtype=torch.int8)
    with pytest.raises(ValueError, match="read width"):
        sw_cuda.sw_align_fused_cuda(big, big)


def test_cuda_wrapper_rejects_cpu_tensors():
    r = torch.full((2, 8), PAD, dtype=torch.int8)
    m = torch.ones((2, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        sw_cuda.sw_align_fused_cuda(r, r)
    with pytest.raises(ValueError, match="CUDA"):
        sw_cuda.sw_end_cuda(r, r, m, m)


@pytest.mark.parametrize("bad,err", [
    (dict(read_valid=torch.ones((2, 7), dtype=torch.bool)), ValueError),
    (dict(window_valid=torch.ones((3, 9), dtype=torch.bool)), ValueError),
    (dict(read_valid=torch.ones((2, 8), dtype=torch.int32)), TypeError),
    (dict(window_valid=torch.ones((2, 9), dtype=torch.float32)), TypeError),
    (dict(read_valid=torch.ones((8, 2), dtype=torch.bool).t()), ValueError),
    (dict(gap_open=-1), ValueError),
    (dict(gap_extend=-1), ValueError),
    (dict(match=1 << 23), ValueError),    # match * min(R, W) >= 2^26
])
def test_sw_end_cuda_rejects_bad_masks(bad, err):
    args = dict(reads=torch.zeros((2, 8), dtype=torch.int8),
                windows=torch.zeros((2, 9), dtype=torch.int8),
                read_valid=torch.ones((2, 8), dtype=torch.bool),
                window_valid=torch.ones((2, 9), dtype=torch.uint8))
    args.update(bad)
    with pytest.raises(err):
        sw_cuda.sw_end_cuda(**args)


def test_sw_end_device_cpu_route_is_plain():
    reads, wins = sw_inputs(9, 12, 40, 37)
    rv, wv = random_masks(3, reads, wins)
    before = (sw_cuda.launches, sw_cuda.end_launches)
    got = sw_cuda.sw_end_device(*map(torch.from_numpy,
                                     (reads, wins, rv, wv)))
    assert (sw_cuda.launches, sw_cuda.end_launches) == before
    want = jsw.sw_end(reads, wins, rv, wv)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("the SW kernel runs only on a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,lr", CASES + [
    (1000, 128, 101), (64, 101, 101), (22, 128, 101), (30, 128, 101),
    (4096, 128, 101), (300, 256, 250), (64, 1024, 1000), (64, 1152, 1100),
    (32, 2048, 2000), (16, 4096, 4090)])
def test_cuda_kernel_matches_plain(B, R, lr):
    _cuda_or_skip()
    reads, wins = sw_inputs(B + 7, B, R, lr)
    r = torch.from_numpy(reads).cuda()
    w = torch.from_numpy(wins).cuda()
    got = sw_cuda.sw_align_fused_cuda(r, w)
    torch.cuda.synchronize()
    want = tsw.sw_align_fused_plain(r, w)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGES, ids=str)
def test_cuda_kernel_matches_plain_edges(case):
    _cuda_or_skip()
    r, w = (torch.from_numpy(x).cuda() for x in edge_inputs(case))
    got = sw_cuda.sw_align_fused_cuda(r, w)
    torch.cuda.synchronize()
    assert torch.equal(got, tsw.sw_align_fused_plain(r, w))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("R", [1152, 2048, 4096])
def test_cuda_kernel_long_rows_match_plain(R, kind):
    _cuda_or_skip()
    reads, wins = long_rows(R, 64, R, kind)
    r, w = torch.from_numpy(reads).cuda(), torch.from_numpy(wins).cuda()
    got = sw_cuda.sw_align_fused_cuda(r, w)
    torch.cuda.synchronize()
    assert torch.equal(got, tsw.sw_align_fused_plain(r, w))
    rv, wv = random_masks(R, reads, wins)
    m = [torch.from_numpy(x).cuda() for x in (rv, wv)]
    got = sw_cuda.sw_end_cuda(r, w, *m)
    torch.cuda.synchronize()
    for g, x in zip(got, tsw.sw_end(r, w, *m)):
        assert torch.equal(g, x)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + ["period-3", "R=1"], ids=str)
def test_cuda_sw_end_matches_plain(case):
    _cuda_or_skip()
    reads, wins = all_inputs(case)
    rv, wv = random_masks(5, reads, wins)
    args = [torch.from_numpy(x).cuda() for x in (reads, wins, rv, wv)]
    args[3] = args[3].to(torch.uint8)
    got = sw_cuda.sw_end_cuda(*args)
    torch.cuda.synchronize()
    want = tsw.sw_end(*args[:3], args[3].bool())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
