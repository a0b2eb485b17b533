"""The anchored aligner's two kernels (csrc/anchor.cu) and their plain
versions (ops/anchor.py) against the JAX package, exactly.

On the CPU the plain decomposition — ``seed_block_max_plain`` with the
stable block top-k, ``extend_fold_plain`` in block mode and in offsets
mode, and ``_align_core`` built from them — runs on numpy-seeded inputs
beside the JAX package's ``_block_topk_diagonals``, ``extend_diagonals`` +
``fold_strands`` and ``_align_core``: every integer output must be equal.
The cases cover read widths 128, 160 and 320 (bfloat16 rounding of counts
past 256), stride 2, k 1, 4 and 8, references with fewer 128-diagonal
blocks than k, D on and off a multiple of 128, all-PAD and all-N rows,
tie-heavy reads on a periodic reference, and the genome engines' offsets
on a prepadded reference.  On a card (marked ``cuda``) both kernels are
held equal to their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anchored_fusion_tpu.align import aligner as jal
from anchored_fusion_tpu.ops import diagonal as jdiag
from anchored_fusion_tpu_torch.align import aligner as tal
from anchored_fusion_tpu_torch.ops import anchor, anchor_cuda
from anchored_fusion_tpu_torch.ops.encode import one_hot

PAD, N_CODE = 5, 4
_RC = np.array([3, 2, 1, 0, 4, 5], np.int8)
MATCH, MISMATCH = 1, 4
EMPTY_DIAG = -(2 ** 30) // 2     # align/genome.py's empty vote slot

# (id, reference length, row width R, read length, stride, k, kind)
CASES = [
    ("R128", 1500, 128, 101, 1, 4, "mixed"),
    ("R160", 1500, 160, 150, 1, 4, "mixed"),
    ("R320-bf16", 2000, 320, 320, 1, 4, "mixed"),
    ("stride2", 1500, 128, 101, 2, 4, "mixed"),
    ("stride2-R101", 1200, 101, 101, 2, 8, "mixed"),
    ("k1", 1500, 128, 101, 1, 1, "mixed"),
    ("k8", 1500, 128, 101, 1, 8, "mixed"),
    ("nb<k", 200, 128, 101, 1, 4, "mixed"),
    ("nb<k-k8", 200, 128, 101, 1, 8, "mixed"),
    ("D%128==0", 897, 128, 101, 1, 4, "mixed"),
    ("ties", 1500, 128, 101, 1, 4, "ties"),
    ("ties-R320", 1500, 320, 300, 1, 8, "ties"),
    ("genome", 3000, 128, 101, 1, 4, "genome"),
    ("genome-k8-R160", 3000, 160, 150, 1, 8, "genome"),
]


def make_reference(rng, L: int, kind: str) -> np.ndarray:
    if kind == "ties":
        # a short unit repeated: many diagonals and blocks tie exactly
        unit = rng.integers(0, 4, 12).astype(np.int8)
        ref = np.tile(unit, -(-L // 12))[:L].copy()
        ref[rng.integers(0, L, L // 100)] = rng.integers(0, 4, L // 100)
        return ref
    ref = rng.integers(0, 4, L).astype(np.int8)
    ref[rng.integers(0, L, 3)] = N_CODE
    return ref


def make_reads(rng, ref: np.ndarray, B: int, R: int, read_len: int):
    """Reads copied from the reference on both strands (clipped by the
    reference's ends, with SNPs and N bases), junk reads, one all-PAD row
    and one all-N row."""
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
    out[1, :read_len] = N_CODE
    return out


def inputs(case):
    name, L, R, read_len, stride, k, kind = case
    rng = np.random.default_rng(sum(map(ord, name)))
    ref = make_reference(rng, L, kind)
    reads = make_reads(rng, ref, 96, R, read_len)
    return ref, reads, stride, k, kind


def jax_records(d) -> dict:
    return {n: np.asarray(v) for n, v in d.items()}


def assert_records_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for n in want:
        g = got[n].numpy() if isinstance(got[n], torch.Tensor) else got[n]
        np.testing.assert_array_equal(g, want[n], n)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_anchor_plain_matches_jax(case):
    ref, reads, stride, k, kind = inputs(case)
    R = reads.shape[1]
    cpu = torch.device("cpu")
    jflat, jco = jal.both_strands(jnp.asarray(reads))
    flat, co = tal.both_strands(torch.from_numpy(reads))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(co.numpy(), np.asarray(jco))

    if kind == "genome":
        # offsets mode: the genome engines' voted offsets, empty slots and
        # offsets past both ends, on a reference prepadded with P codes
        P = R + 9
        refp = np.concatenate([np.full(P, PAD, np.int8), ref,
                               np.full(P, PAD, np.int8)])
        rng = np.random.default_rng(k)
        offs = rng.integers(-R - 20, len(ref) + 20,
                            (flat.shape[0], k)).astype(np.int32)
        # the best diagonal of each row as the anchored seeding finds it
        seed, _ = tal._seed_matrix_cached(ref, R, 1, cpu)
        best = anchor.block_topk_plain(
            *anchor.seed_block_max_plain(flat, seed.f32), 1, seed.diagonals)
        offs[:, k // 2] = best[:, 0].numpy() - (R - 1)
        offs[::5, -1] = EMPTY_DIAG
        offs[::3, 0] = offs[::3, k // 2]       # duplicated candidates
        got = anchor.extend_fold_plain(flat, co, torch.from_numpy(refp), P,
                                       MATCH, MISMATCH, k,
                                       offs=torch.from_numpy(offs))
        cand = jal.extend_diagonals(jflat, jnp.asarray(refp),
                                    jnp.asarray(offs), MATCH, MISMATCH,
                                    ref_prepad=P)
        want = jax_records(jal.fold_strands(cand, reads.shape[0], jco))
        assert_records_equal(got, want)
        assert (want["score"] > 30).sum() > 5
        return

    seed, refp = tal._seed_matrix_cached(ref, R, stride, cpu)
    jW, jW2 = jal._seed_matrix_cached(ref, R, stride)
    D = len(ref) + R - 1
    assert seed.diagonals == D and seed.positions == -(-R // stride)
    np.testing.assert_array_equal(refp.unfold(0, R, 1).numpy(),
                                  np.asarray(jW2))
    # the kernel's int8 operand is the patch matrix, transposed and padded
    K = 4 * seed.positions
    assert seed.i8.shape == (-(-D // 128) * 128, -(-K // 128) * 128)
    np.testing.assert_array_equal(seed.i8[:D, :K].t().numpy(),
                                  seed.f32.numpy().astype(np.int8))
    assert not seed.i8[D:].any() and not seed.i8[:, K:].any()

    # seeding: block maxima and lanes, then the stable top-k
    bmax, lane = anchor.seed_block_max_plain(flat, seed.f32, stride)
    onehot = one_hot(flat[:, ::stride], torch.float64).reshape(len(flat), -1)
    exact = onehot @ seed.i8[:, :K].t().to(torch.float64)
    b2, l2 = anchor.block_max_plain(exact[:, :D])
    assert torch.equal(bmax, b2) and torch.equal(lane, l2)
    if R >= 300:
        assert (bmax > 256).any()   # counts rounded through bfloat16
    counts = jdiag.diag_match_counts_w(jflat, jW, stride=stride)
    jidx = np.asarray(jal._block_topk_diagonals(counts, k))
    idx = anchor.block_topk_plain(bmax, lane, k, D)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(tal._block_topk_diagonals(
        tal.diag_match_counts_w(flat, seed.f32, stride), k).numpy(), jidx)

    # extension and fold in block mode, and the whole core
    got = anchor.extend_fold_plain(flat, co, refp, R, MATCH,
                                   MISMATCH, k, bmax=bmax, lane=lane, D=D)
    cand = jal.extend_diagonals(jflat, jnp.asarray(ref),
                                jnp.asarray(jidx) - (R - 1),
                                MATCH, MISMATCH, win_matrix=jW2)
    want = jax_records(jal.fold_strands(cand, reads.shape[0], jco))
    assert_records_equal(got, want)
    core = tal._align_core(torch.from_numpy(reads), seed, refp, k, MATCH,
                           MISMATCH, stride)
    jcore = jax_records(jal._align_core(jnp.asarray(reads), jnp.asarray(ref),
                                        jW, jW2, k, MATCH, MISMATCH, stride))
    assert_records_equal(core, jcore)
    for n in jcore:
        assert core[n].dtype == {"strand": torch.int8}.get(n, torch.int32), n
    assert (jcore["score"] > 30).sum() > 20
    if kind == "ties":
        assert (jcore["second_score"] == jcore["score"]).sum() > 10


def test_wrappers_run_plain_on_cpu_and_check_inputs():
    ref, reads, stride, k, _ = inputs(CASES[0])
    seed, refp = tal._seed_matrix_cached(ref, reads.shape[1], stride,
                                            torch.device("cpu"))
    flat, co = tal.both_strands(torch.from_numpy(reads))
    before = (anchor_cuda.seed_launches, anchor_cuda.fold_launches)
    bmax, lane = anchor_cuda.seed_block_max(flat, seed, stride)
    rec = anchor_cuda.extend_fold(flat, co, refp, reads.shape[1],
                                  MATCH, MISMATCH, k, bmax=bmax, lane=lane,
                                  D=seed.diagonals)
    assert (anchor_cuda.seed_launches, anchor_cuda.fold_launches) == before
    assert rec["score"].shape == (reads.shape[0],)
    with pytest.raises(ValueError, match="CUDA"):
        anchor_cuda.seed_block_max_cuda(flat, seed, stride)
    with pytest.raises(ValueError, match="CUDA"):
        anchor_cuda.extend_fold_cuda(flat, co, refp, reads.shape[1],
                                     MATCH, MISMATCH, k, bmax=bmax,
                                     lane=lane, D=seed.diagonals)
    with pytest.raises(ValueError, match="prepad"):
        anchor_cuda.extend_fold(flat, co, refp, 16, MATCH, MISMATCH,
                                k, bmax=bmax, lane=lane, D=seed.diagonals)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_anchor_kernels_match_plain_on_cuda(case):
    if not torch.cuda.is_available():
        pytest.skip("the anchored kernels run only on a CUDA device")
    ref, reads, stride, k, kind = inputs(case)
    R = reads.shape[1]
    dev = torch.device("cuda")
    flat, co = tal.both_strands(torch.from_numpy(reads).to(dev))
    if kind == "genome":
        P = R + 9
        refp = torch.from_numpy(np.concatenate(
            [np.full(P, PAD, np.int8), ref, np.full(P, PAD, np.int8)])).to(dev)
        rng = np.random.default_rng(k)
        offs = rng.integers(-R - 20, len(ref) + 20,
                            (flat.shape[0], k)).astype(np.int32)
        seed, _ = tal._seed_matrix_cached(ref, R, 1, dev)
        best = anchor.block_topk_plain(
            *anchor.seed_block_max_plain(flat, seed.f32), 1, seed.diagonals)
        offs[:, k // 2] = best[:, 0].cpu().numpy() - (R - 1)
        offs[::5, -1] = EMPTY_DIAG
        offs = torch.from_numpy(offs).to(dev)
        got = anchor_cuda.extend_fold_cuda(flat, co, refp, P, MATCH,
                                           MISMATCH, k, offs=offs)
        want = anchor.extend_fold_plain(flat, co, refp, P, MATCH, MISMATCH,
                                        k, offs=offs)
    else:
        seed, refp = tal._seed_matrix_cached(ref, R, stride, dev)
        bmax, lane = anchor_cuda.seed_block_max_cuda(flat, seed, stride)
        torch.cuda.synchronize()
        pb, pl = anchor.seed_block_max_plain(flat, seed.f32, stride)
        assert torch.equal(bmax, pb) and torch.equal(lane, pl)
        got = anchor_cuda.extend_fold_cuda(
            flat, co, refp, R, MATCH, MISMATCH, k, bmax=bmax,
            lane=lane, D=seed.diagonals)
        want = anchor.extend_fold_plain(flat, co, refp, R, MATCH,
                                        MISMATCH, k, bmax=pb, lane=pl,
                                        D=seed.diagonals)
    torch.cuda.synchronize()
    for n in want:
        assert got[n].dtype == want[n].dtype, n
        assert torch.equal(got[n], want[n]), n
