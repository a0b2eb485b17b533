"""The port's small-reference aligners against the JAX package's, exactly.

Reads are sampled with numpy from a random reference on both strands, with
N bases, soft clips (junk heads and tails) and implanted indels, at odd and
even widths; ``align_to_reference`` runs with the port's chunk smaller than
the batch.  Every field of AlignmentResult and MultiHits must be equal.
"""

import dataclasses

import numpy as np
import pytest

from anchored_fusion_tpu.align import aligner as jal
from anchored_fusion_tpu.config import AlignConfig as JCfg
from anchored_fusion_tpu_torch.align import aligner as tal
from anchored_fusion_tpu_torch.config import AlignConfig as TCfg

PAD = 5
_RC = np.array([3, 2, 1, 0, 4, 5], np.int8)


def make_reads(seed, ref, B, R, read_len):
    """(B, R) int8 reads: half reverse-complemented, some clipped with junk,
    some with a 2-base deletion or insertion, N bases, a few pure junk."""
    rng = np.random.default_rng(seed)
    L = len(ref)
    out = np.full((B, R), PAD, np.int8)
    for b in range(B):
        s = int(rng.integers(0, L - read_len - 4))
        seq = ref[s:s + read_len + 4].copy()
        kind = b % 6
        p = int(rng.integers(20, read_len - 20))
        if kind == 1:
            seq = np.concatenate([seq[:p], seq[p + 2:]])
        elif kind == 2:
            seq = np.concatenate([seq[:p], rng.integers(0, 4, 2).astype(
                np.int8), seq[p:]])
        elif kind == 3:   # soft clip at the tail
            c = int(rng.integers(18, 40))
            seq[read_len - c:] = rng.integers(0, 4, len(seq) - read_len + c)
        elif kind == 4:   # soft clip at the head
            c = int(rng.integers(18, 40))
            seq[:c] = rng.integers(0, 4, c)
        elif kind == 5 and b % 4 == 1:
            seq = rng.integers(0, 4, len(seq)).astype(np.int8)
        seq = seq[:read_len]
        if b % 5 == 0:
            seq[int(rng.integers(0, read_len))] = 4
        if b % 2:
            seq = _RC[seq][::-1]
        out[b, :read_len] = seq
    return out


def _ref(seed, L):
    ref = np.random.default_rng(seed).integers(0, 4, L).astype(np.int8)
    ref[L // 3] = 4
    return ref


def assert_same_result(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, f.name)


@pytest.mark.parametrize("R,read_len,refine", [
    (128, 101, False), (128, 101, True), (75, 70, False), (75, 70, True)])
def test_align_to_reference_matches_jax(R, read_len, refine):
    ref = _ref(R, 1500)
    seqs = make_reads(R + read_len, ref, 150, R, read_len)
    want = jal.align_to_reference(seqs, ref, JCfg(gapped_refine=refine))
    got = tal.align_to_reference(seqs, ref, TCfg(gapped_refine=refine),
                                 chunk=64, device="cpu")
    assert want.mapped.sum() > 50 and (want.strand == 1).sum() > 20
    kind, _, _ = jal.classify_clips(want, (seqs != PAD).sum(1))
    assert ((kind == 2) | (kind == 3)).sum() > 5
    assert_same_result(got, want)


@pytest.mark.parametrize("R,stride", [(128, 1), (96, 3), (63, 3)])
def test_align_to_reference_multi_matches_jax(R, stride):
    ref = _ref(7 * R, 1200)
    seqs = make_reads(R, ref, 45, R, R - 10)
    kw = dict(min_score=20, min_identity=0.0, min_seg_len=12, top_k=8,
              stride=stride)
    want = jal.align_to_reference_multi(seqs, ref, **kw)
    got = tal.align_to_reference_multi(seqs, ref, device="cpu", **kw)
    assert len(want.score) > 45
    assert_same_result(got, want)


def test_orient_and_classify_match():
    ref = _ref(3, 900)
    seqs = make_reads(4, ref, 40, 128, 101)
    res = jal.align_to_reference(seqs, ref, JCfg(gapped_refine=False))
    np.testing.assert_array_equal(tal.orient_reads(seqs, res.strand),
                                  jal.orient_reads(seqs, res.strand))
    lens = (seqs != PAD).sum(1)
    tres = tal.AlignmentResult(**{f.name: getattr(res, f.name)
                                  for f in dataclasses.fields(res)})
    for g, w in zip(tal.classify_clips(tres, lens),
                    jal.classify_clips(res, lens)):
        np.testing.assert_array_equal(g, w)


def _orient_case_reads(R=16):
    """Rows of every length: PAD-padded, empty (all PAD) and full-width."""
    rng = np.random.default_rng(21)
    lens = np.array([0, 1, 5, R - 1, R, 9, R, 0, 3, 12, R, 7])
    seqs = np.full((len(lens), R), PAD, np.int8)
    for i, n in enumerate(lens):
        seqs[i, :n] = rng.integers(0, 5, n)
    return seqs


@pytest.mark.parametrize("strands,rows", [
    ("mixed", "all"), ("mixed", "sorted"), ("mixed", "unsorted_repeated"),
    ("mixed", "empty"), ("forward", "all"), ("forward", "unsorted_repeated"),
    ("reverse", "all"), ("reverse", "unsorted_repeated"), ("reverse", "empty"),
])
def test_orient_rows_equal_full_orientation_rows(strands, rows, monkeypatch):
    """``orient_reads(..., rows=r)`` is ``orient_reads(...)[r]`` and counts
    the rows it oriented (and the reversed among them) in its span."""
    from anchored_fusion_tpu_torch.utils import log
    seqs = _orient_case_reads()
    n = len(seqs)
    strand = {"mixed": np.arange(n) % 3 == 1,
              "forward": np.zeros(n, bool),
              "reverse": np.ones(n, bool)}[strands].astype(np.int8)
    r = {"all": np.arange(n), "sorted": np.array([0, 1, 3, 4, 7, 10]),
         "unsorted_repeated": np.array([10, 1, 4, 1, 0, 7, 4, 3]),
         "empty": np.zeros(0, np.int64)}[rows]
    full = tal.orient_reads(seqs, strand)
    sink = []
    monkeypatch.setattr(log, "_sink", sink)
    got = tal.orient_reads(seqs, strand, rows=r)
    assert got.shape == (len(r), seqs.shape[1]) and got.dtype == seqs.dtype
    np.testing.assert_array_equal(got, full[r])
    np.testing.assert_array_equal(seqs, _orient_case_reads())  # untouched
    sp, = sink
    assert sp["counts"] == {"rows": len(r), "reversed": int(strand[r].sum()),
                            "used": len(r)}


def test_refine_result_equals_refine_of_every_read_oriented():
    """refine_result, orienting the refined rows alone, gives the records
    of the JAX package's refine_alignments over the fully oriented batch,
    with the stage's thresholds applied, field by field."""
    from anchored_fusion_tpu.align.aligner import AlignmentResult as JRes
    from anchored_fusion_tpu.align.refine import (
        refine_alignments as j_refine_alignments)
    from anchored_fusion_tpu_torch.align.refine import (
        refinement_rows, refine_result)
    ref = _ref(5, 1500)
    seqs = make_reads(17, ref, 150, 128, 101)
    cfg = TCfg()
    res = tal.align_to_reference(seqs, ref, TCfg(gapped_refine=False),
                                 device="cpu")
    lens = (seqs != PAD).sum(1)
    sel = refinement_rows(res, lens, cfg)
    jres = JRes(**{k: np.array(v) for k, v in vars(res).items()})
    want = j_refine_alignments(jres, jal.orient_reads(seqs, res.strand),
                               lens, ref, JCfg())
    ident = want.matches / np.maximum(want.length, 1)
    want.mapped = ((want.score >= cfg.min_align_score)
                   & (want.length >= cfg.min_seg_len) & (ident >= 0.0))
    got = refine_result(res, seqs, ref, cfg, cfg.min_align_score, 0.0,
                        cfg.min_seg_len, device="cpu")
    better = got.score > res.score
    assert len(sel) < len(seqs) and better.sum() > 5
    assert (res.strand[better] == 1).sum() > 2
    for k in vars(want):
        np.testing.assert_array_equal(getattr(got, k),
                                      np.asarray(getattr(want, k)), k)


@pytest.mark.cuda
def test_align_on_cuda_launches_sw_kernel_and_matches_jax():
    import torch
    from anchored_fusion_tpu_torch.ops import sw_cuda
    if not torch.cuda.is_available():
        pytest.skip("the SW kernel runs only on a CUDA device")
    ref = _ref(128, 1500)
    seqs = make_reads(229, ref, 150, 128, 101)
    want = jal.align_to_reference(seqs, ref, JCfg(gapped_refine=True))
    before = sw_cuda.launches
    got = tal.align_to_reference(seqs, ref, TCfg(gapped_refine=True),
                                 chunk=64, device="cuda")
    assert sw_cuda.launches == before + 1
    assert_same_result(got, want)


def test_default_device_is_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tal.align_to_reference(np.full((1, 8), PAD, np.int8),
                               np.zeros(20, np.int8))
