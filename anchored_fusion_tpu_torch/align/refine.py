"""Gapped refinement of ungapped alignments.

The Kadane extension is exact for SNP-only reads; a read with an indel splits
its diagonal and the best ungapped segment covers only the longer side.  This
post-pass re-aligns the *suspicious* minority — mapped-ish reads whose
identity or span suggests a bridgeable gap — with the affine Smith-Waterman
over a widened window around their diagonal, and adopts the gapped
coordinates when they score strictly higher.  Both production aligners call
this via :func:`refine_result` (config-gated by ``AlignConfig.gapped_refine``).

The SW runs where the tensors live: on a CUDA device the hand-written kernel
(ops/sw_cuda.py), on the CPU its plain version.  ``matches`` of adopted
alignments are exact: a small packed-int64 numpy DP (:func:`path_matches`)
re-runs the same affine recurrence carrying the match count of the
best-scoring path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from anchored_fusion_tpu_torch.config import AlignConfig
from anchored_fusion_tpu_torch.ops.encode import PAD
from anchored_fusion_tpu_torch.ops.sw_cuda import sw_align_fused
from anchored_fusion_tpu_torch.align.aligner import AlignmentResult, orient_reads
from anchored_fusion_tpu_torch.utils.device import resolve_device
from anchored_fusion_tpu_torch.utils.log import count, span

def path_matches(reads: np.ndarray, wins: np.ndarray, match: int = 1,
                 mismatch: int = 4, gap_open: int = 6,
                 gap_extend: int = 1) -> np.ndarray:
    """Exact match counts of the best local affine-gap path per pair.

    Same recurrence and gap convention as ops/sw.sw_end (first gap base costs
    open+extend), run on host over packed int64 cells ``score*SC + matches``:
    every max() is then lexicographic (score first, match count as the
    tiebreak), so the count ALWAYS belongs to an optimal-score path.
    """
    n, R = reads.shape
    W = wins.shape[1]
    SC = np.int64(1) << 20
    NEG = np.int64(-1) << 40
    go = (gap_open + gap_extend) * SC
    ge = gap_extend * SC

    # Validity matches sw_end exactly: PAD-only.  N (code 4) is a VALID cell
    # scored as an ordinary mismatch.
    rvalid = reads != PAD
    wvalid = wins != PAD
    H = np.zeros((n, R), np.int64)
    E = np.full((n, R), NEG, np.int64)
    best = np.zeros(n, np.int64)
    k = np.arange(R, dtype=np.int64)[None, :]
    for j in range(W):
        wcol = wins[:, j:j + 1]
        eq = (reads == wcol) & (reads < 4) & rvalid & (wvalid[:, j:j + 1])
        s = np.where(eq, match * SC + 1, -np.int64(mismatch) * SC)
        s = np.where(rvalid & wvalid[:, j:j + 1], s, NEG)
        E = np.maximum(H - go, E - ge)
        diag = np.concatenate([np.zeros((n, 1), np.int64), H[:, :-1]], axis=1)
        HnoF = np.maximum(np.maximum(diag + s, E), 0)
        g = HnoF - go + (k + 1) * ge
        gmax = np.maximum.accumulate(g, axis=1)
        F = np.concatenate([np.full((n, 1), NEG), gmax[:, :-1]], axis=1) - k * ge
        H = np.maximum(HnoF, F)
        best = np.maximum(best, H.max(axis=1))
    return (best & (SC - 1)).astype(np.int32)


def extract_windows(ref_codes: np.ndarray, win_start: np.ndarray,
                    W: int) -> np.ndarray:
    """Gather (n, W) windows at ``win_start`` with PAD outside the reference."""
    ref_codes = np.asarray(ref_codes, np.int8)
    L = len(ref_codes)
    idx = np.asarray(win_start, np.int64)[:, None] + np.arange(W)[None, :]
    valid = (idx >= 0) & (idx < L)
    out = np.full(idx.shape, PAD, np.int8)
    out[valid] = ref_codes[idx[valid]]
    return out


def select_for_refinement(res: AlignmentResult, read_lens: np.ndarray,
                          min_score: int = 20, max_identity: float = 0.97,
                          min_tail: int = 8) -> np.ndarray:
    """Indices worth a gapped pass: mapped-ish but imperfect alignments that
    still leave >= min_tail unaligned bases on some side."""
    lens = np.asarray(read_lens)
    tail = (res.read_start + (lens - 1 - res.read_end))
    cand = (res.score >= min_score) & (
        (res.identity < max_identity) | (tail >= min_tail))
    return np.nonzero(cand)[0]


def refinement_rows(res: AlignmentResult, read_lens: np.ndarray,
                    cfg: AlignConfig) -> np.ndarray:
    """The rows refine_alignments tries: suspicious = near-threshold-or-
    better score with imperfect identity or a meaningful unaligned tail;
    gap bridging can only add score, so 0.8*T catches every rescuable
    indel read."""
    return select_for_refinement(res, read_lens,
                                 min_score=int(cfg.min_align_score * 0.8))


def refine_alignments(
    res: AlignmentResult,
    seqs: np.ndarray,              # (N, R) raw reads, as sequenced
    read_lens: np.ndarray,
    ref_codes: np.ndarray,
    cfg: Optional[AlignConfig] = None,
    band: Optional[int] = None,
    device="cuda",
    sel: Optional[np.ndarray] = None,
) -> AlignmentResult:
    """Return a copy of ``res`` with gapped coordinates where SW wins;
    ``sel``: the rows to try (``refinement_rows`` by default), the only
    ones oriented by ``res.strand``."""
    device = resolve_device(device)
    cfg = cfg or AlignConfig()
    band = band or cfg.band_half_width
    if sel is None:
        sel = refinement_rows(res, read_lens, cfg)
    if len(sel) == 0:
        return res
    R = seqs.shape[1]
    W = R + 2 * band
    L = len(ref_codes)
    # window start so the current segment sits centered with +-band slack
    diag = res.ref_start[sel] - res.read_start[sel]
    win_start = np.asarray(diag, np.int64) - band
    reads = np.ascontiguousarray(orient_reads(seqs, res.strand, rows=sel),
                                 np.int8)
    wins = extract_windows(ref_codes, win_start, W)
    with span("refine.sw", pairs=len(sel)):
        out = sw_align_fused(
            torch.from_numpy(reads).to(device),
            torch.from_numpy(wins).to(device), cfg.match_score,
            cfg.mismatch_penalty, cfg.gap_open, cfg.gap_extend).cpu().numpy()
    score, er, ej, sr, sj = out
    better = score > res.score[sel]
    idx = sel[better]
    new = AlignmentResult(**{f: np.array(getattr(res, f))
                             for f in ("score", "strand", "read_start",
                                       "read_end", "ref_start", "ref_end",
                                       "matches", "length", "second_score",
                                       "mapped")})
    if len(idx):
        new.score[idx] = score[better]
        new.read_start[idx] = sr[better]
        new.read_end[idx] = er[better]
        new.ref_start[idx] = np.clip(win_start[better] + sj[better], 0, L - 1)
        new.ref_end[idx] = np.clip(win_start[better] + ej[better], 0, L - 1)
        new.length[idx] = er[better] - sr[better] + 1
        # exact matches of the adopted gapped paths (real identity downstream)
        new.matches[idx] = path_matches(
            reads[better], wins[better],
            cfg.match_score, cfg.mismatch_penalty, cfg.gap_open,
            cfg.gap_extend)
    return new


def refine_result(res: AlignmentResult, seqs: np.ndarray,
                  ref_codes: np.ndarray, cfg: AlignConfig,
                  min_score: int, min_identity: float,
                  min_seg_len: int, device="cuda") -> AlignmentResult:
    """Config-gated gapped post-pass shared by both production aligners.

    Refines on ``device`` the rows ``refinement_rows`` picks (oriented,
    those alone), and re-applies the stage's mapping thresholds (an indel
    read can cross them only after its gap is bridged).
    """
    device = resolve_device(device)
    if not len(seqs):
        return res
    seqs = np.asarray(seqs)
    lens = (seqs != PAD).sum(axis=1)
    sel = refinement_rows(res, lens, cfg)
    count("anchor.refine", rows_refined=len(sel))
    new = refine_alignments(res, seqs, lens, ref_codes, cfg, device=device,
                            sel=sel)
    ident = new.matches / np.maximum(new.length, 1)
    new.mapped = ((new.score >= min_score) & (new.length >= min_seg_len)
                  & (ident >= min_identity))
    return new
