"""Batched read alignment against an in-memory reference.

One engine for every small-reference alignment of the pipeline (reads vs
the anchored transcript, consensus vs candidate regions):

  1. **Seed** — exact match counts on *every* diagonal as one one-hot
     matrix product, reduced to each 128-diagonal block's maximum
     (ops/anchor_cuda.py::seed_block_max).  Both strands.
  2. **Extend** — for the top-K diagonals, gather the reference window and run
     the Kadane maximal-segment scan with bwa-mem scoring (+1/-4): soft-clip
     boundaries identical to ungapped bwa-mem extension; then the strand
     fold (ops/anchor_cuda.py::extend_fold).
  3. **Refine** (optional) — affine-gap Smith-Waterman over widened windows
     (align/refine.py) for indel-containing reads.

Coordinates follow SAM conventions: for '-'-strand hits, read coordinates are
in the reverse-complemented read, so the soft-clip algebra downstream
(call/breakpoints.py) is the same for both strands.

Tie order is part of the result: top-k keeps the lower index on a tie, the
best-candidate sort is stable, and every arg-max takes the first occurrence.
Counts pass through bfloat16 before selection, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from anchored_fusion_tpu_torch.config import AlignConfig
from anchored_fusion_tpu_torch.ops.encode import PAD, revcomp
from anchored_fusion_tpu_torch.ops import anchor_cuda
from anchored_fusion_tpu_torch.ops.anchor import (
    SeedPatch, block_max_plain, block_topk_plain, pad_reference, seed_patch)
from anchored_fusion_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class AlignmentResult:
    """Struct-of-arrays alignment records (host-side numpy).

    All coordinates 0-based; read coords are in the oriented (strand-applied)
    read; ``ref_start``/``ref_end`` inclusive.  ``mapped`` applies the score
    and length thresholds of the preset used.
    """

    score: np.ndarray       # (B,) int32
    strand: np.ndarray      # (B,) int8  0='+', 1='-'
    read_start: np.ndarray  # (B,) int32
    read_end: np.ndarray    # (B,) int32
    ref_start: np.ndarray   # (B,) int64
    ref_end: np.ndarray     # (B,) int64
    matches: np.ndarray     # (B,) int32
    length: np.ndarray      # (B,) int32 (aligned read-span length)
    second_score: np.ndarray  # (B,) int32
    mapped: np.ndarray      # (B,) bool

    @property
    def identity(self) -> np.ndarray:
        return self.matches / np.maximum(self.length, 1)


RESULT_FIELDS = ("score", "strand", "read_start", "read_end", "matches",
                 "length", "second_score", "ref_start", "ref_end")

# Genome-scale references are stored prepadded with this many PAD codes on
# each side so diagonal extension can gather windows without a PAD-guarded
# copy of the genome.  Must be >= the widest query batch (junction consensus
# batches reach 512).
REF_PREPAD = 768

# Reference patch matrices are reference-dependent but batch-independent;
# cached by content digest (an id()-keyed cache could serve a stale matrix
# for a different reference after garbage collection).
_SEED_CACHE: dict = {}


def _ref_digest(ref_codes: np.ndarray) -> bytes:
    a = np.ascontiguousarray(np.asarray(ref_codes, np.int8))
    return hashlib.blake2b(a.tobytes(), digest_size=16).digest()


def _seed_matrix_cached(ref_codes: np.ndarray, read_len: int, stride: int,
                        device: torch.device):
    """(SeedPatch, the reference PAD-extended by R codes each side) for a
    small reference, cached."""
    key = (_ref_digest(ref_codes), read_len, stride, str(device))
    Ws = _SEED_CACHE.get(key)
    if Ws is None:
        Ws = (seed_patch(ref_codes, read_len, device, stride=stride),
              pad_reference(ref_codes, read_len, device))
        if len(_SEED_CACHE) > 16:
            _SEED_CACHE.clear()
        _SEED_CACHE[key] = Ws
    return Ws


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis, lower index first on ties (lax.top_k order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def both_strands(reads: torch.Tensor):
    """(B, R) -> ((2B, R) oriented reads, (2B,) int32 coordinate offsets).

    Forward half then reverse-complement half.  The reverse complement is a
    flip plus arithmetic complement, which leaves the PAD run at the FRONT of
    each reverse row; the per-row pad width is returned as a coordinate
    offset that the strand fold (ops/anchor.py::fold_strands) subtracts
    from read coordinates.
    """
    B, R = reads.shape
    lens = (reads != PAD).sum(dim=1)
    flat = torch.cat([reads, revcomp(reads)], dim=0)
    coord_off = torch.cat([torch.zeros(B, dtype=torch.int32, device=reads.device),
                           (R - lens).to(torch.int32)], dim=0)
    return flat, coord_off


def extend_diagonals_all(flat: torch.Tensor, ref: torch.Tensor,
                         offs: torch.Tensor, match: int, mismatch: int,
                         ref_prepad: int) -> dict:
    """Kadane extension of every candidate diagonal (multi-hit, BLAT-like).

    Args:
      flat: (N, R) oriented reads.
      ref:  (L,) reference codes, already ``[PAD*P, genome, PAD*P]`` with
        ``ref_prepad=P`` (a small reference: pad_reference, P = R).
      offs: (N, k) int32 candidate ref offsets of read position 0 per read
        (genome frame, i.e. NOT including the prepad).
    Returns dict of (N, k): score, start, end, matches, length — read-frame
    coordinates of each candidate's best segment.  The extension kernel's
    segments mode on CUDA tensors (ops/anchor_cuda.py::extend_segments),
    its plain version on CPU tensors.
    """
    R = flat.shape[1]
    # window for offset o covers genome [o, o+R) = ref[o+P : o+P+R]; R <= P
    # keeps every clipped window inside PAD
    if R > ref_prepad:
        raise ValueError(f"read width {R} exceeds ref_prepad {ref_prepad}")
    return anchor_cuda.extend_segments(flat, ref, ref_prepad, match,
                                       mismatch, offs=offs.contiguous())


def _block_topk_diagonals(counts: torch.Tensor, k: int,
                          block: int = 128) -> torch.Tensor:
    """Top-k diagonal indices by a two-level block reduction.

    Take the max of each 128-wide diagonal block, the top-k blocks, then the
    first arg-max lane inside each selected block.  Counts go through
    bfloat16 and the ragged last block pads with -1, as in the JAX package.
    """
    return block_topk_plain(*block_max_plain(counts, block), k,
                            counts.shape[1], block)


def _align_core(reads: torch.Tensor, seed: SeedPatch, refp: torch.Tensor,
                k: int, match: int, mismatch: int, stride: int = 1) -> dict:
    """Both-strand top-k diagonal seeding + Kadane extension: the seeding
    kernel's block maxima, then the extension kernel's block mode (plain
    versions on the CPU).

    Returns per-read dict (all (B,)): score, strand, read_start, read_end,
    ref_start, ref_end, matches, length, second_score.
    """
    R = reads.shape[1]
    flat, coord_off = both_strands(reads)                  # (2B, R)
    bmax, lane = anchor_cuda.seed_block_max(flat, seed, stride)
    return anchor_cuda.extend_fold(flat, coord_off, refp, R, match,
                                   mismatch, k, bmax=bmax, lane=lane,
                                   D=seed.diagonals)


@dataclasses.dataclass
class MultiHits:
    """Flat multi-hit records (BLAT-PSL-like), host-side numpy.

    ``q_start``/``q_end`` are 0-based inclusive in the FORWARD query frame
    (PSL convention: query coordinates are never strand-flipped).
    """

    read_id: np.ndarray    # (M,) int32 index into the query batch
    strand: np.ndarray     # (M,) int8
    score: np.ndarray      # (M,) int32
    matches: np.ndarray    # (M,) int32
    length: np.ndarray     # (M,) int32
    q_start: np.ndarray    # (M,) int32
    q_end: np.ndarray      # (M,) int32
    ref_start: np.ndarray  # (M,) int64
    ref_end: np.ndarray    # (M,) int64


def _align_multi_core(reads: torch.Tensor, seed: SeedPatch,
                      refp: torch.Tensor, k: int, match: int,
                      mismatch: int, stride: int = 1) -> dict:
    """Both-strand all-hits alignment against a small reference: the
    (2B, min(k, D)) segments of each oriented read's top k diagonals by
    bfloat16 match count (lower diagonal first on ties), with their
    offsets ``off``.  Two launches, as _align_core: the seeding kernel's
    top-k epilogue (each block's top k keys), then the extension kernel's
    segments mode selecting the row's top k from them (plain versions on
    the CPU)."""
    R = reads.shape[1]
    flat, _ = both_strands(reads)
    keys = anchor_cuda.seed_block_topk(flat, seed, stride, k)
    return anchor_cuda.extend_segments(flat, refp, R, match, mismatch,
                                       keys=keys, D=seed.diagonals, k=k)


def to_numpy(seg: dict) -> dict:
    return {n: v.cpu().numpy() for n, v in seg.items()}


def _flatten_multi(seg: dict, read_lens: np.ndarray, B: int, k: int,
                   min_score: int, min_identity: float, min_seg_len: int,
                   read_width: int) -> MultiHits:
    """(2B, k) candidates -> filtered flat MultiHits with PSL q-frame.

    Reverse-half rows come PAD-prefixed from :func:`both_strands`; their raw
    coordinates are shifted by the pad width into the left-aligned oriented
    frame before the forward-q-frame conversion (reference coordinates use
    the raw values and are unaffected).
    """
    score = np.asarray(seg["score"]).reshape(2, B, k)
    start = np.asarray(seg["start"]).reshape(2, B, k)
    end = np.asarray(seg["end"]).reshape(2, B, k)
    matches = np.asarray(seg["matches"]).reshape(2, B, k)
    length = np.asarray(seg["length"]).reshape(2, B, k)
    off = np.asarray(seg["off"]).reshape(2, B, k)
    lens = read_lens[None, :, None]
    ident = matches / np.maximum(length, 1)
    keep = (score >= min_score) & (length >= min_seg_len) & (ident >= min_identity)
    # dedup identical (strand, offset) candidates emerging from adjacent
    # diagonal seeds converging to the same segment
    srt = np.argsort(off, axis=2, kind="stable")
    off_s = np.take_along_axis(off, srt, 2)
    st_s = np.take_along_axis(start, srt, 2)
    dup = np.zeros_like(keep)
    dup[:, :, 1:] = (off_s[:, :, 1:] == off_s[:, :, :-1]) & (st_s[:, :, 1:] == st_s[:, :, :-1])
    undup = np.ones_like(keep)
    np.put_along_axis(undup, srt, ~dup, 2)
    keep &= undup
    s_idx, b_idx, _ = np.nonzero(keep)
    strand = s_idx.astype(np.int8)
    rs_raw, re_raw = start[keep], end[keep]
    ln = np.broadcast_to(lens, score.shape)[keep]
    pad = np.where(strand == 1, read_width - ln, 0)
    rs = rs_raw - pad
    re = re_raw - pad
    q_start = np.where(strand == 0, rs, ln - 1 - re)
    q_end = np.where(strand == 0, re, ln - 1 - rs)
    return MultiHits(
        read_id=b_idx.astype(np.int32),
        strand=strand,
        score=score[keep].astype(np.int32),
        matches=matches[keep].astype(np.int32),
        length=length[keep].astype(np.int32),
        q_start=q_start.astype(np.int32),
        q_end=q_end.astype(np.int32),
        ref_start=(off[keep] + rs_raw).astype(np.int64),
        ref_end=(off[keep] + re_raw).astype(np.int64),
    )


def align_to_reference_multi(
    seqs: np.ndarray,
    ref_codes: np.ndarray,
    cfg: Optional[AlignConfig] = None,
    min_score: int = 20,
    min_identity: float = 0.0,
    min_seg_len: int = 10,
    top_k: int = 8,
    stride: Optional[int] = None,
    device="cuda",
) -> MultiHits:
    """All-hits alignment against a small reference (one BLAT pass).

    ``stride`` is the seeding sample stride (pass the stage's
    StagePreset.step; defaults to cfg.seed_stride).
    """
    cfg = cfg or AlignConfig()
    device = resolve_device(device)
    seqs = np.asarray(seqs, dtype=np.int8)
    if seqs.ndim == 1:
        seqs = seqs[None]
    B, R = seqs.shape
    read_lens = (seqs != PAD).sum(axis=1).astype(np.int32)
    if stride is None:
        stride = cfg.seed_stride
    seed, refp = _seed_matrix_cached(ref_codes, R, stride, device)
    seg = to_numpy(_align_multi_core(
        torch.from_numpy(seqs).to(device), seed, refp, top_k,
        cfg.match_score, cfg.mismatch_penalty, stride))
    return _flatten_multi(seg, read_lens, B, top_k, min_score, min_identity,
                          min_seg_len, R)


def records_to_result(cat: dict, min_score: int, min_identity: float,
                      min_seg_len: int) -> AlignmentResult:
    """Host AlignmentResult from per-read fields, with the stage thresholds."""
    length = cat["length"]
    matches = cat["matches"]
    ident = matches / np.maximum(length, 1)
    mapped = (cat["score"] >= min_score) & (length >= min_seg_len) & (ident >= min_identity)
    return AlignmentResult(
        score=cat["score"].astype(np.int32),
        strand=cat["strand"].astype(np.int8),
        read_start=cat["read_start"].astype(np.int32),
        read_end=cat["read_end"].astype(np.int32),
        ref_start=cat["ref_start"].astype(np.int64),
        ref_end=cat["ref_end"].astype(np.int64),
        matches=matches.astype(np.int32),
        length=length.astype(np.int32),
        second_score=cat["second_score"].astype(np.int32),
        mapped=mapped,
    )


def concat_records(outs: list) -> dict:
    """Concatenate per-chunk device records and bring them to the host."""
    if not outs:
        return {n: np.zeros(0, np.int32) for n in RESULT_FIELDS}
    return {n: torch.cat([o[n] for o in outs]).cpu().numpy()
            for n in RESULT_FIELDS}


def align_to_reference(
    seqs: np.ndarray,
    ref_codes: np.ndarray,
    cfg: Optional[AlignConfig] = None,
    min_score: Optional[int] = None,
    min_identity: float = 0.0,
    min_seg_len: Optional[int] = None,
    top_k: Optional[int] = None,
    chunk: int = 8192,
    device="cuda",
    mesh=None,
) -> AlignmentResult:
    """Align a batch of encoded reads against one reference array.

    Chunks the batch (bounding the plain seeding's (2*chunk, L+R-1) count
    matrix on the CPU; the card's kernel keeps none), applies the stage thresholds, runs the gapped refinement when
    ``cfg.gapped_refine`` is set, and returns numpy struct-of-arrays.
    Results do not depend on ``chunk``.

    With ``mesh`` (parallel/mesh.py) each dp rank aligns and refines its
    rows of the batch on its ``device`` against the replicated reference,
    and every rank gets all records, all-gathered in read order: equal to
    the one-device result, since a record depends only on its read.
    """
    if mesh is not None:
        from anchored_fusion_tpu_torch.parallel.collectives import map_rows
        seqs = np.asarray(seqs, dtype=np.int8)
        return map_rows(mesh, seqs if seqs.ndim == 2 else seqs[None],
                        lambda s: align_to_reference(
                            s, ref_codes, cfg, min_score, min_identity,
                            min_seg_len, top_k, chunk, device))
    cfg = cfg or AlignConfig()
    device = resolve_device(device)
    if min_score is None:
        min_score = cfg.min_align_score
    if min_seg_len is None:
        min_seg_len = cfg.min_seg_len
    if top_k is None:
        top_k = cfg.top_diagonals
    seqs = np.asarray(seqs, dtype=np.int8)
    if seqs.ndim == 1:
        seqs = seqs[None]
    B, R = seqs.shape
    stride = cfg.seed_stride
    seed, refp = _seed_matrix_cached(ref_codes, R, stride, device)
    outs = []
    for lo in range(0, B, chunk):
        sub = torch.from_numpy(seqs[lo:lo + chunk]).to(device)
        outs.append(_align_core(sub, seed, refp, top_k, cfg.match_score,
                                cfg.mismatch_penalty, stride))
    res = records_to_result(concat_records(outs), min_score,
                            min_identity, min_seg_len)
    if cfg.gapped_refine:
        from anchored_fusion_tpu_torch.align.refine import refine_result
        res = refine_result(res, seqs, np.asarray(ref_codes), cfg,
                            min_score, min_identity, min_seg_len, device)
    return res


def orient_reads(seqs: np.ndarray, strands: np.ndarray) -> np.ndarray:
    """Apply per-read strand to raw read codes (SAM SEQ convention), batched.

    Revcomp of a right-padded row leaves its PAD run in front, so row i of
    the output reads ``rc[(j + R - len_i) % R]``.
    """
    seqs = np.asarray(seqs)
    strands = np.asarray(strands)
    R = seqs.shape[1]
    rev_rows = np.nonzero(strands == 1)[0]
    out = seqs.copy()
    if len(rev_rows):
        rc = revcomp(seqs[rev_rows])
        lens = (seqs[rev_rows] != PAD).sum(axis=1)
        idx = (np.arange(R)[None, :] + (R - lens[:, None])) % R
        out[rev_rows] = np.take_along_axis(rc, idx, axis=1)
    return out


def classify_clips(res: AlignmentResult, read_lengths: np.ndarray, min_clip: int = 1):
    """Soft-clip classification of each alignment in the oriented read.

    Returns (kind, left_clip, right_clip) where kind is:
      0 = unmapped, 1 = full-length M, 2 = SM (left clip), 3 = MS (right clip),
      4 = SMS (both sides clipped — excluded by the reference's 2-op rule).
    """
    read_lengths = np.asarray(read_lengths)
    left = res.read_start
    right = read_lengths - 1 - res.read_end
    left = np.where(res.mapped, left, 0)
    right = np.where(res.mapped, right, 0)
    kind = np.zeros(len(left), dtype=np.int8)
    lc = left >= min_clip
    rc = right >= min_clip
    kind = np.where(res.mapped & ~lc & ~rc, 1, kind)
    kind = np.where(res.mapped & lc & ~rc, 2, kind)
    kind = np.where(res.mapped & ~lc & rc, 3, kind)
    kind = np.where(res.mapped & lc & rc, 4, kind)
    return kind, left.astype(np.int32), right.astype(np.int32)
