"""Filter-inference input builder (get_test_reads parity, functions.py:1642-1721).

For each candidate fusion: the partner side is a +-100bp *exonic* window
around the partner breakpoint (spliced, strand-aware), the anchor side is
sliced directly from the anchored transcript string; both join into a 201-char
'H'-junction row, N-padded to 100+1+100:

  MS: anchor_left + H + partner_right
  SM: partner_left + H + anchor_right
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
from anchored_fusion_tpu_torch.annotate.exon_walk import window_sequence
from anchored_fusion_tpu_torch.call.candidates import Candidate
from anchored_fusion_tpu_torch.io.fasta import Reference


def build_test_rows(
    candidates: Sequence[Candidate],
    anchor_seq: str,
    genome: Reference,
    index: ExonIndex,
    window: int = 100,
) -> Tuple[List[str], List[int]]:
    """Returns (rows, candidate_index_per_row).

    Duplicate (breakpoint, partner locus) candidates collapse to one row
    (functions.py:1659-1661); the returned index maps rows back to candidates
    so scores can be re-attached.
    """
    rows: List[str] = []
    row_cand: List[int] = []
    seen = []
    for ci, cand in enumerate(candidates):
        pos, _ = cand.find_max_pos()
        tbp, chrom, obp, strand = pos[0], pos[1], pos[2], pos[3]
        type_ = cand.type_
        key = (tbp, chrom, obp, strand)
        if key in seen:
            continue
        seen.append(key)
        if (type_ == "SM" and strand == "+") or (type_ == "MS" and strand == "-"):
            qpos = obp + 1
        else:
            qpos = obp
        left2, right2 = window_sequence(genome, index, chrom, qpos, window,
                                        strand=strand)
        left1 = anchor_seq[tbp - min(window + 1, tbp): tbp - 1]
        right1 = anchor_seq[tbp - 1: min(tbp + window - 1, len(anchor_seq))]
        if type_ == "MS":
            row = ("N" * (window - len(left1)) + left1 + "H" + right2
                   + "N" * (window - len(right2)))
        else:
            row = ("N" * (window - len(left2)) + left2 + "H" + right1
                   + "N" * (window - len(right1)))
        rows.append(row)
        row_cand.append(ci)
    return rows, row_cand


def attach_scores(candidates: Sequence[Candidate], rows_cand: Sequence[int],
                  scores: Sequence[float]) -> List[float]:
    """Spread per-row scores back over the full candidate list (duplicates of
    a collapsed row share its score, matching the reference's per-candidate
    score list indexing, Anchored_Fusion.py:220-221)."""
    out = [0.0] * len(candidates)
    row_of = dict(zip(rows_cand, range(len(rows_cand))))
    # candidates that were deduped share the first equivalent row's score
    seen = {}
    for ci, cand in enumerate(candidates):
        pos, _ = cand.find_max_pos()
        key = (pos[0], pos[1], pos[2], pos[3])
        if ci in row_of:
            seen[key] = scores[row_of[ci]]
        out[ci] = seen.get(key, 0.0)
    return out
