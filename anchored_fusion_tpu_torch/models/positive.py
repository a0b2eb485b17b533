"""Positive training rows from a curated known-fusion table.

Parity with ``utils/make_real_fusion_seq.py``: for each curated fusion (5'
gene at breakpoint, 3' gene at breakpoint, with strands), exon-walk +-100bp
around each breakpoint and emit the 201-char 'H'-junction string
``Npad(left5') + H + right3' + Npad`` tab-joined with the fusion name.

Input rows are (fusion_name, (chrom1, pos1, strand1), (chrom2, pos2, strand2))
— parsed from a STAR-Fusion-style TSV by :func:`parse_fusion_tsv` (column
layout of utils/make_real_fusion_seq.py:166-186).  Host code only.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
from anchored_fusion_tpu_torch.annotate.exon_walk import window_sequence
from anchored_fusion_tpu_torch.io.fasta import Reference

FusionRow = Tuple[str, Tuple[str, int, str], Tuple[str, int, str]]


def parse_fusion_tsv(path: str) -> List[FusionRow]:
    """STAR-Fusion-like TSV: col 0 'A->B', cols 20/21 '...^chrom:pos:strand';
    rows repeating (col 0, col 7, col 9) are dropped."""
    rows: List[FusionRow] = []
    seen = set()
    with open(path) as fh:
        for line in fh.readlines()[1:]:
            arr = line.rstrip("\n").split("\t")
            if len(arr) < 22:
                continue
            key = arr[0] + "$" + arr[7] + "$" + arr[9]
            if key in seen:
                continue
            seen.add(key)
            g1 = arr[20].split("^")[1].split(":")
            g2 = arr[21].split("^")[1].split(":")
            rows.append((arr[0],
                         ("chr" + g1[0], int(g1[1]), g1[2]),
                         ("chr" + g2[0], int(g2[1]), g2[2])))
    return rows


def build_positive_junctions(
    rows: Iterable[FusionRow],
    genome: Reference,
    index: ExonIndex,
    window: int = 100,
) -> List[str]:
    """One 'H'-junction row per fusion whose window has any sequence."""
    out: List[str] = []
    for fusion_name, (c1, p1, s1), (c2, p2, s2) in rows:
        left1, _ = window_sequence(genome, index, c1, p1, window, strand=s1)
        _, right2 = window_sequence(genome, index, c2, p2, window, strand=s2)
        if not left1 and not right2:
            continue
        out.append("N" * (window - len(left1)) + left1 + "H" + right2
                   + "N" * (window - len(right2)) + "\t" + fusion_name)
    return out
