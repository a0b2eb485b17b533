"""Negative-sample mining from genomic chimeric artifacts.

Re-design of ``prepare_negative`` / ``make_negative_file``
(functions.py:1393-1639): the reference scans a whole-genome BAM for reads
with SA:Z split tags, applies clip-complementarity and gene-pair filters,
rejects reads the linear genome explains, and extracts 201-char 'H'-junction
strings around the chimeric coordinates.

Here the SA-tag role is played by the k-mer engine's multi-hit output: a read
whose two strongest hits cover complementary halves of the read at two
distant gene loci is a chimeric artifact candidate.  All the reference's
pair filters are preserved:

  * clip complementarity within 5bp                   (functions.py:1460)
  * same-chromosome pairs < 10kb apart rejected        (:1469)
  * both genes annotated, distinct, not target genes   (:1473-1475)
  * IG*/ENSG*/3-letter-prefix sibling pairs rejected   (Inspect_name, :1402-1411)
  * known homolog pairs rejected                       (:1394-1400; NB the
    reference compares gene *names* against integer id lists, which can never
    match — we implement the intended check against a name->set mapping)
  * per-pair dedup with adjacency memory               (:1477-1490)
  * linear-genome rejection at ~0.8x modal read length (:1517-1522)

The multi-hit alignment runs on the genome aligner's device; the pair
filters and row extraction are host code, as in the JAX package.
:func:`mine_negative_junctions_sam` runs the same filters over the hits of
an external SAM/BAM instead, on the host only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
from anchored_fusion_tpu_torch.annotate.exon_walk import window_sequence
from anchored_fusion_tpu_torch.config import NEGATIVE_LINEARITY_PRESET
from anchored_fusion_tpu_torch.io.fasta import Reference


def _inspect_name(n1: str, n2: str) -> bool:
    """True when the pair must be rejected (Inspect_name parity)."""
    if n1.startswith("IG") or n2.startswith("IG"):
        return True
    if n1.startswith("ENSG") or n2.startswith("ENSG"):
        return True
    if len(n1) < 3 or len(n2) < 3:
        return False
    return n1[:3] == n2[:3]


class _MiningState:
    """Pair-filter/bookkeeping core of negative mining.

    :func:`mine_negative_junctions` feeds MultiHits chunks through
    :meth:`process`; :meth:`emit` then applies the global linear-genome
    rejection and extracts the junction rows.
    """

    def __init__(self, genome: Reference, index: ExonIndex,
                 targets: Set[str], homo_map: Dict[str, Set[str]],
                 clip_slack: int, min_locus_distance: int, max_rows: int):
        self.genome = genome
        self.index = index
        self.targets = targets
        self.homo_map = homo_map
        self.clip_slack = clip_slack
        self.min_locus_distance = min_locus_distance
        self.max_rows = max_rows
        self.last_genes: Set[str] = set()
        self.x_last = ""
        self.y_last: List[str] = []
        self.lengths: Dict[int, int] = {}
        self.picked: List[Tuple] = []
        # per-hit (rid, matches, length) triples for the global linear-genome
        # rejection pass (small: 12 B/hit vs the full MultiHits record)
        self.lin_parts: List[np.ndarray] = []
        self.capped = False

    def process(self, hits, read_lens: np.ndarray, chunk_lo: int):
        genome, index = self.genome, self.index
        clip_slack = self.clip_slack
        rid_arr = np.asarray(hits.read_id)
        self.lin_parts.append(np.stack([
            rid_arr + chunk_lo, np.asarray(hits.matches),
            np.asarray(hits.length)], axis=1).astype(np.int64))
        # hit->read grouping vectorized: a real sample produces millions of
        # multi-hits and a python dict sweep over them was the mining stage's
        # scale ceiling
        order = np.lexsort((-np.asarray(hits.score), rid_arr))
        rid_sorted = rid_arr[order]
        uniq_rids, first = np.unique(rid_sorted, return_index=True)
        counts = np.diff(np.append(first, len(rid_sorted)))
        for ui in np.nonzero(counts >= 2)[0]:
            lrid = int(uniq_rids[ui])
            rid = chunk_lo + lrid
            L = int(read_lens[lrid])
            own = order[first[ui]:first[ui] + counts[ui]]  # score-sorted

            # patterns: prefix hit (M+S) or suffix hit (S+M); interior fail
            def pattern(h):
                s, e = int(hits.q_start[h]), int(hits.q_end[h]) + 1
                if s <= clip_slack and e < L - clip_slack:
                    return "MS"
                if s > clip_slack and e >= L - clip_slack:
                    return "SM"
                return None
            X = int(own[0])
            px = pattern(X)
            if px is None:
                continue
            Y = py = None
            for cand in own[1:]:
                pc = pattern(int(cand))
                if pc is not None and pc != px:
                    Y, py = int(cand), pc
                    break
            if Y is None:
                continue
            xs, xe = int(hits.q_start[X]), int(hits.q_end[X]) + 1
            ys, ye = int(hits.q_start[Y]), int(hits.q_end[Y]) + 1
            l_X_M, l_Y_M = xe - xs, ye - ys
            l_Y_S = L - l_Y_M
            if abs(l_X_M - l_Y_S) > clip_slack:
                continue
            self.lengths[L] = self.lengths.get(L, 0) + 1
            x_chrom, x_pos1 = genome.to_local(int(hits.ref_start[X]))
            y_chrom, y_pos1 = genome.to_local(int(hits.ref_start[Y]))
            if (x_chrom == y_chrom
                    and abs(x_pos1 - y_pos1) < self.min_locus_distance):
                continue
            x_gene, _ = index.find_exon(x_chrom, x_pos1, x_pos1 + 1)
            y_gene, _ = index.find_exon(y_chrom, y_pos1, y_pos1 + 1)
            xn, yn = x_gene[1], y_gene[1]
            if xn.upper() in self.targets or yn.upper() in self.targets:
                continue
            if (xn == "" or yn == "" or xn == yn or _inspect_name(xn, yn)
                    or yn in self.homo_map.get(xn, ())):
                continue
            if ((xn == self.x_last and yn in self.y_last)
                    or (xn in self.y_last and yn == self.x_last)):
                continue
            pair, rpair = f"{xn}--{yn}", f"{yn}--{xn}"
            if pair in self.last_genes or rpair in self.last_genes:
                continue
            self.last_genes.add(pair)
            if xn == self.x_last:
                self.y_last.append(yn)
            elif yn == self.x_last:
                self.y_last.append(xn)
            else:
                self.x_last, self.y_last = xn, [yn]
            # junction coordinates, strand-normalized (functions.py:1491-1514)
            x_strand = "+" if hits.strand[X] == 0 else "-"
            y_strand = "+" if hits.strand[Y] == 0 else "-"
            y_plus = max(0, l_X_M - l_Y_S)
            x_left, x_right = x_pos1, x_pos1 + l_X_M
            y_left, y_right = y_pos1, y_pos1 + l_Y_M
            if px == "MS":
                g1 = (xn, x_chrom, x_right, x_strand)
                if y_strand == "+":
                    g2 = (yn, y_chrom, y_left + y_plus, y_strand)
                else:
                    g2 = (yn, y_chrom, y_right - y_plus, y_strand)
                if x_strand == "-":
                    g1, g2 = g2, g1
            else:  # px == 'SM'
                g2 = (xn, x_chrom, x_left, x_strand)
                if y_strand == "+":
                    g1 = (yn, y_chrom, y_right - y_plus, y_strand)
                else:
                    g1 = (yn, y_chrom, y_left, y_strand)
                if x_strand == "-":
                    g1, g2 = g2, g1
            self.picked.append((rid, g1, g2))
            if self.max_rows and len(self.picked) >= self.max_rows:
                self.capped = True
                break

    def emit(self, window: int) -> List[str]:
        # linear-genome rejection: any read with a near-full-length
        # high-identity hit is not a chimera (blat -minScore=0.8*modal_len
        # -minIdentity=90 -maxGap=1, functions.py:1517-1538;
        # NEGATIVE_LINEARITY_PRESET — its min_score resolves at runtime from
        # the modal read length, its maxGap=1 is structurally satisfied by
        # the ungapped extension engine)
        genome, index = self.genome, self.index
        modal = (max(self.lengths, key=self.lengths.get)
                 if self.lengths else 101)
        min_match = int(modal * 0.8)
        min_ident = NEGATIVE_LINEARITY_PRESET.min_identity
        lin = (np.concatenate(self.lin_parts, axis=0) if self.lin_parts
               else np.zeros((0, 3), np.int64))
        linear = (lin[:, 1] >= min_match) & (lin[:, 1] >= min_ident * lin[:, 2])
        bad: Set[int] = set(np.unique(lin[:, 0][linear]).tolist())
        rows: List[str] = []
        for rid, g1, g2 in self.picked:
            if rid in bad:
                continue
            n1, c1, p1, s1 = g1
            n2, c2, p2, s2 = g2
            l1, _r1 = window_sequence(genome, index, c1, int(p1), window,
                                      strand=s1)
            _l2, r2 = window_sequence(genome, index, c2, int(p2), window,
                                      strand=s2)
            if not l1 and not r2:
                continue
            rows.append("N" * (window - len(l1)) + l1 + "H" + r2
                        + "N" * (window - len(r2)) + "\t" + f"{n1}->{n2}")
        return rows


def mine_negative_junctions(
    genome_aligner,
    genome: Reference,
    index: ExonIndex,
    seqs: np.ndarray,              # (N, R) int8 whole-sample reads
    gene_names: Sequence[str],     # anchored target gene names (excluded)
    homo_map: Optional[Dict[str, Set[str]]] = None,
    clip_slack: int = 5,
    min_locus_distance: int = 10_000,
    window: int = 100,
    max_rows: int = 0,
    chunk_reads: int = 65_536,
    pair_depth: int = 6,
) -> List[str]:
    """Mine 201-char negative junction rows from a read batch.

    Streams the sample in ``chunk_reads``-read chunks (constant host/device
    memory at whole-sample scale — the reference sweeps the full genome BAM,
    functions.py:1425-1441, so must we).  ``max_rows`` bounds the output
    (0 = unlimited, the default — full-sweep parity).  ``pair_depth`` is the
    per-read multi-hit depth: the partner of the best hit is the
    highest-scoring OTHER hit with the complementary clip pattern (the role
    of bwa's primary + SA:Z supplementary pair), not merely the second-best.
    """
    seqs = np.asarray(seqs)
    N = seqs.shape[0]
    state = _MiningState(genome, index, {g.upper() for g in gene_names},
                         homo_map or {}, clip_slack, min_locus_distance,
                         max_rows)
    for chunk_lo in range(0, N, chunk_reads):
        if state.capped:
            break
        sub = seqs[chunk_lo:chunk_lo + chunk_reads]
        hits = genome_aligner.align_multi(sub, min_score=20, min_seg_len=20,
                                          top_k=pair_depth)
        state.process(hits, (sub != 5).sum(axis=1), chunk_lo)
    return state.emit(window)


def mine_negative_junctions_sam(
    sam_path: str,
    genome: Reference,
    index: ExonIndex,
    gene_names: Sequence[str],
    homo_map: Optional[Dict[str, Set[str]]] = None,
    clip_slack: int = 5,
    min_locus_distance: int = 10_000,
    window: int = 100,
    max_rows: int = 0,
) -> List[str]:
    """Mine negative junction rows from an EXTERNAL whole-genome alignment.

    The reference's filter setup consumes a pre-existing BAM and mines
    SA-tagged chimeras from it (functions.py:1425-1441); this is the
    equivalent ingestion path: ``sam_path`` may be SAM text or a BAM/BGZF
    archive (sniffed by magic), parsed into MultiHits
    (io/sam.py::multihits_from_sam — primary, secondary and supplementary
    records, deal_cigar-normalized), then the same pair-filter/linearity
    core as :func:`mine_negative_junctions` runs over it, so users with
    existing alignments skip the re-alignment.
    """
    from anchored_fusion_tpu_torch.io.sam import multihits_from_sam
    _names, read_lens, hits = multihits_from_sam(sam_path, genome)
    state = _MiningState(genome, index, {g.upper() for g in gene_names},
                         homo_map or {}, clip_slack, min_locus_distance,
                         max_rows)
    state.process(hits, read_lens, 0)
    return state.emit(window)
