"""Surrogate genome reconstruction from the bundled wgsim sample.

The reference's canonical end-to-end test (README.md:42) runs the bundled
FASTQ pair against hg38.  hg38 is not shipped with this package, but the
bundled reads were simulated with wgsim (utils/simulate_reads.py:20), whose
read names encode the exact fragment coordinates on the source transcript:

    @EU216071.1_708_934_3:0:0_0:0:0_0/1
      ^source      ^fwd-read 1-based start
                       ^rev-read 1-based end

That makes the six source fusion transcripts fully recoverable from the reads
alone: place every read at its named coordinates, resolve the one remaining
ambiguity (wgsim randomises WHICH mate is the forward read) with a two-pass
majority-vote EM, and take the per-position consensus.

From the recovered transcripts this module builds a *surrogate genome*:

  - the anchored gene (BCR) at its own locus, sequence = the anchored
    transcript itself;
  - the fusion partner (ABL1) at a separate locus, sequence = the recovered
    fusion transcript downstream of the junction (the junction is found by
    scoring the consensus against the anchor — no hard-coded breakpoint);
  - each decoy fusion transcript split at its midpoint into two gene loci on
    its own chromosome, >=10kb apart — linear decoy reads become genuine
    two-gene chimeras only at the artificial split, giving the negative miner
    (functions.py:1393-1441 parity) realistic whole-sample material.

This lets the FULL ten-stage pipeline (and the negative-mining -> filter
training path) run on the bundled sample, or any sample in wgsim's form,
without hg38.  Host numpy
only: the arrays, genes and GTF equal the JAX package's.

Run:  python -m anchored_fusion_tpu_torch.bench.surrogate --fastq1 r_1.fq.gz \
          --fastq2 r_2.fq.gz --anchor anchor.fa --out_prefix surrogate
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from anchored_fusion_tpu_torch.bench.simulate import SynthGene, SynthGenome, random_seq
from anchored_fusion_tpu_torch.io.fasta import Reference, reference_from_dict
from anchored_fusion_tpu_torch.io.fastq import ReadBatch
from anchored_fusion_tpu_torch.ops.encode import (
    BASE_N, N_REAL, decode_to_str, revcomp)

_WGSIM_NAME = re.compile(r"^(.+)_(\d+)_(\d+)_[^_]+_[^_]+_[0-9a-fA-F]+$")


def parse_wgsim_name(name: str) -> Optional[Tuple[str, int, int]]:
    """wgsim read name -> (source, fwd 1-based start, rev 1-based end)."""
    m = _WGSIM_NAME.match(name.split("/")[0])
    if not m:
        return None
    return m.group(1), int(m.group(2)), int(m.group(3))


def _vote(votes: np.ndarray, seqs: np.ndarray, starts: np.ndarray):
    """Scatter-add base votes: seqs (N, L) placed at starts (N,)."""
    n, rl = seqs.shape
    pos = starts[:, None] + np.arange(rl)[None, :]
    valid = (seqs >= 0) & (seqs < N_REAL) & (pos >= 0) & (pos < votes.shape[0])
    np.add.at(votes, (pos[valid], seqs[valid].astype(np.int64)), 1)


def _agree(seqs: np.ndarray, cons: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Per-read agreement count of seqs (N, L) vs consensus at starts (N,)."""
    rl = seqs.shape[1]
    pos = np.clip(starts[:, None] + np.arange(rl)[None, :], 0, len(cons) - 1)
    return ((seqs == cons[pos]) & (seqs < N_REAL)).sum(axis=1)


def reconstruct_transcripts(reads: ReadBatch) -> Dict[str, np.ndarray]:
    """Recover each source transcript's consensus codes from wgsim reads.

    wgsim places one forward read at ``start`` and one reverse-complemented
    read ending at ``end``, but randomises which mate is which.  Pass 1 votes
    BOTH configurations (every position still gets a strict majority of
    correct votes); pass 2 picks the better configuration per pair against
    the pass-1 consensus and re-votes.  Positions with zero coverage are N.
    """
    by_src: Dict[str, List[int]] = {}
    coords: List[Optional[Tuple[str, int, int]]] = []
    for i, name in enumerate(reads.names):
        c = parse_wgsim_name(name)
        coords.append(c)
        if c is not None:
            by_src.setdefault(c[0], []).append(i)

    out: Dict[str, np.ndarray] = {}
    R = reads.max_len
    for src, idx in by_src.items():
        idx = np.asarray(idx)
        s0 = np.asarray([coords[i][1] - 1 for i in idx])           # fwd start
        ends = np.asarray([coords[i][2] for i in idx])
        m1 = reads.seq[idx, 0]
        m2 = reads.seq[idx, 1]
        L = int(ends.max())
        votes = np.zeros((L, N_REAL), np.int64)
        # revcomp of a right-PAD-padded row leaves the PAD run at the FRONT:
        # an rc row's real bases sit at row indices R-len..R-1, so placing
        # row index 0 at ends-R puts them at ends-len..ends-1 for ANY mate
        # length (the PAD rows never vote: _vote masks codes >= N_REAL)
        r0 = ends - R
        rc1, rc2 = revcomp(m1), revcomp(m2)
        # pass 1: vote both configurations
        _vote(votes, m1, s0)
        _vote(votes, m2, s0)
        _vote(votes, rc1, r0)
        _vote(votes, rc2, r0)
        cons = np.where(votes.sum(1) == 0, BASE_N,
                        votes.argmax(1)).astype(np.int8)
        # pass 2: per-pair orientation by agreement with the pass-1 consensus
        score_a = _agree(m1, cons, s0) + _agree(rc2, cons, r0)
        score_b = _agree(m2, cons, s0) + _agree(rc1, cons, r0)
        a = score_a >= score_b
        votes[:] = 0
        _vote(votes, m1[a], s0[a])
        _vote(votes, rc2[a], r0[a])
        _vote(votes, m2[~a], s0[~a])
        _vote(votes, rc1[~a], r0[~a])
        out[src] = np.where(votes.sum(1) == 0, BASE_N,
                            votes.argmax(1)).astype(np.int8)
    return out


def locate_junction(cons: np.ndarray, anchor: np.ndarray,
                    probe_len: int = 24, step: int = 8,
                    ) -> Optional[Tuple[int, int]]:
    """Find (junction_in_cons, junction_in_anchor) for a fusion consensus
    whose 5' side matches a region of the anchored transcript.

    wgsim mutates the source haplotype (SNPs + indels), so a single global
    offset drifts along the transcript.  Instead, walk exact ``probe_len``-mer
    probes along the consensus recording where each hits the anchor; the last
    offset-consistent hit brackets the junction, and a local-offset fine scan
    places it at the argmax of cumsum(2*match - 1) — the split maximising
    matches before plus mismatches after.  Returns None when the consensus
    shares no probes with the anchor (a decoy transcript).
    """
    cov = np.nonzero(cons != BASE_N)[0]
    if not len(cov):
        return None
    a_str = decode_to_str(anchor)
    hits: List[Tuple[int, int]] = []  # (pos_in_cons, pos_in_anchor)
    for p in range(int(cov[0]), int(cov[-1]) - probe_len + 2, step):
        probe = cons[p:p + probe_len]
        if (probe == BASE_N).any():
            continue
        h = a_str.find(decode_to_str(probe))
        if h >= 0:
            hits.append((p, h))
    if len(hits) < 3:
        return None
    # last hit whose offset agrees with its predecessor (spurious-match guard)
    last = None
    for (p0, h0), (p1, h1) in zip(hits, hits[1:]):
        if abs((h1 - p1) - (h0 - p0)) <= 20:
            last = (p1, h1)
    if last is None:
        return None
    p, h = last
    d = h - p
    # fine scan with the junction-local offset: indels are ~1/7kb, so no
    # drift inside this short window
    lo = p
    hi = min(len(cons), len(anchor) - d, p + probe_len + 4 * step + 64)
    match = (cons[lo:hi] == anchor[d + lo:d + hi]).astype(np.int64)
    gain = np.cumsum(2 * match - 1)
    j = lo + int(np.argmax(gain)) + 1
    return j, j + d


def _unique_name(name: str, used: set) -> str:
    if name not in used:
        used.add(name)
        return name
    k = 1
    while f"{name}L{k}" in used:
        k += 1
    used.add(f"{name}L{k}")
    return f"{name}L{k}"


def build_surrogate_genome(
    anchor: np.ndarray,
    transcripts: Dict[str, np.ndarray],
    anchor_name: str = "BCR",
    partner_name: str = "ABL1",
    pad: int = 2500,
    decoy_gap: int = 12000,
    seed: int = 20260819,
) -> SynthGenome:
    """Assemble the surrogate genome + annotation from recovered transcripts.

    Returns a SynthGenome whose ``gtf_dic``/``gene_rows()`` plug straight into
    ExonIndex / FusionPipeline.  The fusion source is auto-detected as the one
    transcript whose 5' side matches the anchor (locate_junction).
    """
    rng = np.random.default_rng(seed)
    chroms: Dict[str, str] = {}
    genes: Dict[str, SynthGene] = {}
    gtf: Dict[str, List[List]] = {}
    used_names: set = set()

    def add_gene(chrom: str, name: str, seq: str, at: int) -> int:
        """Append a single-exon gene at 1-based position ``at``; return end+1."""
        gid = f"ENSG{len(genes):06d}.{name}"
        exons = [(at, at + len(seq) - 1)]
        genes[name] = SynthGene(name, chrom, "+", exons, gid)
        gtf.setdefault(chrom, []).append([at, at + len(seq) - 1, gid, name])
        return at + len(seq)

    # anchored gene locus (chr22 flavour: BCR's real chromosome)
    anchor_str = decode_to_str(anchor)
    chroms["chr22"] = (random_seq(rng, pad) + anchor_str + random_seq(rng, pad))
    add_gene("chr22", _unique_name(anchor_name, used_names), anchor_str, pad + 1)

    fusion_src = None
    for src, cons in transcripts.items():
        j = locate_junction(cons, anchor)
        if j is not None:
            fusion_src, (j_cons, j_anchor) = src, j
            cov = np.nonzero(cons != BASE_N)[0]
            part = decode_to_str(cons[j_cons:int(cov[-1]) + 1])
            chroms["chr9"] = random_seq(rng, pad) + part + random_seq(rng, pad)
            add_gene("chr9", _unique_name(partner_name, used_names), part,
                     pad + 1)
            break

    # decoys: split each at its midpoint into two loci on one chromosome
    di = 0
    for src, cons in sorted(transcripts.items()):
        if src == fusion_src:
            continue
        cov = np.nonzero(cons != BASE_N)[0]
        if not len(cov):
            continue
        seq = decode_to_str(cons[int(cov[0]):int(cov[-1]) + 1])
        mid = len(seq) // 2
        parts = src.replace(".", "-").split("-")
        n5 = _unique_name(parts[0] if parts[0] else f"DEC{di}A", used_names)
        n3 = _unique_name(parts[1] if len(parts) > 1 and parts[1]
                          else f"DEC{di}B", used_names)
        chrom = f"chrD{di}"
        end5 = add_gene(chrom, n5, seq[:mid], pad + 1)
        start3 = end5 + decoy_gap
        add_gene(chrom, n3, seq[mid:], start3)
        chroms[chrom] = (random_seq(rng, pad) + seq[:mid]
                         + random_seq(rng, decoy_gap) + seq[mid:]
                         + random_seq(rng, pad))
        di += 1

    genome = reference_from_dict(chroms)
    return SynthGenome(genome, genes, gtf)


def surrogate_from_sample(fastq1: str, fastq2: str, anchor_fasta: str,
                          **kw) -> Tuple[SynthGenome, ReadBatch, Reference]:
    """One-call helper: bundled sample paths -> (surrogate, reads, anchor)."""
    from anchored_fusion_tpu_torch.io.fastq import read_fastq_pair
    from anchored_fusion_tpu_torch.io.fasta import read_fasta
    reads = read_fastq_pair(fastq1, fastq2)
    anchor = read_fasta(anchor_fasta)
    transcripts = reconstruct_transcripts(reads)
    sg = build_surrogate_genome(anchor.seq, transcripts, **kw)
    return sg, reads, anchor


def main(argv=None) -> int:
    """CLI: write surrogate genome FASTA + GTF from a wgsim sample."""
    import argparse
    from anchored_fusion_tpu_torch.bench.simulate import write_gtf, write_fasta

    ap = argparse.ArgumentParser(
        prog="anchored-fusion-surrogate-torch",
        description="Reconstruct a surrogate genome+GTF from wgsim reads")
    ap.add_argument("--fastq1", required=True)
    ap.add_argument("--fastq2", required=True)
    ap.add_argument("--anchor", required=True, help="anchored-gene FASTA")
    ap.add_argument("--out_prefix", required=True)
    ap.add_argument("--anchor_name", default="BCR")
    ap.add_argument("--partner_name", default="ABL1")
    args = ap.parse_args(argv)

    sg, _, _ = surrogate_from_sample(args.fastq1, args.fastq2, args.anchor,
                                     anchor_name=args.anchor_name,
                                     partner_name=args.partner_name)
    seqs = {c: sg.genome.fetch_str(c, 1, int(sg.genome.lengths[i]))
            for i, c in enumerate(sg.genome.names)}
    write_fasta(seqs, args.out_prefix + "_genome.fa")
    write_gtf(sg, args.out_prefix + ".gtf")
    print(f"{len(sg.genes)} genes over {len(seqs)} contigs "
          f"({sg.genome.total_length} bp)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
