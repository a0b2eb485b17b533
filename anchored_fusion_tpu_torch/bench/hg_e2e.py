"""Full ten-stage fusion call at hg38 scale, on the card.

Implants a two-gene fusion into a 3.1 Gbp synthetic genome with 10%
segmental duplications — the anchor gene at 0.323·L, its partner at 0.806·L,
past the int32 range — and drives ``FusionPipeline.call_gene`` through every
stage on the XL merged-index engine (index stride 8, k = 14, two-pass
seeding: the hg38 operating point).

Prints ONE JSON line: the emitted rows (the ANCA--PRTB call must sit at its
breakpoint ±5 with its partner on chrS, else exit 1), per-stage wall times
and the pipeline's reads/s.

Run:  python -m anchored_fusion_tpu_torch.bench.hg_e2e --json-only
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np

from anchored_fusion_tpu_torch.bench.hg_scale import make_genome, log


def implant_genes(anchor_pos: int, partner_pos: int,
                  n_exons: int = 6, exon_len: int = 900,
                  intron_len: int = 600, chrom: str = "chrS"):
    """Two spliced genes, ANCA and PRTB, carved out of the genome at known
    loci: exons are slices of the genome itself (nothing is written into the
    sequence), 1-based inclusive like a GTF.  Returns (genes dict, gtf_dic,
    gene_rows) in the SynthGenome shapes the pipeline consumes."""
    from anchored_fusion_tpu_torch.bench.simulate import SynthGene

    genes, gtf = {}, {chrom: []}
    for name, pos0 in (("ANCA", anchor_pos), ("PRTB", partner_pos)):
        exons = []
        p = pos0
        for _ in range(n_exons):
            exons.append((p + 1, p + exon_len))
            p += exon_len + intron_len
        gid = f"ENSG{pos0 % 10**6:06d}.{name}"
        genes[name] = SynthGene(name, chrom, "+", exons, gid)
        for s, e in exons:
            gtf[chrom].append([s, e, gid, name])
    rows = [(g.chrom, g.exons[0][0], g.exons[-1][1], g.gene_id, g.name,
             g.strand) for g in genes.values()]
    return genes, gtf, rows


def clear_of_repeats(pos: int, repeats: np.ndarray, L: int,
                     span: int = 12_000) -> int:
    """``pos`` nudged past any duplication overlapping [pos, pos+span), so
    a gene locus stays unique sequence."""
    prev_end = (np.maximum.accumulate(repeats[:, 1]) if len(repeats)
                else None)
    while len(repeats):
        i = np.searchsorted(repeats[:, 0], pos + span, side="right")
        if i > 0 and prev_end[i - 1] > pos:
            # jump past the running-max end: the interval at i-1 need not
            # be the one that overlaps
            pos = int(prev_end[i - 1]) + 1000
        else:
            break
    return min(pos, L - span - 1000)


def make_world(gbp: float = 3.1, seed: int = 7, repeat_frac: float = 0.1,
               fusion_pairs: int = 1500, wild_pairs: int = 4000) -> dict:
    """The harness's genome, genes and read pairs.  ``rng`` is returned in
    its state after the reads were drawn, so callers can draw more."""
    from anchored_fusion_tpu_torch.bench.simulate import (
        fuse_transcripts, simulate_pairs)
    from anchored_fusion_tpu_torch.io.fasta import Reference

    L = int(gbp * 1e9)
    rng = np.random.default_rng(seed)
    codes, repeats, _ = make_genome(rng, L, repeat_frac)
    genes, gtf, rows = implant_genes(
        anchor_pos=clear_of_repeats(int(L * 0.323) | 7, repeats, L),
        partner_pos=clear_of_repeats(int(L * 0.806) | 3, repeats, L))
    genome = Reference(names=["chrS"], starts=np.zeros(1, np.int64),
                       lengths=np.asarray([L], np.int64), seq=codes)
    txA = genes["ANCA"].transcript(genome)
    txB = genes["PRTB"].transcript(genome)
    # junction at the 3rd/4th exon boundary of each (an MS call)
    exon_len = genes["ANCA"].exons[0][1] - genes["ANCA"].exons[0][0] + 1
    break5 = 3 * exon_len
    fusion = fuse_transcripts(txA, txB, break5, 3 * exon_len + 1)
    names_f, f1, f2 = simulate_pairs(rng, fusion, fusion_pairs,
                                     name_prefix="fus")
    names_w, w1, w2 = simulate_pairs(rng, txA, wild_pairs, name_prefix="wt")
    return {"L": L, "rng": rng, "codes": codes, "repeats": repeats,
            "genome": genome, "genes": genes, "gtf": gtf, "rows": rows,
            "anchor_tx": txA, "break5": break5,
            "names": names_f + names_w, "r1": f1 + w1, "r2": f2 + w2}


def call_ok(rows, break5: int):
    """(ANCA--PRTB called at break5 ±5, every such row's partner on chrS)."""
    fus = [r for r in rows if r["fusion"] == "ANCA--PRTB"]
    return (bool(fus) and any(abs(int(r["anchor_breakpoint"]) - break5) <= 5
                              for r in fus),
            bool(fus) and all(r["partner_chrom"] == "chrS" for r in fus))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="hg38-scale ten-stage e2e")
    ap.add_argument("--gbp", type=float, default=3.1)
    ap.add_argument("--index-stride", type=int, default=8)
    ap.add_argument("--kmer", type=int, default=14,
                    help="genome k-mer (14 sizes the bucket table to ~1.4 "
                         "positions a bucket at hg38 and stride 8)")
    ap.add_argument("--two-pass", type=int, default=1)
    # ~5.4 kb fusion transcript: 1500 pairs ≈ 56x junction coverage
    ap.add_argument("--fusion-pairs", type=int, default=1500)
    ap.add_argument("--wild-pairs", type=int, default=4000)
    ap.add_argument("--repeat-frac", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    ap.add_argument("--json-only", action="store_true")
    args = ap.parse_args(argv)
    quiet = args.json_only

    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.bench.simulate import write_fastq_pair
    from anchored_fusion_tpu_torch.config import AlignConfig, PipelineConfig
    from anchored_fusion_tpu_torch.io.fastq import read_fastq_pair
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline

    t0 = time.time()
    w = make_world(args.gbp, args.seed, args.repeat_frac, args.fusion_pairs,
                   args.wild_pairs)
    log(f"genome and reads generated: {w['L'] / 1e9:.2f} Gbp in "
        f"{time.time() - t0:.1f}s", quiet)
    with tempfile.TemporaryDirectory() as td:
        write_fastq_pair(td + "/r1.fastq.gz", td + "/r2.fastq.gz",
                         w["names"], w["r1"], w["r2"])
        reads = read_fastq_pair(td + "/r1.fastq.gz", td + "/r2.fastq.gz")
        cfg = PipelineConfig(
            align=AlignConfig(index_stride=args.index_stride,
                              genome_kmer=args.kmer,
                              xl_two_pass=bool(args.two_pass)),
            filter_false_positive=False)
        t0 = time.time()
        pipe = FusionPipeline(w["genome"], ExonIndex(w["gtf"],
                                                     inject_loci=False),
                              w["rows"], cfg, device=args.device)
        t_init = time.time() - t0
        log(f"pipeline init (index build): {t_init:.1f}s", quiet)
        anchor_codes = encode_ascii(w["anchor_tx"])
        t0 = time.time()
        res = pipe.call_gene("ANCA", anchor_codes, reads,
                             out_prefix=td + "/e2e")          # first call
        t_first = time.time() - t0
        t0 = time.time()
        res = pipe.call_gene("ANCA", anchor_codes, reads,
                             out_prefix=td + "/e2e")
        t_call = time.time() - t0

    ok, partner_ok = call_ok(res.rows, w["break5"])
    print(json.dumps({
        "genome_gbp": round(w["L"] / 1e9, 2),
        "device": args.device,
        "engine": type(pipe.genome_aligner).__name__,
        "index_stride": args.index_stride,
        "two_pass": bool(args.two_pass),
        "n_pairs": int(reads.n_pairs),
        "fusion_pairs": args.fusion_pairs,
        "expected_breakpoint": w["break5"],
        "emitted": [{k: (int(v) if isinstance(v, (int, np.integer)) else v)
                     for k, v in r.items() if k in
                     ("fusion", "type", "anchor_breakpoint", "partner_chrom",
                      "partner_breakpoint", "split", "spanning")}
                    for r in res.rows],
        "correct_call": ok,
        "partner_chrom_ok": partner_ok,
        "init_s": round(t_init, 1),
        "first_call_s": round(t_first, 1),
        "warm_call_s": round(t_call, 2),
        "pipeline_reads_per_s": round(res.counters["reads"] / t_call, 1),
        "stage_walls_s": {k[5:-2]: v for k, v in res.counters.items()
                          if k.startswith("time.")},
        "counters": {k: v for k, v in res.counters.items()
                     if not k.startswith("time.")},
    }))
    if not (ok and partner_ok):
        log("FUSION CALL INCORRECT", False)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
