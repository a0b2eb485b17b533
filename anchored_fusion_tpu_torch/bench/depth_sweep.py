"""Sensitivity-vs-coverage titration: the reference's paper benchmark.

``utils/simulate_reads.py:4-20`` of the reference generates wgsim pairs from
each fusion transcript at coverages 2x-128x (insert 200, 2x101 bp); the
published evaluation is "at what depth does each fusion become callable".
This harness runs that experiment through the port's pipeline on
``--device``: six anchor--partner fusions on a synthetic spliced genome,
pairs simulated at the reference's coverage ladder, one
``FusionPipeline.call_gene`` per point; detection is an emitted row for the
right partner within 5 bp of the junction.

Emits ONE JSON line ({fusion: {coverage: detected}}, the minimum detected
coverage per fusion), with the JAX harness's keys and, on the same seed,
its values.

Run:  python -m anchored_fusion_tpu_torch.bench.depth_sweep --json-only
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np

from anchored_fusion_tpu_torch.bench.hg_scale import log

COVERAGES = (2, 4, 8, 16, 32, 64, 128)   # simulate_reads.py ladder


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="sensitivity vs coverage")
    ap.add_argument("--fusions", type=int, default=6,
                    help="number of anchor--partner pairs (reference: 6)")
    ap.add_argument("--coverages", type=str,
                    default=",".join(str(c) for c in COVERAGES))
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    ap.add_argument("--json-only", action="store_true")
    args = ap.parse_args(argv)
    quiet = args.json_only

    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.bench.simulate import (
        make_synthetic_genome, fuse_transcripts, simulate_pairs,
        coverage_to_pairs, write_fastq_pair)
    from anchored_fusion_tpu_torch.config import PipelineConfig
    from anchored_fusion_tpu_torch.io.fastq import read_fastq_pair
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline
    from anchored_fusion_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    # distinct 3-letter-prefix names for any fusion count (the miner's name
    # check rejects pairs sharing a 3-character prefix); gene 0 anchors,
    # genes 1..N partner
    names = ["".join(chr(65 + (i // 26 ** p) % 26) for p in (2, 1, 0))
             for i in range(args.fusions + 1)]
    sg = make_synthetic_genome(rng, n_genes=args.fusions + 1,
                               exons_per_gene=(4, 6), exon_len=(250, 400),
                               namer=lambda gi: names[gi])
    index = ExonIndex(sg.gtf_dic, inject_loci=False)
    pipe = FusionPipeline(sg.genome, index, sg.gene_rows(),
                          PipelineConfig(filter_false_positive=False),
                          device=device)
    anchor = sg.genes[names[0]]
    tx_a = anchor.transcript(sg.genome)
    anchor_codes = encode_ascii(tx_a)
    covs = [int(c) for c in args.coverages.split(",")]

    out = {}
    for fi in range(1, args.fusions + 1):
        partner = sg.genes[names[fi]]
        tx_p = partner.transcript(sg.genome)
        # junction at the anchor's 2nd/3rd exon boundary (the expected
        # transcript breakpoint), partner joined from its 2nd exon
        break5 = sum(e - s + 1 for s, e in anchor.exons[:2])
        break3 = (partner.exons[0][1] - partner.exons[0][0] + 1) + 1
        fusion_tx = fuse_transcripts(tx_a, tx_p, break5, break3)
        curve = {}
        for cov in covs:
            n_pairs = coverage_to_pairs(len(fusion_tx), cov)
            nm, r1, r2 = simulate_pairs(
                rng, fusion_tx, n_pairs, insert=200, error_rate=0.001,
                name_prefix=f"f{fi}c{cov}")
            with tempfile.TemporaryDirectory() as td:
                write_fastq_pair(td + "/1.fq.gz", td + "/2.fq.gz", nm, r1, r2)
                reads = read_fastq_pair(td + "/1.fq.gz", td + "/2.fq.gz")
                res = pipe.call_gene(names[0], anchor_codes, reads,
                                     out_prefix=td + "/ds")
            hit = any(r["fusion"] == f"{names[0]}--{partner.name}"
                      and abs(int(r["anchor_breakpoint"]) - break5) <= 5
                      for r in res.rows)
            curve[cov] = bool(hit)
            log(f"{names[0]}--{partner.name} cov={cov}x pairs={n_pairs} "
                f"detected={hit}", quiet)
        det = [c for c in covs if curve[c]]
        out[f"{names[0]}--{partner.name}"] = {
            "curve": {str(c): v for c, v in curve.items()},
            "min_detected_cov": det[0] if det else None,
        }
    all_min = [v["min_detected_cov"] for v in out.values()]
    print(json.dumps({
        "coverages": covs,
        "insert": 200, "read_len": 101, "error_rate": 0.001,
        "fusions": out,
        "all_detected_from_cov": (max(m for m in all_min)
                                  if all(m is not None for m in all_min)
                                  else None),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
