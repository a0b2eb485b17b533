"""Real-data depth titration: a wgsim-form sample through the 2x ladder.

The reference's second evaluation harness (``utils/downsample_reads.py``)
halves a real FASTQ pair step by step to find the depth where a known call
is lost.  This runs it end to end on ``--device``: the sample (by default
the reference tool's bundled 11,258-pair BCR sample, at its paths relative
to that tool's checkout) is paired-consistently halved
(bench/downsample.downsample_batch) and ``FusionPipeline.call_gene`` runs
at every level against the surrogate genome (bench/surrogate.py);
detection is the BCR--ABL1 row at breakpoint 3235.

Emits ONE JSON line, with the JAX harness's keys.

Run:  python -m anchored_fusion_tpu_torch.bench.real_depth --json-only \
          [--fastq1 r_1.fastq.gz --fastq2 r_2.fastq.gz --anchor anchor.fa]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from anchored_fusion_tpu_torch.bench.hg_scale import log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="real-data depth titration")
    ap.add_argument("--steps", type=int, default=8,
                    help="2x halvings (8 -> down to ~44 pairs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fastq1", default="test/test_sample_1.fastq.gz")
    ap.add_argument("--fastq2", default="test/test_sample_2.fastq.gz")
    ap.add_argument("--anchor", default="test/target_gene.fasta",
                    help="anchored-gene FASTA")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    ap.add_argument("--json-only", action="store_true")
    args = ap.parse_args(argv)
    quiet = args.json_only

    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.bench.downsample import downsample_batch
    from anchored_fusion_tpu_torch.bench.surrogate import (
        surrogate_from_sample)
    from anchored_fusion_tpu_torch.config import PipelineConfig
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline
    from anchored_fusion_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    sg, reads, anchor = surrogate_from_sample(args.fastq1, args.fastq2,
                                              args.anchor)
    pipe = FusionPipeline(sg.genome, ExonIndex(sg.gtf_dic, inject_loci=False),
                          sg.gene_rows(),
                          PipelineConfig(filter_false_positive=False),
                          device=device)
    ladder = []
    rb = reads
    homo = None
    with tempfile.TemporaryDirectory() as td:
        for step in range(args.steps + 1):
            res = pipe.call_gene("BCR", anchor.seq, rb,
                                 out_prefix=f"{td}/d{step}",
                                 homo_genes=homo)
            homo = res.homo_genes
            rows = [r for r in res.rows if r["fusion"] == "BCR--ABL1"
                    and int(r["anchor_breakpoint"]) == 3235]
            entry = {
                "downsample": 2 ** step,
                "pairs": int(rb.n_pairs),
                "detected": bool(rows),
                "split": int(rows[0]["split"]) if rows else 0,
                "spanning": int(rows[0]["spanning"]) if rows else 0,
            }
            ladder.append(entry)
            log(f"1/{2**step}x ({rb.n_pairs} pairs): detected="
                f"{entry['detected']} split={entry['split']} "
                f"spanning={entry['spanning']}", quiet)
            if step < args.steps:
                rb = downsample_batch(rb, 0.5, args.seed + step + 1)
    lost = [e["downsample"] for e in ladder if not e["detected"]]
    print(json.dumps({
        "sample": "bundled BCR-ABL1 (11,258 pairs)",
        "ladder": ladder,
        "max_downsample_detected": max(
            (e["downsample"] for e in ladder if e["detected"]), default=None),
        "first_lost_at": lost[0] if lost else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
