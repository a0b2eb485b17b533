"""Bulk-sample CLI driver of the PyTorch/CUDA port.

Flag and output-layout parity with ``Anchored_Fusion.py`` and the JAX
package's bulk CLI: per target gene a ``<out>/<gene>_fusion/`` folder with
``work_dir`` / ``model_dir`` and ``<gene>_fusion_predictions{_abridged}.txt``
TSVs, one stdout row per emitted fusion, ``<out>/run_stats.json``, and exit
code 0 (clean), 1 (some genes failed) or 2 (every attempted gene failed).
``run_stats.json`` also carries the SW kernel's launches in the run
(``kernel_launches``), the filter's held-out AUC (``filter_best_auc``) and
the seconds of negative mining and filter training inside
``filter_setup`` (``time.mine_negatives_s``, ``time.train_filter_s``).

Runs on the GPU: ``--gpu_number`` -1 (default) is ``cuda``, N >= 0 is
``cuda:N``; without CUDA the run stops at once with exit code 3.  Only
``main(argv, device="cpu")`` runs it on the host.

A cluster run starts the same command once per process with
``--coordinator host0:port --num_procs N --proc_id i`` (or the ``AFT_*``
variables): every process computes each gene, the anchored alignment split
by process and all-gathered (FusionPipeline.call_gene), and only process 0
writes the prediction files and ``run_stats.json``.

Run:
  python -m anchored_fusion_tpu_torch.cli.bulk --file_anchored_cds=... \\
      --fastq1=... --fastq2=... --file_ref_seq=... --file_ref_ann=... \\
      --out_folder=out [--not_filter_false_positive]
"""

from __future__ import annotations

import argparse
import os
import sys

from anchored_fusion_tpu_torch.annotate.exon_index import (
    ExonIndex, parse_gtf_genes)
from anchored_fusion_tpu_torch.config import PipelineConfig
from anchored_fusion_tpu_torch.io.fasta import read_fasta
from anchored_fusion_tpu_torch.io.fastq import read_fastq_pair
from anchored_fusion_tpu_torch.ops import sw_cuda
from anchored_fusion_tpu_torch.ops.encode import encode_ascii, decode_to_str
from anchored_fusion_tpu_torch.pipeline import FusionPipeline
from anchored_fusion_tpu_torch.utils.device import resolve_device
from anchored_fusion_tpu_torch.utils.log import StageLogger
from anchored_fusion_tpu_torch.cli import common

EXIT_NO_DEVICE = 3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Anchor Gene Fusion Detection (PyTorch/CUDA)")
    common.add_common_args(p)
    p.add_argument("--fastq1", type=str, default="fastq_1.fastq")
    p.add_argument("--fastq2", type=str, default="fastq_2.fastq")
    return p


def main(argv=None, device=None) -> int:
    """Run the CLI; ``device`` overrides ``--gpu_number`` (pass "cpu" to
    run on the host)."""
    from anchored_fusion_tpu_torch.utils.debug import maybe_enable_from_env
    maybe_enable_from_env()
    args = build_parser().parse_args(argv)
    common.init_cluster(args, device)
    writer = common.is_writer()
    try:
        dev = resolve_device(common.device_for(args, device))
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_NO_DEVICE
    if dev.type == "cuda" and dev.index is not None:
        import torch
        # kernels launch on the current device's stream
        torch.cuda.set_device(dev)
    log = StageLogger("bulk")
    gene_names = common.resolve_gene_names(args)
    if not gene_names:
        print("no target gene names found")
        return 1
    os.makedirs(args.out_folder, exist_ok=True)
    model_out = os.path.join(args.out_folder, "model_dir")
    os.makedirs(model_out, exist_ok=True)

    with log.stage("load_inputs"):
        genome = read_fasta(args.file_ref_seq)
        index = ExonIndex.from_gtf(args.file_ref_ann)
        gene_rows = parse_gtf_genes(args.file_ref_ann)
        reads = read_fastq_pair(args.fastq1, args.fastq2)
        anchor_seqs = common.split_anchor_fasta(args.file_anchored_cds)
    log.set(pairs=reads.n_pairs, genes=len(gene_names),
            genome_bp=genome.total_length)

    cfg = PipelineConfig(
        align=common.align_config_for(args, genome.total_length),
        read_batch=args.read_batch,
        filter_false_positive=not args.not_filter_false_positive,
        train_filter_model=not args.not_train_filter_model,
    )
    with log.stage("build_indexes"):
        pipe = FusionPipeline(genome, index, gene_rows, cfg, device=dev)

    filt = None
    if not args.not_filter_false_positive:
        with log.stage("filter_setup"):
            all_seqs = reads.seq.reshape(-1, reads.max_len)
            filt = common.setup_filter(args, pipe, index, all_seqs,
                                       gene_names, model_out, log)
        if filt is not None:
            log.set(filter_best_auc=filt.best_auc)

    from anchored_fusion_tpu_torch.utils.debug import gene_guard
    failures: list = []
    attempted = 0
    for gi, gene_name in enumerate(gene_names):
        out_name = gene_name + "_fusion"
        gene_dir = os.path.join(args.out_folder, out_name)
        out_prefix = os.path.join(gene_dir, out_name)
        if args.resume and os.path.exists(out_prefix + "_predictions.txt"):
            # job-level resume: completed genes are skipped (the reference's
            # file-existence memoization, Anchored_Fusion.py:181-203, applied
            # at the whole-gene level)
            print(f"[bulk] {gene_name}: resume hit, skipped")
            continue
        os.makedirs(os.path.join(gene_dir, "work_dir"), exist_ok=True)
        os.makedirs(os.path.join(gene_dir, "model_dir"), exist_ok=True)
        anchor_codes = encode_ascii(anchor_seqs.get(gi, ""))
        if anchor_codes.shape[0] == 0:
            print(f"warning: no anchored sequence for {gene_name}; skipped")
            continue
        score_fn = common.make_score_fn(filt, decode_to_str(anchor_codes),
                                        genome, index)
        attempted += 1
        with log.stage(f"call:{gene_name}", items=reads.n_pairs * 2):
            with gene_guard(gene_name, failures, retries=args.gene_retries) as g:
                g.run(lambda: pipe.call_gene(
                    gene_name, anchor_codes, reads,
                    out_prefix=out_prefix if writer else None,
                    score_fn=score_fn))
            result = g.result
        if result is None:
            continue
        log.set(**{f"{gene_name}.{k}": v for k, v in result.counters.items()})
        for row in result.rows:
            print(f"{row['fusion']}\t{row['anchor_breakpoint']}\t"
                  f"{row['partner_chrom']}:{row['partner_breakpoint']}\t"
                  f"spanning={row['spanning']}\tsplit={row['split']}")
    if failures:
        log.set(failures=failures)
    log.set(kernel_launches={"sw_align_fused": sw_cuda.launches,
                             "sw_end": sw_cuda.end_launches})
    if writer:
        log.dump(os.path.join(args.out_folder, "run_stats.json"))
    # 2 = every ATTEMPTED gene failed (resume-skips don't mask a dead run),
    # 1 = some failed, 0 = clean
    if failures and len(failures) == attempted:
        return 2
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
