"""Single-cell command line of the PyTorch/CUDA port.

Parity with ``Anchored_Fusion_singlecell.py`` and the JAX package's
single-cell CLI: discovers per-cell FASTQ pairs in ``--fastq_dir`` by suffix
(``_1/_2`` with .fastq/.fastq.gz/.fq/.fq.gz, :86-113), calls each target gene
on every cell, then aggregates the calls across cells by breakpoint key into
``<out>/<gene>/<gene>_fusion_gene_cell_predictions{_abridged}.txt``
(:258-288).  Per-cell prediction files go to
``<out>/<gene>/work_dir/<cell>/``; ``<out>/run_stats.json`` records per-gene
cell failures (``failures.<gene>``) and the SW kernel's launches in the run
(``kernel_launches``).

The cells of a gene share one genome index and ONE anchored-alignment batch
(``FusionPipeline.call_gene_cells``); the reference loops cells serially.

Runs on the GPU: ``--gpu_number`` -1 (default) is ``cuda``, N >= 0 is
``cuda:N``; without CUDA the run stops at once with exit code 3.  Only
``main(argv, device="cpu")`` runs it on the host.

A cluster run (``--coordinator/--num_procs/--proc_id`` or the ``AFT_*``
variables, one process each) splits the cells by process; each process
writes its cells' files, and process 0 aggregates over every cell after a
barrier.

Run:
  python -m anchored_fusion_tpu_torch.cli.sc --file_anchored_cds=... \\
      --fastq_dir=cells/ --file_ref_seq=... --file_ref_ann=... \\
      --out_folder=out [--not_filter_false_positive]
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Dict, List, Tuple

import numpy as np

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


def discover_pairs(fastq_dir: str) -> List[Tuple[str, str, str]]:
    """(cell_name, mate1_file, mate2_file) per cell, sorted, suffix parity
    with Anchored_Fusion_singlecell.py:86-113; a mate 1 without its mate 2
    is dropped."""
    files = sorted(os.listdir(fastq_dir))
    fset = set(files)
    out = []
    for f in files:
        for pat in (r"(\S+)_1\.fastq$", r"(\S+)_1\.fastq\.gz$",
                    r"(\S+)_1\.fq\.gz$", r"(\S+)_1\.fq$"):
            m = re.match(pat, f)
            if m:
                mate2 = f.replace("_1.", "_2.", 1)
                if mate2 in fset:
                    out.append((m.group(1), f, mate2))
                break
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Anchor Gene Fusion Detection, single-cell (PyTorch/CUDA)")
    common.add_common_args(p)
    p.add_argument("--fastq_dir", type=str, required=True,
                   help="The fastq files to scan")
    return p


def write_cell_aggregates(gene_dir: str, work_dir: str, out_name: str,
                          cells, filter_on: bool):
    """Cross-cell aggregation (Anchored_Fusion_singlecell.py:258-288): every
    per-cell ``<out_name>_predictions.txt`` row goes to
    ``<out_name>_gene_cell_predictions.txt`` with its cell, and rows with the
    same first five fields are summed into
    ``<out_name>_gene_cell_predictions_abridged.txt`` with their cell count
    and ';'-joined cell names, in first-seen order.  Cells without a
    predictions file are skipped."""
    agg: Dict[str, list] = {}
    with open(os.path.join(gene_dir, out_name
                           + "_gene_cell_predictions.txt"), "w") as fao:
        fao.write("Cell_name\tFusion_gene\tAnchored_gene_X\tX_clip_location\t"
                  "Partner_gene_Y\tY_clip_location\tSpanning_read_count\t"
                  "Breakpoint_read_count\n")
        for cell in cells:
            pred = os.path.join(work_dir, cell, out_name + "_predictions.txt")
            if not os.path.exists(pred):
                continue
            with open(pred) as fh:
                lines = fh.readlines()
            for line in lines[1:]:
                arr = line.rstrip("\n").split("\t")
                key = "$".join(arr[:5])
                # the filter's Natural_score column sits before the counts
                off = 6 if len(arr) > 7 and filter_on else 5
                ns, nb = int(arr[off]), int(arr[off + 1])
                if key not in agg:
                    agg[key] = [ns, nb, 1, [cell]]
                else:
                    agg[key][0] += ns
                    agg[key][1] += nb
                    agg[key][2] += 1
                    agg[key][3].append(cell)
                fao.write(cell + "\t" + "\t".join(arr[0:5] + [str(ns), str(nb)])
                          + "\n")
    with open(os.path.join(gene_dir, out_name
                           + "_gene_cell_predictions_abridged.txt"), "w") as faa:
        faa.write("Fusion_gene\tAnchored_gene_X\tX_clip_location\t"
                  "Partner_gene_Y\tY_clip_location\tAll_Spanning_read_count\t"
                  "All_Breakpoint_read_count\tSingle_cells_count\t"
                  "Single_cells_name\n")
        for key, v in agg.items():
            faa.write("\t".join(key.split("$")) + f"\t{v[0]}\t{v[1]}\t{v[2]}\t"
                      + ";".join(v[3]) + "\n")


def main(argv=None, device=None) -> int:
    """Run the CLI; ``device`` overrides ``--gpu_number`` (pass "cpu" to
    run on the host)."""
    from anchored_fusion_tpu_torch.utils.debug import maybe_enable_from_env
    maybe_enable_from_env()
    args = build_parser().parse_args(argv)
    multi = common.init_cluster(args, device)
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
    log = StageLogger("singlecell")
    gene_names = common.resolve_gene_names(args)
    pairs = discover_pairs(args.fastq_dir)
    all_cells = [name for name, _f1, _f2 in pairs]
    if not pairs:
        print("no per-cell FASTQ pairs found")
        return 1
    if multi:
        # each process calls its own slice of the cells and writes their
        # per-cell files (distinct paths); process 0 aggregates over every
        # cell after the barrier below.  With the filter on, each process
        # mines negatives from its own cells: pass a trained --model_file or
        # a shared --negative_samples for one model everywhere
        from anchored_fusion_tpu_torch.parallel.distributed import host_shard
        pairs = pairs[host_shard(len(pairs))]
    os.makedirs(args.out_folder, exist_ok=True)
    model_out = os.path.join(args.out_folder, "model_dir")
    os.makedirs(model_out, exist_ok=True)

    with log.stage("load_inputs"):
        genome = read_fasta(args.file_ref_seq)
        index = ExonIndex.from_gtf(args.file_ref_ann)
        gene_rows = parse_gtf_genes(args.file_ref_ann)
        anchor_seqs = common.split_anchor_fasta(args.file_anchored_cds)
    cfg = PipelineConfig(
        align=common.align_config_for(args, genome.total_length),
        read_batch=args.read_batch,
        filter_false_positive=not args.not_filter_false_positive,
        train_filter_model=not args.not_train_filter_model,
    )
    with log.stage("build_indexes"):
        pipe = FusionPipeline(genome, index, gene_rows, cfg, device=dev)

    cell_reads = {}
    for name, f1, f2 in pairs:
        cell_reads[name] = read_fastq_pair(
            os.path.join(args.fastq_dir, f1), os.path.join(args.fastq_dir, f2))

    filt = None
    if not args.not_filter_false_positive and cell_reads:
        with log.stage("filter_setup"):
            all_seqs = np.concatenate(
                [rb.seq.reshape(-1, rb.seq.shape[-1])
                 for rb in cell_reads.values()])
            filt = common.setup_filter(args, pipe, index, all_seqs,
                                       gene_names, model_out, log)

    for gi, gene_name in enumerate(gene_names):
        out_name = gene_name + "_fusion"
        gene_dir = os.path.join(args.out_folder, gene_name)
        work_dir = os.path.join(gene_dir, "work_dir")
        os.makedirs(work_dir, exist_ok=True)
        os.makedirs(os.path.join(gene_dir, "model_dir"), exist_ok=True)
        anchor_codes = encode_ascii(anchor_seqs.get(gi, ""))
        if anchor_codes.shape[0] == 0:
            continue
        score_fn = common.make_score_fn(filt, decode_to_str(anchor_codes),
                                        genome, index)
        failures: List[dict] = []
        for cell in cell_reads:
            os.makedirs(os.path.join(work_dir, cell), exist_ok=True)
        total = sum(rb.n_pairs * 2 for rb in cell_reads.values())
        # ONE anchored-alignment batch over every cell; the per-cell host
        # stages are failure-isolated so one bad cell cannot sink the cohort
        with log.stage(f"call:{gene_name}", items=total):
            results = pipe.call_gene_cells(
                gene_name, anchor_codes, cell_reads,
                out_prefix_for=lambda c: os.path.join(work_dir, c, out_name),
                score_fn=score_fn, failures=failures)
        if failures:
            log.set(**{f"failures.{gene_name}": failures})
        if multi:
            from anchored_fusion_tpu_torch.parallel.distributed import barrier
            barrier(f"sc_cells_done:{gene_name}")
        if writer:
            write_cell_aggregates(gene_dir, work_dir, out_name,
                                  all_cells if multi else results,
                                  not args.not_filter_false_positive)
    log.set(kernel_launches={"sw_align_fused": sw_cuda.launches,
                             "sw_end": sw_cuda.end_launches})
    if writer:
        log.dump(os.path.join(args.out_folder, "run_stats.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
