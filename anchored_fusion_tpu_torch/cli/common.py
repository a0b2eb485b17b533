"""Shared CLI plumbing for the port's drivers."""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
from anchored_fusion_tpu_torch.io.fasta import (
    Reference, iter_fasta, extract_gene_names)
from anchored_fusion_tpu_torch.models.train import (
    TrainedFilter, train_filter_model, score_junctions)
from anchored_fusion_tpu_torch.models.negative import mine_negative_junctions
from anchored_fusion_tpu_torch.models import data as fdata
from anchored_fusion_tpu_torch.pipeline import FusionPipeline


def add_common_args(p: argparse.ArgumentParser):
    """Flag parity with Anchored_Fusion.py:15-30 (minus --fastq*/--fastq_dir)
    and with the JAX package's CLI."""
    p.add_argument("--file_anchored_cds", type=str, required=True,
                   help="Target gene fasta file of anchored transcript")
    p.add_argument("--gene_names", type=str, default="",
                   help="The file of target gene names")
    p.add_argument("--out_folder", type=str, default="./")
    p.add_argument("--file_ref_seq", type=str, required=True,
                   help="The reference sequence file")
    p.add_argument("--file_ref_ann", type=str, required=True,
                   help="The reference annotation file")
    p.add_argument("--not_filter_false_positive", action="store_true")
    p.add_argument("--not_train_filter_model", action="store_true")
    p.add_argument("--model_file", type=str, default="./data/model.msgpack")
    p.add_argument("--positive_samples", type=str,
                   default="./data/positive_samples.txt")
    p.add_argument("--homo_gene_file", type=str, default="./data/homo_gene.npy")
    p.add_argument("--negative_samples", type=str,
                   default="./Model/negative_samples.txt")
    p.add_argument("--thread", type=str, default="1",
                   help="Accepted for reference-CLI compatibility; device "
                        "batching replaces host threading")
    p.add_argument("--gpu_number", type=str, default="-1",
                   help="CUDA device: -1 (default) = 'cuda', N >= 0 = "
                        "'cuda:N'")
    p.add_argument("--read_batch", type=int, default=32768)
    # genome-engine knobs (0/-1 = auto: the hg38 operating point kicks in
    # for genomes past the int32 coordinate range; small genomes keep the
    # dense parity defaults)
    p.add_argument("--index_stride", type=int, default=0,
                   help="genome index sampling stride (0 = auto: 1 below "
                        "2.1Gbp, 8 at hg38 scale)")
    p.add_argument("--genome_kmer", type=int, default=0,
                   help="genome seeding k-mer (0 = auto: 13, or 14 at hg38 "
                        "scale — keeps bucket load ~1.4)")
    p.add_argument("--xl_two_pass", type=int, default=-1,
                   help="two-pass XL seeding with per-read rescue "
                        "(-1 = auto: on at hg38 scale)")
    p.add_argument("--xl_profile", type=str, default="robust",
                   choices=("robust", "balanced", "throughput"),
                   help="two-pass operating point of the XL engine: robust "
                        "= pass-1 H4/top-4 + rescue H16/top-8, balanced = "
                        "pass-1 H4/top-2, throughput = pass-1 H2/top-2 + "
                        "rescue H8")
    p.add_argument("--resume", action="store_true",
                   help="Skip genes whose predictions file already exists")
    p.add_argument("--gene_retries", type=int, default=1,
                   help="Retries per gene on transient failures before the "
                        "gene is recorded as failed and the run continues")
    # multi-process cluster flags: launch the same command once per process
    # with --coordinator host0:port --num_procs N --proc_id i (or the
    # AFT_COORDINATOR / AFT_NUM_PROCS / AFT_PROC_ID variables); unset, the
    # run is one process
    p.add_argument("--coordinator", type=str, default=None,
                   help="torch.distributed rendezvous address (host:port) "
                        "of process 0; enables the multi-process runtime")
    p.add_argument("--num_procs", type=int, default=None,
                   help="Total processes in the cluster")
    p.add_argument("--proc_id", type=int, default=None,
                   help="This process's id within the cluster")


def device_for(args, device=None) -> str:
    """The torch device of a run: ``device`` when the caller names one (the
    only way to select the CPU), else ``--gpu_number``: -1 = 'cuda' (in a
    multi-process run, this process's card: cuda:(local rank % cards)),
    N >= 0 = 'cuda:N'."""
    if device is not None:
        return str(device)
    n = int(args.gpu_number)
    if n >= 0:
        return f"cuda:{n}"
    from anchored_fusion_tpu_torch.parallel import distributed
    if distributed.world_size() > 1 and torch.cuda.is_available():
        return str(distributed.local_device())
    return "cuda"


def align_config_for(args, genome_bp: int):
    """AlignConfig with the auto genome-scale operating point.

    Past the int32 coordinate range the hg38 point applies (stride 8, k=14,
    two-pass rescue); explicit flags always win, and sub-2.1Gbp genomes keep
    the dense parity defaults."""
    from anchored_fusion_tpu_torch.config import AlignConfig
    big = genome_bp > 2**31 - 2**20
    # two-pass operating points: (pass1_hits, pass1_top_k, rescue_hits,
    # rescue_top_k)
    profile = {"robust": (4, 4, 16, 8),
               "balanced": (4, 2, 16, 8),
               "throughput": (2, 2, 8, 8)}[getattr(args, "xl_profile",
                                                   "robust")]
    return AlignConfig(
        index_stride=args.index_stride or (8 if big else 1),
        genome_kmer=args.genome_kmer or (14 if big else 13),
        xl_two_pass=(big if args.xl_two_pass < 0 else bool(args.xl_two_pass)),
        xl_pass1_hits=profile[0], xl_pass1_top_k=profile[1],
        xl_rescue_hits=profile[2], xl_rescue_top_k=profile[3])


def init_cluster(args, device=None) -> bool:
    """Join the process group when a cluster flag (or AFT_COORDINATOR) asks
    for one; returns True iff this is one process of several.  ``device``
    "cpu" selects the gloo backend (parallel/distributed.py)."""
    from anchored_fusion_tpu_torch.parallel.distributed import initialize
    return initialize(args.coordinator, args.num_procs, args.proc_id,
                      device=device)


def is_writer() -> bool:
    """Only process 0 of a cluster writes shared files."""
    from anchored_fusion_tpu_torch.parallel import distributed
    return distributed.rank() == 0


def resolve_gene_names(args) -> List[str]:
    if args.gene_names and os.path.exists(args.gene_names):
        with open(args.gene_names) as fh:
            return [ln.strip() for ln in fh if ln.strip()]
    return extract_gene_names(args.file_anchored_cds)


def split_anchor_fasta(path: str) -> Dict[int, str]:
    """Per-record sequences in file order (the reference consumes the
    multi-FASTA sequentially per gene name, Anchored_Fusion.py:154-165)."""
    return {i: seq for i, (_h, seq) in enumerate(iter_fasta(path))}


def bootstrap_homo_gene(path: str) -> str:
    """Build homo_gene.npy from homo_gene_{1,2}.txt.gz when absent.

    Flag parity with Anchored_Fusion.py:37-56: the reference gunzips and cats
    the two shipped text halves, then parses line 1 as the ';'-joined gene
    name list and each following line as ``gene\\tidx1;idx2;...`` (indices
    into that list), saving the dict as .npy.  (The reference's parse calls
    ``F.readlines()`` twice, so its loop body never runs and the saved dict is
    empty — this implements the documented intent: gene -> set of homolog
    gene NAMES, which is what the negative-mining check consumes.)  Returns
    the resolved .npy path (which may still not exist when the text halves
    are absent).
    """
    import gzip
    if not path or os.path.exists(path):
        return path
    d = os.path.dirname(path) or "."
    halves = []
    for i in (1, 2):
        txt = os.path.join(d, f"homo_gene_{i}.txt")
        gz = txt + ".gz"
        if os.path.exists(txt):
            with open(txt, "rb") as fh:
                halves.append(fh.read())
        elif os.path.exists(gz):
            with gzip.open(gz, "rb") as fh:
                halves.append(fh.read())
        else:
            return path
    lines = b"".join(halves).decode().splitlines()
    if not lines:
        return path
    names = lines[0].rstrip().split(";")
    homo: Dict[str, List[str]] = {}
    for ln in lines[1:]:
        parts = ln.rstrip().split("\t")
        if len(parts) != 2:
            continue
        idxs = [int(v) for v in parts[1].split(";") if v]
        homo[parts[0]] = [names[i] for i in idxs if 0 <= i < len(names)]
    np.save(path, homo, allow_pickle=True)
    return path


def load_homo_map(path: str) -> Dict[str, Set[str]]:
    """Tolerant loader for the homolog-pair file (.npy dict or 2-col text)."""
    out: Dict[str, Set[str]] = {}
    if not path or not os.path.exists(path):
        return out
    try:
        if path.endswith(".npy"):
            d = np.load(path, allow_pickle=True).item()
            for k, v in d.items():
                out[str(k)] = {str(x) for x in v}
        else:
            with open(path) as fh:
                for ln in fh:
                    parts = ln.rstrip().split("\t")
                    if len(parts) == 2:
                        out[parts[0]] = set(parts[1].split(";"))
    except Exception as e:  # pragma: no cover - defensive
        print(f"warning: could not parse homo gene file {path}: {e}")
    return out


def resolve_data_path(path: str) -> str:
    """Resolve a missing CWD-relative data path against the checkout root.

    The reference resolves its data-file defaults relative to the script
    directory (Anchored_Fusion.py:34-44) so they work from any CWD; the
    equivalent here is the repository root (parent of the package), where
    the shipped assets live (``data/positive_samples.txt``).
    """
    if not path or os.path.exists(path):
        return path
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    rel = path[2:] if path.startswith("./") else path
    cand = os.path.join(root, rel)
    return cand if os.path.exists(cand) else path


def setup_filter(args, pipe: FusionPipeline, index: ExonIndex,
                 all_read_seqs, gene_names: List[str],
                 model_out_dir: str, log=None) -> Optional[TrainedFilter]:
    """Filter-model bootstrap (Anchored_Fusion.py:91-121 parity): train from
    mined negatives + provided positives, or load a pre-trained model; any
    missing input degrades to filter-off with a warning, never a crash.
    Mining, training and scoring run on the pipeline's device; with a
    StageLogger ``log``, mining and training are its stages
    ``mine_negatives`` and ``train_filter``."""
    stage = log.stage if log is not None else (
        lambda name: contextlib.nullcontext())
    if args.not_filter_false_positive:
        return None
    cfg = pipe.cfg.filter_model
    device = str(pipe.device)
    if args.not_train_filter_model:
        model_path = resolve_data_path(args.model_file)
        if os.path.exists(model_path):
            # .pt/.pth: reference-format torch checkpoint (Model.py:314-333);
            # anything else: Flax msgpack
            return TrainedFilter.load(model_path, cfg, cfg.len_seq, device)
        print("Error: model file not found!, not performing filter false positives.")
        return None
    positive_path = resolve_data_path(args.positive_samples)
    if not os.path.exists(positive_path):
        print("Error: positive samples file not found!, not performing filter false positives.")
        return None
    positives = fdata.read_junction_file(positive_path)
    neg_path = args.negative_samples
    if not os.path.exists(neg_path):
        neg_path = os.path.join(model_out_dir, "negative_samples.txt")
    if os.path.exists(neg_path):
        negatives = fdata.read_junction_file(neg_path)
    else:
        homo_map = load_homo_map(bootstrap_homo_gene(
            resolve_data_path(args.homo_gene_file)))
        with stage("mine_negatives"):
            negatives = mine_negative_junctions(
                pipe.genome_aligner, pipe.genome, index, all_read_seqs,
                gene_names, homo_map)
        os.makedirs(model_out_dir, exist_ok=True)
        if is_writer():
            with open(neg_path, "w") as fh:
                fh.write("\n".join(negatives) + ("\n" if negatives else ""))
        negatives = [n.split("\t")[0] for n in negatives]
    if not negatives:
        print("warning: no negative samples mined; filter disabled")
        return None
    model_file = args.model_file
    if not os.path.exists(os.path.dirname(model_file) or "."):
        model_file = os.path.join(model_out_dir, "model.msgpack")
    warm = None
    if os.path.exists(model_file):
        try:
            warm = TrainedFilter.load(model_file, cfg, cfg.len_seq, device)
        except (OSError, ValueError, KeyError, RuntimeError):
            warm = None
    with stage("train_filter"):
        # every process trains the same model; process 0 saves it
        return train_filter_model(positives, negatives, cfg,
                                  model_file if is_writer() else None,
                                  warm_start=warm, device=device)


def make_score_fn(filt: Optional[TrainedFilter], anchor_seq: str,
                  genome: Reference, index: ExonIndex):
    if filt is None:
        return None
    from anchored_fusion_tpu_torch.models.test_reads import (
        build_test_rows, attach_scores)

    def fn(candidates):
        rows, row_cand = build_test_rows(candidates, anchor_seq, genome, index)
        scores = score_junctions(filt, rows)
        return attach_scores(candidates, row_cand, scores)

    return fn
