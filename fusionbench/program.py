"""The program under test as the entries build it: a ``FusionPipeline`` of
anchored_fusion_tpu_torch over the benchmark's genome and annotation, with
the configuration's settings, and its inputs as the pipeline takes them."""

from __future__ import annotations

import numpy as np


def build_pipeline(world, cfg: dict, device):
    """``FusionPipeline(...)`` (with its genome index) for ``world``; the
    engine it chooses has to be the one the configuration states."""
    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.config import AlignConfig, PipelineConfig
    from anchored_fusion_tpu_torch.io.fasta import Reference
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline

    pcfg = PipelineConfig(align=AlignConfig(**cfg["align"]),
                          **cfg["pipeline"])
    L = len(world.codes)
    genome = Reference(names=[world.chrom], starts=np.zeros(1, np.int64),
                       lengths=np.asarray([L], np.int64), seq=world.codes)
    pipe = FusionPipeline(genome, ExonIndex(world.gtf, inject_loci=False),
                          world.gene_rows, pcfg, device=device)
    engine = type(pipe.genome_aligner).__name__
    if engine != cfg["engine"]:
        raise RuntimeError(f"the pipeline chose {engine}, the configuration "
                           f"states {cfg['engine']}")
    return pipe


def read_batch(prefix: str, seq: np.ndarray, read_len: int):
    """A ``ReadBatch`` of the pairs ``seq`` (n, 2, row), named
    ``<prefix>p<i>``."""
    from anchored_fusion_tpu_torch.io.fastq import ReadBatch
    n = seq.shape[0]
    return ReadBatch([f"{prefix}p{i}" for i in range(n)], seq,
                     np.full((n, 2), read_len, np.int32))
