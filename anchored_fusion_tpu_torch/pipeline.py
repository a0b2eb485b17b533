"""End-to-end anchored fusion-detection pipeline.

Orchestrates the full per-gene flow of the reference driver
(Anchored_Fusion.py:123-227) with zero temp files and zero subprocesses —
all alignment passes are device batches, all evidence flows as arrays:

  1. anchor alignment (both mates)            ≙ bwa mem -> realign_reads.bam
  2. half-mapped mate rescue vs genome        ≙ samtools -f8/-f4 + bwa mem
  3. homolog masking                          ≙ Find_homo_genes
  4. multi-mapper rescue of clipped reads     ≙ del_too_many_reads
  5. spanning blocks + fine blocks            ≙ Find_blocks / Find_fine_block
  6. breakpoint clustering + PWM consensus    ≙ contact_reads / combine_split_reads
  7. candidate regions + anchored-split check ≙ Build_candidate_fasta / Find_Anchored_split
  8. candidate join + junction linearity      ≙ Find_candidate_genes
  9. optional DL filter scoring               ≙ get_test_reads / Test_model
 10. report                                   ≙ Final_fusion
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from anchored_fusion_tpu_torch.config import PipelineConfig
from anchored_fusion_tpu_torch.io.fasta import Reference
from anchored_fusion_tpu_torch.io.fastq import ReadBatch
from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
from anchored_fusion_tpu_torch.annotate.homolog import find_homolog_genes
from anchored_fusion_tpu_torch.align.aligner import (
    AlignmentResult, align_to_reference, classify_clips)
from anchored_fusion_tpu_torch.align.genome import GenomeAligner
from anchored_fusion_tpu_torch.call.breakpoints import (
    extract_split_reads, cluster_split_reads, oriented_sequences)
from anchored_fusion_tpu_torch.call.consensus import merge_clusters
from anchored_fusion_tpu_torch.call.blocks import (
    ClippedReadInfo, find_spanning_blocks, find_fine_blocks)
from anchored_fusion_tpu_torch.call.rescue import rescue_filter
from anchored_fusion_tpu_torch.call.candidates import (
    build_candidate_regions, find_anchored_split, find_candidate_genes)
from anchored_fusion_tpu_torch.call.report import write_final_fusion
from anchored_fusion_tpu_torch.config import FINE_BLOCK_PRESET
from anchored_fusion_tpu_torch.ops.encode import PAD
from anchored_fusion_tpu_torch.utils.device import resolve_device
from anchored_fusion_tpu_torch.utils.log import Stages, span, timed


_INT32_SAFE = 2**31 - 2**20
# Per-device budget for a REPLICATED XL index (pos_div + tiled genome +
# bucket table).  The JAX package sized it for a 16 GiB TPU; the port keeps
# the value so both pick the same engine (an H100 holds 80 GB).
_XL_DEVICE_BYTES = 12 * 2**30


def _xl_bytes(total_length: int, stride: int, kmer: int) -> int:
    return (total_length // stride * 4      # pos_div int32
            + total_length                  # tiled int8 genome (+~0 halo)
            + ((1 << (2 * kmer)) + 1) * 4)  # bucket table


def genome_engine_kind(total_length: int, index_stride: int,
                       mesh_mp: int = 0, genome_kmer: int = 13,
                       device_bytes: int = _XL_DEVICE_BYTES) -> str:
    """Which genome-alignment engine FusionPipeline selects, by the JAX
    package's rule (``mesh_mp`` is the mesh's mp size, 0 without a mesh):

      'xl-mesh'      — mesh, genome past int32, and the strided XL index
                       fits one device (int32 positions, and ``_xl_bytes``
                       within ``device_bytes`` unless the mesh has no mp
                       axis to split over): XL replicated, reads split over
                       every rank;
      'sharded-mesh' — mesh with mp > 1 and XL not eligible: the k-mer
                       index splits over mp;
      'xl'           — one device, genome past int32, strided index fits;
      'sharded'      — one device, genome past even the strided capacity;
      'flat'         — genome fits int32 (a dp-only mesh splits its reads).
    """
    stride = max(1, index_stride)
    coord_fit = (total_length > _INT32_SAFE
                 and total_length // stride < _INT32_SAFE)
    hbm_fit = _xl_bytes(total_length, stride, genome_kmer) <= device_bytes
    if mesh_mp > 0:
        if coord_fit and (mesh_mp == 1 or hbm_fit):
            return "xl-mesh"
        if mesh_mp > 1:
            return "sharded-mesh"
    if total_length > _INT32_SAFE:
        return "xl" if coord_fit else "sharded"
    return "flat"


@dataclasses.dataclass
class GeneCallResult:
    rows: List[dict]
    candidates: list
    clusters: list
    blocks_chr: dict
    homo_genes: List[str]
    counters: Dict[str, float]


class FusionPipeline:
    """Holds genome-wide state (genome, exon index, k-mer index) across genes.
    The genome engine follows :func:`genome_engine_kind`.

    With ``mesh`` (or a ``cfg.mesh`` that resolves to more than one device,
    parallel/mesh.py) every rank runs the same calls: each alignment batch
    is split over the mesh's dp axis, the genome index is replicated or, for
    the sharded engine, split over mp, and the results are all-gathered, so
    every rank computes the one-device rows.  ``device`` is this rank's
    device.  Without a mesh in a multi-process run, ``call_gene`` splits the
    anchored alignment by process (``host_shard``) and all-gathers it.
    """

    def __init__(self, genome: Reference, exon_index: ExonIndex,
                 gene_rows: Sequence[tuple],
                 cfg: Optional[PipelineConfig] = None,
                 cache_dir: Optional[str] = None,
                 device="cuda",
                 index=None,
                 mesh=None):
        """``index``: a prebuilt genome KmerIndex for the flat engine (see
        GenomeAligner)."""
        from anchored_fusion_tpu_torch.utils.checkpoint import StageCache
        from anchored_fusion_tpu_torch.parallel.mesh import mesh_from_config
        self.cfg = cfg or PipelineConfig()
        self.device = resolve_device(device)
        self.genome = genome
        self.exon_index = exon_index
        self.gene_rows = list(gene_rows)
        if mesh is None:
            mesh = mesh_from_config(self.cfg.mesh)
        self.mesh = mesh
        kind = genome_engine_kind(
            genome.total_length, self.cfg.align.index_stride,
            0 if mesh is None else mesh.size(1),
            genome_kmer=self.cfg.align.genome_kmer)
        if index is not None and kind != "flat":
            raise ValueError(f"a prebuilt index serves only the flat engine, "
                             f"not {kind!r}")
        if kind == "xl-mesh":
            # the strided XL index fits one device: replicate it, split
            # reads over every rank
            from anchored_fusion_tpu_torch.align.genome_xl import (
                GenomeAlignerXL)
            self.genome_aligner = GenomeAlignerXL(genome, self.cfg.align,
                                                  device=self.device,
                                                  mesh=mesh)
        elif kind == "sharded-mesh":
            from anchored_fusion_tpu_torch.parallel.sharded_genome import (
                ShardedGenomeAligner)
            self.genome_aligner = ShardedGenomeAligner(
                genome, n_shards=mesh.size(1), cfg=self.cfg.align,
                device=self.device, mesh=mesh)
        elif kind == "xl":
            # past int32, with strided positions inside it (the hg38
            # operating point): one merged index, one query per chunk
            from anchored_fusion_tpu_torch.align.genome_xl import (
                GenomeAlignerXL)
            self.genome_aligner = GenomeAlignerXL(genome, self.cfg.align,
                                                  device=self.device)
        elif kind == "sharded":
            # a dense index past int32: the per-shard loop is the capacity
            # engine
            from anchored_fusion_tpu_torch.parallel.sharded_genome import (
                ShardedGenomeAligner)
            n = -(-genome.total_length // (_INT32_SAFE // 2))
            self.genome_aligner = ShardedGenomeAligner(
                genome, n_shards=max(2, int(n)), cfg=self.cfg.align,
                device=self.device)
        else:
            self.genome_aligner = GenomeAligner(genome, self.cfg.align,
                                                device=self.device,
                                                index=index, mesh=mesh)
        self.cache = StageCache(cache_dir)

    def call_gene(
        self,
        gene_name: str,
        anchor_codes: np.ndarray,
        reads: ReadBatch,
        out_prefix: Optional[str] = None,
        scores: Optional[Sequence[float]] = None,
        score_fn=None,
        homo_genes: Optional[List[str]] = None,
    ) -> GeneCallResult:
        # 1. anchor alignment: split over the mesh's dp axis, or by process
        # when a multi-process run has no mesh
        from anchored_fusion_tpu_torch.parallel import distributed
        with span("call", pairs=reads.n_pairs):
            with timed("anchor_align", reads=reads.n_pairs * 2) as al:
                seqs = reads.seq.reshape(reads.n_pairs * 2, reads.max_len)
                if distributed.world_size() > 1 and self.mesh is None:
                    sl = distributed.host_shard(reads.n_pairs)
                    res_l = align_to_reference(
                        seqs[2 * sl.start:2 * sl.stop], anchor_codes,
                        self.cfg.align, chunk=self.cfg.read_batch,
                        device=self.device)
                    res = distributed.allgather_alignment(res_l,
                                                          reads.n_pairs)
                else:
                    res = align_to_reference(seqs, anchor_codes,
                                             self.cfg.align,
                                             chunk=self.cfg.read_batch,
                                             device=self.device,
                                             mesh=self.mesh)
            return self._call_stages(gene_name, anchor_codes, reads, res,
                                     out_prefix, scores, score_fn, homo_genes,
                                     t0=al.start_ns / 1e9,
                                     align_s=al.seconds)

    def call_gene_cells(
        self,
        gene_name: str,
        anchor_codes: np.ndarray,
        cell_reads,  # Dict[str, ReadBatch] (insertion-ordered)
        out_prefix_for=None,   # cell -> out_prefix (or None)
        score_fn=None,
        failures: Optional[list] = None,
    ) -> Dict[str, GeneCallResult]:
        """Per-cell calling with the cells as ONE alignment batch.

        The reference's single-cell script aligns each cell serially
        (Anchored_Fusion_singlecell.py:205); here every cell's reads join one
        anchored-alignment batch, padded with PAD to the widest cell's row
        width, and the per-cell host stages consume row slices of the shared
        result.  The anchored aligner's diagonals and 128-wide block top-k
        depend on that width, so a cell narrower than the widest may align
        differently than alone.  The homolog mask is computed for the first
        cell that succeeds and reused (it only depends on the anchor and the
        genome).  With ``failures`` (a list), a cell whose host stages raise
        is recorded and skipped instead of sinking the cohort.
        """
        cells = list(cell_reads.items())
        if not cells:
            return {}
        out: Dict[str, GeneCallResult] = {}
        with span("call", pairs=sum(rb.n_pairs for _, rb in cells)):
            with timed("anchor_align",
                       reads=sum(2 * rb.n_pairs for _, rb in cells)) as al:
                R = max(rb.max_len for _, rb in cells)
                parts = []
                for _, rb in cells:
                    s = rb.seq.reshape(rb.n_pairs * 2, rb.max_len)
                    if rb.max_len < R:
                        s = np.concatenate(
                            [s, np.full((s.shape[0], R - rb.max_len), PAD,
                                        np.int8)], axis=1)
                    parts.append(s)
                offs = np.cumsum([0] + [p.shape[0] for p in parts])
                res_all = align_to_reference(
                    np.concatenate(parts), anchor_codes, self.cfg.align,
                    chunk=self.cfg.read_batch, device=self.device,
                    mesh=self.mesh)
            homo = None
            for i, (cell, rb) in enumerate(cells):
                sl = slice(offs[i], offs[i + 1])
                res_c = AlignmentResult(**{
                    f.name: getattr(res_all, f.name)[sl]
                    for f in dataclasses.fields(res_all)})
                prefix = out_prefix_for(cell) if out_prefix_for else None
                try:
                    with span("cell", pairs=rb.n_pairs):
                        r = self._call_stages(
                            gene_name, anchor_codes, rb, res_c, prefix, None,
                            score_fn, homo, t0=time.time(),
                            align_s=al.seconds * (offs[i + 1] - offs[i])
                            / max(int(offs[-1]), 1))
                except Exception as e:  # noqa: BLE001 - per-cell isolation
                    if failures is None:
                        raise
                    failures.append({"gene": f"{gene_name}:{cell}",
                                     "error": repr(e),
                                     "traceback": traceback.format_exc(),
                                     "attempts": 1})
                    continue
                homo = r.homo_genes
                out[cell] = r
        return out

    def _call_stages(
        self,
        gene_name: str,
        anchor_codes: np.ndarray,
        reads: ReadBatch,
        res,
        out_prefix: Optional[str] = None,
        scores: Optional[Sequence[float]] = None,
        score_fn=None,
        homo_genes: Optional[List[str]] = None,
        t0: Optional[float] = None,
        align_s: float = 0.0,
    ) -> GeneCallResult:
        """Stages 2-10 given the anchored-alignment result ``res``."""
        cfg = self.cfg
        ccfg = cfg.call
        counters: Dict[str, float] = {}
        t0 = t0 or time.time()
        # per-stage wall time and the stage spans (SURVEY §5 tracing: the
        # e2e reads/s number is host-stage-dominated; these say where)
        _mark = Stages(counters).mark

        n = reads.n_pairs
        R = reads.max_len
        seqs = reads.seq.reshape(n * 2, R)
        lens = reads.length.reshape(n * 2)

        kind, lclip, rclip = classify_clips(res, lens)
        counters["reads"] = n * 2
        counters["anchor_mapped"] = int(res.mapped.sum())
        counters["time.anchor_align_s"] = round(align_s, 4)

        # 2. half-mapped pairs -> genome (mate rescue; -f8/-f4 flag parity)
        m = res.mapped.reshape(n, 2)
        half = m[:, 0] ^ m[:, 1]
        half_ids = np.nonzero(half)[0]
        counters["half_mapped_pairs"] = len(half_ids)
        pair_hits: List[Tuple[str, List[Tuple[str, int, int]]]] = []
        if len(half_ids):
            sel = np.stack([2 * half_ids, 2 * half_ids + 1], axis=1).reshape(-1)
            gres = self.genome_aligner.align(seqs[sel])
            trim = ccfg.spanning_trim
            # vectorized global->(contig, 1-based) conversion for all mapped
            # mates at once (one searchsorted instead of a per-hit to_local)
            cid = np.searchsorted(self.genome.starts, gres.ref_start,
                                  side="right") - 1
            s1 = (gres.ref_start - self.genome.starts[cid] + 1).astype(np.int64)
            e1 = s1 + (gres.ref_end - gres.ref_start)
            mapped = np.asarray(gres.mapped)
            for i, pid in enumerate(half_ids):
                poses = [
                    (self.genome.names[int(cid[j])], int(s1[j]) + trim,
                     int(e1[j]) - trim)
                    for j in (2 * i, 2 * i + 1) if mapped[j]
                ]
                pair_hits.append((reads.names[pid], poses))

        _mark("mate_rescue")

        # 3. homolog mask (stage-cached: the reference persists the
        # equivalent _homo_genes.bed per gene, Anchored_Fusion.py:196-197)
        if homo_genes is None:
            from anchored_fusion_tpu_torch.utils.checkpoint import digest
            key = digest(np.asarray(anchor_codes), self.genome.total_length)
            homo_genes = self.cache.cached(
                "homolog", key,
                lambda: find_homolog_genes(self.genome_aligner, anchor_codes,
                                           self.gene_rows, self.genome))
        counters["homo_genes"] = len(homo_genes)
        _mark("homolog")

        # 4. clipped anchored reads -> genome multi-hits; rescue filter.  No
        # later stage reads another row: orient the clipped rows alone
        clipped = np.nonzero((kind == 2) | (kind == 3))[0]
        counters["clipped_reads"] = len(clipped)
        c_seqs = oriented_sequences(seqs, res.strand, rows=clipped)
        keep = np.ones(len(clipped), bool)
        ghits = None
        if len(clipped):
            with span("genome.align_multi", reads=len(clipped)):
                ghits = self.genome_aligner.align_multi(
                    c_seqs, min_score=FINE_BLOCK_PRESET.min_score,
                    min_identity=FINE_BLOCK_PRESET.min_identity,
                    min_seg_len=FINE_BLOCK_PRESET.min_seg_len)
            m_start = np.where(kind[clipped] == 2, res.read_start[clipped], 0)
            m_len = res.read_end[clipped] - res.read_start[clipped] + 1
            keep = rescue_filter(len(clipped), m_start, m_len, lens[clipped],
                                 ghits, ccfg)
        counters["clipped_kept"] = int(keep.sum())
        _mark("rescue")
        survivors = clipped[keep]
        c_names = [reads.names[i // 2] for i in clipped]

        # 5. blocks: spanning + fine
        blocks_chr = find_spanning_blocks(pair_hits, self.exon_index,
                                          homo_genes, ccfg)
        counters["spanning_blocks"] = sum(len(b) for b in blocks_chr.values())
        if ghits is not None and len(survivors):
            infos = []
            old_to_new = np.full(len(clipped), -1, np.int64)
            old_to_new[keep] = np.arange(len(survivors))
            for j in np.nonzero(keep)[0]:
                ci = clipped[j]
                if kind[ci] == 2:  # SM: clip then M
                    ll = int(res.read_start[ci])
                    rl = int(res.read_end[ci] - res.read_start[ci] + 1)
                    infos.append(ClippedReadInfo(c_names[j], "SM", ll, rl))
                else:              # MS: M then clip
                    ll = int(res.read_end[ci] + 1)
                    rl = int(lens[ci] - 1 - res.read_end[ci])
                    infos.append(ClippedReadInfo(c_names[j], "MS", ll, rl))
            # remap hit read ids onto the survivor list
            sel = old_to_new[ghits.read_id] >= 0
            remapped = dataclasses.replace(
                ghits,
                read_id=old_to_new[ghits.read_id][sel].astype(np.int32),
                strand=ghits.strand[sel], score=ghits.score[sel],
                matches=ghits.matches[sel], length=ghits.length[sel],
                q_start=ghits.q_start[sel], q_end=ghits.q_end[sel],
                ref_start=ghits.ref_start[sel], ref_end=ghits.ref_end[sel])
            blocks_chr = find_fine_blocks(infos, remapped, self.genome,
                                          self.exon_index, homo_genes,
                                          blocks_chr, ccfg)
        counters["blocks"] = sum(len(b) for b in blocks_chr.values())
        _mark("blocks")

        # 6. breakpoint clustering + consensus (rescue survivors only; the
        # clipped rows in read order, as every other kind is dropped there)
        kinds_f = np.where(keep, kind[clipped], 0)
        srs = extract_split_reads(c_names, c_seqs, lens[clipped], kinds_f,
                                  res.read_start[clipped],
                                  res.read_end[clipped],
                                  res.ref_start[clipped],
                                  res.ref_end[clipped], gene_name, ccfg)
        counters["split_reads"] = len(srs)
        clusters = merge_clusters(cluster_split_reads(srs), ccfg,
                                  device=self.device, mesh=self.mesh)
        counters["breakpoint_clusters"] = len(clusters)
        _mark("consensus")

        # 7. candidate regions + anchored-split validation
        regions = build_candidate_regions(blocks_chr, self.genome,
                                          anchor_codes, ccfg,
                                          device=self.device)
        counters["candidate_regions"] = len(regions.region_block)
        good = find_anchored_split(regions, clusters, self.exon_index,
                                   anchor_codes, ccfg, device=self.device)
        counters["good_breakpoints"] = len(good)
        _mark("anchored_split")

        # 8. candidate join + junction linearity
        candidates, cnt_max = find_candidate_genes(
            regions, good, clusters, self.genome_aligner, ccfg)
        counters["candidates"] = len(candidates)
        _mark("candidate_join")

        # 9. optional filter scoring
        filter_on = cfg.filter_false_positive and score_fn is not None
        score_list: List[float] = list(scores) if scores else []
        if filter_on and candidates:
            score_list = list(score_fn(candidates))
            for c, s in zip(candidates, score_list):
                c.score = float(s)

        # 10. report
        rows: List[dict] = []
        if out_prefix is not None:
            rows = write_final_fusion(out_prefix, candidates, gene_name,
                                      self.exon_index, score_list, cnt_max,
                                      filter_on, ccfg)
        counters["emitted"] = len(rows)
        _mark("report", last=True)
        counters["wall_s"] = time.time() - t0
        return GeneCallResult(rows, candidates, clusters, blocks_chr,
                              homo_genes, counters)
