"""Genome-scale read alignment: k-mer seeding + Kadane extension.

The genome-side counterpart of ``align_to_reference``: seeds come from the
sorted k-mer index (index/kmer.py) instead of the all-diagonal product; the
extension path (Kadane over gathered windows, strand folding: the
extension kernel's offsets mode, ops/anchor_cuda.py::extend_fold) is shared
with the small-reference engine, so both emit identical AlignmentResult
records.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from anchored_fusion_tpu_torch.config import AlignConfig
from anchored_fusion_tpu_torch.io.fasta import Reference
from anchored_fusion_tpu_torch.index.kmer import (
    KmerIndex, bucket_bits_for, build_shard_index_device, read_kmer_offsets)
from anchored_fusion_tpu_torch.ops.encode import PAD
from anchored_fusion_tpu_torch.align.aligner import (
    REF_PREPAD, MultiHits, both_strands, concat_records,
    extend_diagonals_all, _flatten_multi, records_to_result, to_numpy)
from anchored_fusion_tpu_torch.ops.anchor_cuda import extend_fold
from anchored_fusion_tpu_torch.ops.seed_vote_cuda import seed_vote
from anchored_fusion_tpu_torch.utils.device import resolve_device
from anchored_fusion_tpu_torch.utils.log import count


def _seed_diagonals(flat, index: KmerIndex, offsets, stride: int,
                    max_hits: int, top_k: int):
    """Shared seeding: strided k-mer keys -> table hit lookup -> diagonal
    vote, as one launch of the seeding kernel (ops/seed_vote_cuda.py) in
    diag mode.

    Returns (2B, top_k) int32 candidate ref offsets of read position 0
    (ops/seed_vote.py EMPTY_DIAG for empty vote slots).
    """
    return seed_vote(flat, index.table, index.keys_sorted, index.pos_sorted,
                     offsets, index.k, index.kb, stride, max_hits, top_k)


class GenomeAligner:
    """Holds the genome codes + k-mer index on one device and aligns reads."""

    def __init__(self, reference: Reference, cfg: Optional[AlignConfig] = None,
                 kmer: Optional[int] = None, stride: Optional[int] = None,
                 device="cuda", index: Optional[KmerIndex] = None,
                 device_build: Optional[bool] = None, mesh=None):
        """``index``: a prebuilt index (see state.kmer_index_from_numpy)
        instead of building one from ``reference``.  ``device_build``: build
        the index on ``device`` (build_shard_index_device) instead of on the
        host; by default past 200,000,000 bp, where the host sort
        dominates.  ``mesh`` (parallel/mesh.py): every rank holds the index
        on its ``device`` and ``align`` splits each batch over the mesh's dp
        axis, its records all-gathered in read order."""
        self.cfg = cfg or AlignConfig()
        self.mesh = mesh
        self.device = resolve_device(device)
        self.reference = reference
        L = reference.total_length
        if L > 2**31 - 2**20:
            raise ValueError(
                f"genome is {L} bp (> int32 coordinate range); the flat "
                "engine keeps int32 genome positions")
        self.k = kmer or self.cfg.genome_kmer
        self.index_stride = self.cfg.index_stride
        self.stride = stride or self.cfg.resolved_query_stride()
        self.ref_prepad = REF_PREPAD
        codes = torch.from_numpy(np.asarray(reference.seq, np.int8)).to(
            self.device)
        if index is None:
            if device_build is None:
                device_build = L > 200_000_000
            if device_build:
                # kb is sized on every window, N-holding ones included
                m = -(-(L - self.k + 1) // self.index_stride)
                kb = bucket_bits_for(m, self.k)
                ks, ps, tb = build_shard_index_device(codes, self.k, kb,
                                                      self.index_stride)
                if ks is None:
                    ks = torch.zeros(1, dtype=torch.int32, device=self.device)
                index = KmerIndex(k=self.k, kb=kb, table=tb, keys_sorted=ks,
                                  pos_sorted=ps, ref_len=L)
            else:
                index = KmerIndex.build(reference.seq, self.k, self.device,
                                        stride=self.index_stride)
        elif index.k != self.k:
            raise ValueError(f"index k={index.k} != aligner k={self.k}")
        self.index = index
        # codes are stored PREPADDED (REF_PREPAD each side) so extension can
        # gather windows directly; positions in the index stay genome-frame
        pad = torch.full((self.ref_prepad,), PAD, dtype=torch.int8,
                         device=self.device)
        self.codes = torch.cat([pad, codes, pad])

    @staticmethod
    def _even_width(seqs: np.ndarray) -> np.ndarray:
        # The JAX engine pads odd read widths by one PAD column; the read
        # k-mer offsets and refine windows depend on the width, so the port
        # keeps the same width to give the same records.
        seqs = np.asarray(seqs, dtype=np.int8)
        if seqs.ndim == 1:
            seqs = seqs[None]
        if seqs.shape[1] % 2:
            seqs = np.concatenate(
                [seqs, np.full((seqs.shape[0], 1), PAD, np.int8)], axis=1)
        return seqs

    def _offsets(self, R: int) -> torch.Tensor:
        return torch.from_numpy(
            read_kmer_offsets(R, self.k, self.stride)).to(self.device)

    def align(self, seqs: np.ndarray, min_score: Optional[int] = None,
              min_identity: float = 0.0, min_seg_len: Optional[int] = None,
              top_k: Optional[int] = None, max_hits: Optional[int] = None,
              chunk: int = 8192):
        """Best-hit genome alignment; an AlignmentResult per read."""
        if self.mesh is not None:
            from anchored_fusion_tpu_torch.parallel.collectives import map_rows
            return map_rows(self.mesh, self._even_width(seqs),
                            lambda s: self._align(s, min_score, min_identity,
                                                  min_seg_len, top_k,
                                                  max_hits, chunk))
        return self._align(seqs, min_score, min_identity, min_seg_len, top_k,
                           max_hits, chunk)

    def _align(self, seqs, min_score, min_identity, min_seg_len, top_k,
               max_hits, chunk):
        cfg = self.cfg
        if min_score is None:
            min_score = cfg.min_align_score
        if min_seg_len is None:
            min_seg_len = cfg.min_seg_len
        top_k = top_k or cfg.top_diagonals
        max_hits = max_hits or cfg.max_hits_per_kmer
        seqs = self._even_width(seqs)
        B, R = seqs.shape
        offsets = self._offsets(R)
        outs = []
        for lo in range(0, B, chunk):
            reads = torch.from_numpy(seqs[lo:lo + chunk]).to(self.device)
            flat, coord_off = both_strands(reads)
            offs = _seed_diagonals(flat, self.index, offsets, self.stride,
                                   max_hits, top_k)
            outs.append(extend_fold(flat, coord_off, self.codes,
                                    self.ref_prepad, cfg.match_score,
                                    cfg.mismatch_penalty, top_k, offs=offs))
        res = records_to_result(concat_records(outs), min_score,
                                min_identity, min_seg_len)
        if cfg.gapped_refine:
            from anchored_fusion_tpu_torch.align.refine import refine_result
            res = refine_result(res, seqs, self.reference.seq, cfg,
                                min_score, min_identity, min_seg_len,
                                self.device)
        return res

    def align_multi(self, seqs: np.ndarray, min_score: int = 20,
                    min_identity: float = 0.0, min_seg_len: int = 10,
                    top_k: int = 8, max_hits: Optional[int] = None,
                    chunk: int = 1024) -> MultiHits:
        """All-hits genome alignment (one BLAT pass over the genome)."""
        cfg = self.cfg
        max_hits = max_hits or cfg.max_hits_per_kmer
        seqs = self._even_width(seqs)
        B, R = seqs.shape
        offsets = self._offsets(R)
        count("genome.align_multi", chunks=-(-B // chunk))
        parts = []
        for lo in range(0, B, chunk):
            sub = seqs[lo:lo + chunk]
            flat, _ = both_strands(torch.from_numpy(sub).to(self.device))
            offs = _seed_diagonals(flat, self.index, offsets, self.stride,
                                   max_hits, top_k)
            seg = extend_diagonals_all(flat, self.codes, offs,
                                       cfg.match_score, cfg.mismatch_penalty,
                                       ref_prepad=self.ref_prepad)
            seg["off"] = offs
            read_lens = (sub != PAD).sum(axis=1).astype(np.int32)
            mh = _flatten_multi(to_numpy(seg), read_lens, sub.shape[0], top_k,
                                min_score, min_identity, min_seg_len, R)
            mh.read_id += lo
            parts.append(mh)
        return MultiHits(**{
            f.name: np.concatenate([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(MultiHits)})
