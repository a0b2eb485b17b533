"""One-device genome aligner for references past the int32 coordinate range.

The hg38 operating point (3.1 Gbp): one MERGED k-mer index for the whole
genome, queried once per chunk, with two representation changes that keep
every device index inside int32:

  * **Hit positions** are stored as ``pos // index_stride`` ("pos_div").
    Positions of a strided index are stride multiples, so this is lossless
    and keeps hg38 (3.1e9 / 8 = 387.5M) inside int32.
  * **Extension windows** come from a 2-D tiled genome ``(T+1, C + 2*halo)``
    whose tile edges carry a halo of the neighbouring tiles: a window is
    ``tiles[row, col+halo : col+halo+R]`` with in-tile (int32) indices, and
    the halo (>= read width) makes windows that cross a tile edge whole.
    Diagonals are voted as (row, col) pairs (the seeding kernel's tile
    mode, ops/seed_vote_cuda.py) and extended in the extension kernel's
    tile mode (ops/anchor_cuda.py); the int64 fold ``row * C + col``
    happens on the host.

The index build runs one device build per genome slice (kmer.
build_shard_index_device) and merges them on the device: the global bucket
table is the sum of the slice tables, and each slice slot lands at
``iota + A_s[key]`` for a per-bucket offset vector ``A_s``, written in place
into one preallocated tensor.

With a mesh the index is replicated on every rank and each read batch is
split over ALL mesh axes (dp x mp ranks); the records are all-gathered in
read order (parallel/collectives.py).

Every record equals the JAX package's (``anchored_fusion_tpu/align/
genome_xl.py``).  Its compile-time workarounds (shape buckets, warm-up
programs, separate seed and extend programs, donation, nibble packing) are
not needed here and change no record.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from anchored_fusion_tpu_torch.config import AlignConfig
from anchored_fusion_tpu_torch.io.fasta import Reference
from anchored_fusion_tpu_torch.index.kmer import (
    build_shard_index_device, merge_sorted_pieces, read_kmer_offsets)
from anchored_fusion_tpu_torch.ops.anchor import TILE_FIELDS
from anchored_fusion_tpu_torch.ops.anchor_cuda import (
    extend_fold, extend_segments)
from anchored_fusion_tpu_torch.ops.encode import PAD
from anchored_fusion_tpu_torch.ops.seed_vote_cuda import seed_vote
from anchored_fusion_tpu_torch.align.aligner import (
    AlignmentResult, MultiHits, both_strands)
from anchored_fusion_tpu_torch.align.genome import GenomeAligner
from anchored_fusion_tpu_torch.utils.device import resolve_device


# Tile geometry: C genome columns per tile row plus a halo on each side, so
# any R-wide window whose diagonal lands in a row lies wholly inside it.  The
# halo bounds the widest query (_check_width): 768 covers the junction
# consensus batches (up to 512) and costs ~1.5 KB per 16M-column row.
TILE_C = 1 << 24
TILE_HALO = 768

_INT32_SAFE = 2 ** 31 - 2 ** 20


def build_tiles_host(codes: np.ndarray, C: int = TILE_C,
                     halo: int = TILE_HALO) -> np.ndarray:
    """(T+1, C + 2*halo) int8 tiled genome; the last row is all PAD, the
    row that empty (zero-vote) candidates read."""
    L = len(codes)
    T = -(-L // C)
    W = C + 2 * halo
    out = np.full((T + 1, W), PAD, np.int8)
    for t in range(T):
        lo = t * C - halo
        hi = t * C + C + halo
        src_lo, src_hi = max(0, lo), min(L, hi)
        out[t, src_lo - lo:src_hi - lo] = codes[src_lo:src_hi]
    return out


def build_index_xl(codes: np.ndarray, k: int, stride: int,
                   build_shards: Optional[int] = None, verbose: bool = False,
                   device="cuda"):
    """Merged global k-mer index, built slice by slice on ``device``.

    Returns (table (4^k+1,) int32, pos_div (total+1,) int32).  ``pos_div``
    is bucket-grouped with each bucket's entries in genome order (slice
    sorts are stable and slices merge in genome order).  Its last slot is a
    dump for the sentinel slots of N-holding windows: no lookup addresses it
    (``table[-1] == total``), and which sentinel lands there is unspecified.
    """
    device = resolve_device(device)
    L = len(codes)
    n = L - k + 1
    if build_shards is None:
        # each slice's sort temporaries (~16 B a key) sit beside the merged
        # output: ~260M keys a slice, as in the JAX package
        build_shards = max(1, -(-(n // stride) // 260_000_000))
    per = -(-n // build_shards)
    per = -(-per // stride) * stride              # stride-aligned slices
    assert per + k - 1 <= _INT32_SAFE

    tables, parts = [], []                        # parts: (keys, pos_div)
    for s in range(0, n, per):
        dev = torch.from_numpy(np.asarray(codes[s:min(L, s + per + k - 1)],
                                          np.int8)).to(device)
        ks, ps, tb = build_shard_index_device(dev, k, k, stride,   # kb == k
                                              keep_keys=True)
        del dev
        # ps = local order * stride; global pos_div = s // stride + order
        pos_div = ps // stride + s // stride
        del ps
        tables.append(tb)
        parts.append((ks, pos_div))
        if verbose:
            print(f"[xl-build] slice @{s}: {pos_div.shape[0]} slots")
    table = tables[0] if len(tables) == 1 else torch.stack(tables).sum(
        0, dtype=torch.int32)
    total = sum(int(p.shape[0]) for _, p in parts)
    merged = torch.zeros(total + 1, dtype=torch.int32, device=device)
    pieces = [(ks, tb, [pos_div]) for (ks, pos_div), tb in zip(parts, tables)]
    del parts, tables, ks, pos_div, tb
    # sentinel slots all go to the dump slot ``total``
    merge_sorted_pieces(pieces, table, [merged], dump=total)
    return table, merged


def _xl_seed_core(reads, table, pos_div, read_offsets, k: int, kb: int,
                  stride_idx: int, stride_q: int, max_hits: int, top_k: int,
                  T: int, C: int):
    """Hit gather and vote: (B, R) reads -> (rows (2B, top_k), cols (2B,
    top_k)) int32 candidates; empty slots take the all-PAD row T.  One
    launch of the seeding kernel (ops/seed_vote_cuda.py) in tile mode."""
    flat, _ = both_strands(reads)
    return seed_vote(flat, table, table[:1], pos_div, read_offsets, k, kb,
                     stride_q, max_hits, top_k,
                     tile=(C // stride_idx, stride_idx, T))


XL_FIELDS = TILE_FIELDS


def _xl_extend_core(reads, tiles, rows_c, cols_c, top_k: int, match: int,
                    mismatch: int, halo: int) -> torch.Tensor:
    """Extend and fold the strands: (10, B) int32 rows of XL_FIELDS (the
    host folds ``ref = row * C + col`` in int64), through the extension
    kernel's tile mode (ops/anchor_cuda.py::extend_fold)."""
    flat, coord_off = both_strands(reads)
    rec = extend_fold(flat, coord_off, tiles, halo, match, mismatch, top_k,
                      offs=cols_c, rows=rows_c)
    return torch.stack([rec[f] for f in XL_FIELDS])


def _xl_multi_extend_core(reads, tiles, rows_c, cols_c, match: int,
                          mismatch: int, halo: int) -> torch.Tensor:
    """All-hits extension: (7, 2B, top_k) int32 candidates (score, start,
    end, matches, length, row, col), through the extension kernel's
    segments mode over the tiles (ops/anchor_cuda.py::extend_segments)."""
    flat, _ = both_strands(reads)
    seg = extend_segments(flat, tiles, halo, match, mismatch, offs=cols_c,
                          rows=rows_c)
    return torch.stack([seg["score"], seg["start"], seg["end"],
                        seg["matches"], seg["length"], rows_c,
                        cols_c]).to(torch.int32)


class GenomeAlignerXL:
    """Genome aligner with a merged stride-scaled index.

    Takes GenomeAligner's place past the int32 coordinate range; needs
    ``L / cfg.index_stride`` inside int32 (hg38 needs stride >= 2).  With
    ``mesh`` every rank holds the whole index on its ``device`` and aligns
    its share of each batch.
    """

    def __init__(self, reference: Reference, cfg: Optional[AlignConfig] = None,
                 tile_c: int = TILE_C, halo: int = TILE_HALO,
                 verbose: bool = False, device="cuda", mesh=None):
        self.mesh = mesh
        self.cfg = cfg or AlignConfig()
        self.device = resolve_device(device)
        self.reference = reference
        self.k = self.cfg.genome_kmer
        self.index_stride = max(1, self.cfg.index_stride)
        self.stride = self.cfg.resolved_query_stride()
        L = reference.total_length
        if L // self.index_stride >= _INT32_SAFE:
            raise ValueError(
                f"L/index_stride = {L // self.index_stride} exceeds int32; "
                "raise AlignConfig.index_stride")
        if tile_c % self.index_stride:
            raise ValueError("tile_c must be a multiple of index_stride")
        self.C = tile_c
        self.halo = halo
        # reads the two-pass gate sent to the rescue pass in the last align
        self.last_rescued = 0
        codes = np.asarray(reference.seq)
        self.table, self.pos_div = build_index_xl(
            codes, self.k, self.index_stride, verbose=verbose,
            device=self.device)
        self.tiles = torch.from_numpy(build_tiles_host(codes, tile_c, halo)).to(
            self.device)

    @staticmethod
    def _trim_width(seqs: np.ndarray) -> np.ndarray:
        """Drop PAD-only tail columns of 128-wide batches down to 112.

        Reads are left-aligned and Illumina reads of 101 bp sit in 128-wide
        rows, so the dropped k-mer offsets are PAD-invalid for every read
        and window and strand coordinates are width-consistent: the records
        do not change, and the seed and window work shrink by 12.5%.
        """
        if seqs.shape[1] != 128:
            return seqs
        return seqs if (seqs[:, 112:] != PAD).any() else seqs[:, :112]

    def _check_width(self, R: int):
        """A query wider than the tile halo would get a clipped, shifted
        window: raise instead."""
        if R > self.halo:
            raise ValueError(
                f"query width {R} exceeds the tile halo {self.halo}; "
                "construct GenomeAlignerXL with halo >= the widest query "
                "batch (consensus batches reach 512)")

    def _prepare(self, seqs: np.ndarray) -> np.ndarray:
        seqs = self._trim_width(GenomeAligner._even_width(seqs))
        self._check_width(seqs.shape[1])
        return seqs

    def _seed(self, reads: torch.Tensor, offsets: torch.Tensor, top_k: int,
              max_hits: int):
        return _xl_seed_core(reads, self.table, self.pos_div, offsets,
                             k=self.k, kb=self.k,
                             stride_idx=self.index_stride,
                             stride_q=self.stride, max_hits=max_hits,
                             top_k=top_k, T=self.tiles.shape[0] - 1, C=self.C)

    def _offsets(self, R: int) -> torch.Tensor:
        return torch.from_numpy(read_kmer_offsets(R, self.k, self.stride)).to(
            self.device)

    def _align_raw(self, seqs: np.ndarray, top_k: int, max_hits: int,
                   chunk: int) -> np.ndarray:
        """Chunked seed and extend of ``seqs`` at one (top_k, max_hits)
        operating point: (10, B) host rows of XL_FIELDS.  With a mesh each
        rank takes its rows and the rows are all-gathered."""
        if self.mesh is not None:
            from anchored_fusion_tpu_torch.parallel.collectives import (
                map_rows_array)
            return map_rows_array(
                self.mesh, seqs,
                lambda s: self._align_raw_local(s, top_k, max_hits, chunk),
                axes=(0, 1))
        return self._align_raw_local(seqs, top_k, max_hits, chunk)

    def _align_raw_local(self, seqs: np.ndarray, top_k: int, max_hits: int,
                         chunk: int) -> np.ndarray:
        cfg = self.cfg
        if not len(seqs):
            return np.zeros((len(XL_FIELDS), 0), np.int32)
        offsets = self._offsets(seqs.shape[1])
        outs = []
        for lo in range(0, seqs.shape[0], chunk):
            reads = torch.from_numpy(seqs[lo:lo + chunk]).to(self.device)
            rows_c, cols_c = self._seed(reads, offsets, top_k, max_hits)
            outs.append(_xl_extend_core(
                reads, self.tiles, rows_c, cols_c, top_k=top_k,
                match=cfg.match_score, mismatch=cfg.mismatch_penalty,
                halo=self.halo))
        return torch.cat(outs, dim=1).cpu().numpy()

    def align(self, seqs: np.ndarray, min_score: Optional[int] = None,
              min_identity: float = 0.0, min_seg_len: Optional[int] = None,
              top_k: Optional[int] = None, max_hits: Optional[int] = None,
              chunk: int = 8192) -> AlignmentResult:
        cfg = self.cfg
        # as in the JAX engine, 0 means the default here (the flat engine
        # tests `is None`)
        min_score = min_score or cfg.min_align_score
        min_seg_len = min_seg_len or cfg.min_seg_len
        # an explicit top_k/max_hits pins that single-pass operating point;
        # two-pass seeding applies only to default-parameter calls
        explicit = top_k is not None or max_hits is not None
        top_k = top_k or cfg.top_diagonals
        max_hits = max_hits or cfg.max_hits_per_kmer
        seqs = self._prepare(seqs)
        R = seqs.shape[1]
        self.last_rescued = 0
        if cfg.xl_two_pass and not explicit:
            # pass 1 at the cheap point for every read; H-capped buckets and
            # the smaller top-k only ever LOWER a read's best score, so the
            # confidence gate sends exactly the affected reads to the rescue
            arr = self._align_raw(seqs, cfg.xl_pass1_top_k,
                                  cfg.xl_pass1_hits, chunk)
            lens = (seqs != PAD).sum(axis=1)
            need = np.ceil(cfg.xl_confident_frac
                           * np.minimum(lens, R) * cfg.match_score)
            conf = (arr[0] >= need) & (arr[5] >= min_seg_len)
            idx = np.nonzero(~conf)[0]
            self.last_rescued = len(idx)
            if len(idx):
                arr2 = self._align_raw(seqs[idx], cfg.xl_rescue_top_k,
                                       cfg.xl_rescue_hits, min(chunk, 4096))
                # keep the per-read BEST of the two passes
                upd = arr2[0] > arr[0, idx]
                arr[:, idx[upd]] = arr2[:, upd]
        else:
            arr = self._align_raw(seqs, top_k, max_hits, chunk)
        f = {n: arr[i] for i, n in enumerate(XL_FIELDS)}
        base = f["row"].astype(np.int64) * self.C
        length = f["length"]
        matches = f["matches"]
        ident = matches / np.maximum(length, 1)
        mapped = ((f["score"] >= min_score) & (length >= min_seg_len)
                  & (ident >= min_identity))
        L = self.reference.total_length
        res = AlignmentResult(
            score=f["score"].astype(np.int32),
            strand=f["strand"].astype(np.int8),
            read_start=f["read_start"].astype(np.int32),
            read_end=f["read_end"].astype(np.int32),
            ref_start=np.clip(base + f["col_start"], 0, L - 1),
            ref_end=np.clip(base + f["col_end"], 0, L - 1),
            matches=matches.astype(np.int32),
            length=length.astype(np.int32),
            second_score=f["second_score"].astype(np.int32),
            mapped=mapped,
        )
        if cfg.gapped_refine:
            from anchored_fusion_tpu_torch.align.refine import refine_result
            res = refine_result(res, seqs, self.reference.seq, cfg,
                                min_score, min_identity, min_seg_len,
                                self.device)
        return res

    def align_multi(self, seqs: np.ndarray, min_score: int = 20,
                    min_identity: float = 0.0, min_seg_len: int = 10,
                    top_k: int = 8, max_hits: Optional[int] = None,
                    chunk: int = 4096) -> MultiHits:
        """All-hits genome alignment.  Hits come chunk by chunk,
        strand-major inside a chunk, as in the JAX engine.  With a mesh the
        chunks are split over every rank and gathered in chunk order."""
        max_hits = max_hits or self.cfg.max_hits_per_kmer
        seqs = self._prepare(seqs)
        R = seqs.shape[1]
        offsets = self._offsets(R)
        starts = list(range(0, seqs.shape[0], chunk))
        mine = starts
        if self.mesh is not None:
            from anchored_fusion_tpu_torch.parallel.mesh import row_shard
            mine = starts[row_shard(self.mesh, len(starts), (0, 1))[0]]
        parts = []
        for lo in mine:
            sub = seqs[lo:lo + chunk]
            reads = torch.from_numpy(sub).to(self.device)
            rows_c, cols_c = self._seed(reads, offsets, top_k, max_hits)
            st = _xl_multi_extend_core(
                reads, self.tiles, rows_c, cols_c,
                match=self.cfg.match_score,
                mismatch=self.cfg.mismatch_penalty, halo=self.halo)
            parts.append(self._collect_multi(lo, sub, st.cpu().numpy(),
                                             top_k, min_score, min_identity,
                                             min_seg_len, R))
        if self.mesh is not None:
            from anchored_fusion_tpu_torch.parallel.collectives import (
                gather_objects)
            parts = [p for ps in gather_objects(parts) for p in ps]
        return MultiHits(**{
            f.name: np.concatenate([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(MultiHits)})

    def _collect_multi(self, lo, sub, arr, top_k, min_score, min_identity,
                       min_seg_len, R) -> MultiHits:
        """One chunk's (7, 2B, k) candidates -> filtered MultiHits in the
        forward query frame, identical (strand, diagonal, start) candidates
        deduplicated."""
        score, start, end, matches, length, row, col = arr
        Bc = arr.shape[1] // 2
        read_lens = (sub != PAD).sum(axis=1).astype(np.int32)
        lens = read_lens[None, :, None]
        sc = score.reshape(2, Bc, top_k)
        stt = start.reshape(2, Bc, top_k)
        enn = end.reshape(2, Bc, top_k)
        mtt = matches.reshape(2, Bc, top_k)
        lnn = length.reshape(2, Bc, top_k)
        rww = row.reshape(2, Bc, top_k).astype(np.int64)
        cll = col.reshape(2, Bc, top_k).astype(np.int64)
        ident = mtt / np.maximum(lnn, 1)
        keep = ((sc >= min_score) & (lnn >= min_seg_len)
                & (ident >= min_identity))
        gpos = rww * self.C + cll                 # global col of read pos 0
        # split votes at tile edges and adjacent seeds converge on the same
        # segment: drop repeats of (strand, diagonal, start)
        srt = np.argsort(gpos, axis=2, kind="stable")
        g_s = np.take_along_axis(gpos, srt, 2)
        s_s = np.take_along_axis(stt, srt, 2)
        dup = np.zeros_like(keep)
        dup[:, :, 1:] = (g_s[:, :, 1:] == g_s[:, :, :-1]) & \
            (s_s[:, :, 1:] == s_s[:, :, :-1])
        undup = np.ones_like(keep)
        np.put_along_axis(undup, srt, ~dup, 2)
        keep &= undup
        s_idx, b_idx, _ = np.nonzero(keep)
        strand = s_idx.astype(np.int8)
        rs_raw, re_raw = stt[keep], enn[keep]
        ln = np.broadcast_to(lens, sc.shape)[keep]
        pad = np.where(strand == 1, R - ln, 0)
        rs = rs_raw - pad
        re = re_raw - pad
        L = self.reference.total_length
        return MultiHits(
            read_id=(b_idx + lo).astype(np.int32),
            strand=strand,
            score=sc[keep].astype(np.int32),
            matches=mtt[keep].astype(np.int32),
            length=lnn[keep].astype(np.int32),
            q_start=np.where(strand == 0, rs, ln - 1 - re).astype(np.int32),
            q_end=np.where(strand == 0, re, ln - 1 - rs).astype(np.int32),
            ref_start=np.clip(gpos[keep] + rs_raw, 0, L - 1),
            ref_end=np.clip(gpos[keep] + re_raw, 0, L - 1),
        )
