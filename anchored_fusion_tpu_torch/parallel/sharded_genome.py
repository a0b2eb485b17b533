"""Genome k-mer index split into shards, aligned on one device.

The capacity engine for genomes whose strided index positions pass int32
(hg38 with a dense index): each shard owns a contiguous genome slice plus
``overlap`` bp of the next, so an alignment that crosses a boundary is found
whole by the shard on its left.  A shard holds the k-mer index of its slice
with slice-LOCAL int32 positions and its prepadded codes; every read chunk is
aligned against each shard in turn, the best-scoring shard wins per read
(first maximum on a tie), and the fold to global int64 coordinates happens on
the host.

With a mesh the shards are split over its mp axis: mp rank s builds and
holds shard s alone, every rank aligns the whole (replicated) batch against
its shard, and an ``all_gather`` over mp stacks the shards' results in shard
order, so the best-hit reduce and the multi-hit fold are the one-device ones
and keep their tie order.

Every record equals the JAX package's (``anchored_fusion_tpu/parallel/
sharded_genome.py``).  Its batch padding, grouped result pulls and jitted
per-shard wrappers serve the TPU runtime and change no record.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from anchored_fusion_tpu_torch.config import AlignConfig
from anchored_fusion_tpu_torch.io.fasta import Reference
from anchored_fusion_tpu_torch.index.kmer import (
    KmerIndex, build_index_arrays, build_shard_index_device, bucket_bits_for,
    pack_read_kmers_strided, read_kmer_offsets)
from anchored_fusion_tpu_torch.ops.encode import PAD
from anchored_fusion_tpu_torch.align.aligner import (
    REF_PREPAD, RESULT_FIELDS, AlignmentResult, MultiHits, both_strands,
    extend_diagonals, extend_diagonals_all, fold_strands, _flatten_multi,
    to_numpy)
from anchored_fusion_tpu_torch.align.genome import _seed_diagonals
from anchored_fusion_tpu_torch.utils.device import resolve_device


def _prepadded(seq: torch.Tensor) -> torch.Tensor:
    """Shard codes with REF_PREPAD PAD codes each side, so extension gathers
    windows in place (shard-local frame)."""
    pad = torch.full((REF_PREPAD,), PAD, dtype=torch.int8, device=seq.device)
    return torch.cat([pad, seq, pad])


def _build_shard_arrays(codes: np.ndarray, n_shards: int, k: int,
                        overlap: int, stride: int = 1):
    """Host build: split the genome into equal slices (+ overlap) and index
    each one.  All shards share one bucket width ``kb``, sized for the
    largest shard.  Returns stacked (keys, pos, tables, prepadded seqs),
    the shard offsets (int64) and kb; keys pad with INT32_MAX, pos with 0."""
    L = len(codes)
    per = -(-L // n_shards)
    kb = bucket_bits_for((per + overlap) // stride, k)
    keys_list, pos_list, tbl_list, seq_list, offsets = [], [], [], [], []
    for s in range(n_shards):
        lo = s * per
        sl = codes[lo:min(L, (s + 1) * per + overlap)]
        kv, pos, table, _ = build_index_arrays(sl, k, stride=stride, kb=kb)
        keys_list.append(kv)
        pos_list.append(pos)
        tbl_list.append(table)
        seq_list.append(sl)
        offsets.append(lo)
    S = n_shards
    max_m = max(len(kv) for kv in keys_list)
    max_s = max(len(sl) for sl in seq_list)
    keys_arr = np.full((S, max_m), np.iinfo(np.int32).max, np.int32)
    pos_arr = np.zeros((S, max_m), np.int32)
    seq_arr = np.full((S, max_s + 2 * REF_PREPAD), PAD, np.int8)
    for s in range(S):
        keys_arr[s, :len(keys_list[s])] = keys_list[s]
        pos_arr[s, :len(pos_list[s])] = pos_list[s]
        seq_arr[s, REF_PREPAD:REF_PREPAD + len(seq_list[s])] = seq_list[s]
    return (keys_arr, pos_arr, np.stack(tbl_list), seq_arr,
            np.asarray(offsets, np.int64), kb)


def _build_shard_arrays_on_device(codes: np.ndarray, n_shards: int, k: int,
                                  overlap: int, stride: int, device,
                                  which=None):
    """Device build (the hg38 path): each shard's codes go to the device
    once, padded with PAD to one width, and are keyed, sorted and tabled
    there (kmer.build_shard_index_device).  Returns ([(KmerIndex, prepadded
    codes)] per shard built, offsets (int64) of all shards, kb); ``which``
    limits the build to those shard ids."""
    L = len(codes)
    per = -(-L // n_shards)
    kb = bucket_bits_for((per + overlap) // stride, k)
    width = per + overlap
    shards = []
    offsets = [s * per for s in range(n_shards)]
    for s in (range(n_shards) if which is None else which):
        lo = s * per
        sl = np.asarray(codes[lo:min(L, lo + width)], np.int8)
        if len(sl) < width:
            sl = np.concatenate([sl, np.full(width - len(sl), PAD, np.int8)])
        dev = torch.from_numpy(sl).to(device)
        ks, ps, tb = build_shard_index_device(dev, k, kb, stride)
        if ks is None:                 # exact table: the lookup skips keys
            ks = torch.zeros(1, dtype=torch.int32, device=device)
        shards.append((KmerIndex(k=k, kb=kb, table=tb, keys_sorted=ks,
                                 pos_sorted=ps, ref_len=width),
                       _prepadded(dev)))
        del dev
    return shards, np.asarray(offsets, np.int64), kb


def _shard_best(reads, read_offsets, shard, stride: int, max_hits: int,
                top_k: int, match: int, mismatch: int) -> dict:
    """Best alignment of every read against ONE shard's slice; reference
    coordinates stay shard-local int32."""
    index, seq = shard
    flat, coord_off = both_strands(reads)
    offs = _seed_diagonals(flat, index, read_offsets, stride, max_hits, top_k)
    cand = extend_diagonals(flat, seq, offs, match, mismatch,
                            ref_prepad=REF_PREPAD)
    return fold_strands(cand, reads.shape[0], coord_off)


def _reduce_best(per_shard: dict) -> dict:
    """Keep the best-scoring shard hit per read: fields (S, B) -> (B,).  The
    first maximum wins a tie; the winning shard rides along as 'shard', so
    the host can fold local coordinates to global ones in int64."""
    best = torch.argmax(per_shard["score"], dim=0)          # (B,)
    out = {n: torch.gather(v, 0, best[None])[0] for n, v in per_shard.items()}
    out["shard"] = best.to(torch.int32)
    return out


def _reduce_shard_stack(parts: list) -> dict:
    """Per-shard result dicts (ascending shard order) -> best per read."""
    return _reduce_best({n: torch.stack([p[n].to(torch.int32) for p in parts])
                         for n in RESULT_FIELDS})


# Per-chunk seed workspace budget (bytes).  One chunk's live set is led by
# the (2B, Q*H) int32 diagonal matrix and its sort buffers (~5 int32
# temporaries); the chunk is sized so it stays under the budget however
# dense the query side (a strided index drops the query stride to 1).
_WORKSPACE_BUDGET = 512 * 2**20
_TEMP_BYTES = 20


def _seed_chunk(Q: int, max_hits: int, cap: int) -> int:
    """Largest 128-multiple chunk whose seed workspace fits the budget."""
    per_read = 2 * Q * max_hits * _TEMP_BYTES
    chunk = int(_WORKSPACE_BUDGET // max(per_read, 1))
    return max(256, min(cap, (chunk // 128) * 128))


def _pack_query_kmers(reads, k: int, stride: int):
    """Both-strand query k-mer keys, packed once per chunk and shared by
    every shard's seed-evidence count."""
    flat, _ = both_strands(reads)
    return pack_read_kmers_strided(flat, k, stride)


def _count_from_keys(rk, kvalid, tbl, k: int, kb: int, max_hits: int):
    """Per-read seed evidence in ONE shard: the sum over query k-mers (both
    strands) of the H-capped bucket size, from two table gathers.  With
    kb < k a bucket holds several keys and the count over-estimates, which
    only routes a read to more shards."""
    bucket = rk >> (2 * (k - kb)) if kb < k else rk
    bucket = torch.clamp(bucket, 0, tbl.shape[0] - 2).long()
    n = torch.clamp(tbl[bucket + 1] - tbl[bucket], max=max_hits)
    c = torch.where(kvalid, n, 0).sum(dim=1, dtype=torch.int32)   # (2B,)
    B = c.shape[0] // 2
    return c[:B] + c[B:]


def _shard_multi(reads, read_offsets, shard, stride: int, max_hits: int,
                 top_k: int, match: int, mismatch: int) -> dict:
    """All-hits alignment against ONE shard: (2B, top_k) candidates in
    shard-local coordinates ('off'); empty slots keep the far-negative
    sentinel offset and score 0, so the flatten's min_score drops them."""
    index, seq = shard
    flat, _ = both_strands(reads)
    offs = _seed_diagonals(flat, index, read_offsets, stride, max_hits, top_k)
    seg = extend_diagonals_all(flat, seq, offs, match, mismatch,
                               ref_prepad=REF_PREPAD)
    seg["off"] = offs
    return seg


class ShardedGenomeAligner:
    """Genome alignment over a sharded k-mer index: on one device every
    chunk is aligned against each shard in turn; with ``mesh`` each mp rank
    holds one shard (``n_shards`` must equal the mp size) and the shards'
    results are all-gathered (module docstring)."""

    def __init__(self, reference: Reference, n_shards: int,
                 cfg: Optional[AlignConfig] = None, overlap: int = 512,
                 mesh=None, device_build: Optional[bool] = None,
                 device="cuda", prebuilt=None):
        """``prebuilt``: the tuple ``_build_shard_arrays`` returns (keys,
        pos, tables, seqs, offsets, kb), which is then only placed on
        ``device``, so a harness can time the host build apart from the
        placement."""
        if mesh is not None and mesh.size(1) != n_shards:
            raise ValueError(f"n_shards {n_shards} != the mesh's mp size "
                             f"{mesh.size(1)}")
        self.mesh = mesh
        # the shards this rank holds: all of them, or its mp coordinate's
        self.shard_ids = (list(range(n_shards)) if mesh is None
                          else [mesh.get_local_rank(1)])
        self.cfg = cfg or AlignConfig()
        self.device = resolve_device(device)
        self.reference = reference
        self.n_shards = n_shards
        self.k = self.cfg.genome_kmer
        self.index_stride = self.cfg.index_stride
        self.stride = self.cfg.resolved_query_stride()
        if device_build is None:
            # past ~200 Mbp the host sort dominates: build on the device
            device_build = (prebuilt is None
                            and reference.total_length > 200_000_000)
        codes = np.asarray(reference.seq)
        if device_build and prebuilt is None:
            self.shards, offs, self.kb = _build_shard_arrays_on_device(
                codes, n_shards, self.k, overlap, self.index_stride,
                self.device, self.shard_ids)
        else:
            keys, pos, tbl, seq, offs, self.kb = (
                prebuilt if prebuilt is not None else _build_shard_arrays(
                    codes, n_shards, self.k, overlap,
                    stride=self.index_stride))
            self.shards = [
                (KmerIndex.from_arrays(keys[s], pos[s], tbl[s], self.k,
                                       self.kb, seq.shape[1], self.device),
                 torch.from_numpy(seq[s]).to(self.device))
                for s in self.shard_ids]
        # shard offsets stay on the host in int64: a device-side fold would
        # pass int32 beyond ~2.1 Gbp of genome
        self.host_offs = np.asarray(offs, np.int64)

    def _kw(self, top_k: int, max_hits: int) -> dict:
        return dict(stride=self.stride, max_hits=max_hits, top_k=top_k,
                    match=self.cfg.match_score,
                    mismatch=self.cfg.mismatch_penalty)

    def _offsets(self, R: int) -> torch.Tensor:
        return torch.from_numpy(read_kmer_offsets(R, self.k, self.stride)).to(
            self.device)

    def align(self, seqs: np.ndarray, min_score: Optional[int] = None,
              min_seg_len: Optional[int] = None, top_k: Optional[int] = None,
              max_hits: Optional[int] = None) -> AlignmentResult:
        """Best hit per read.  As in the JAX engine there is no identity
        threshold: ``mapped`` tests score and length only, and the gapped
        post-pass runs with identity 0."""
        cfg = self.cfg
        min_score = min_score or cfg.min_align_score
        min_seg_len = min_seg_len or cfg.min_seg_len
        top_k = top_k or cfg.top_diagonals
        max_hits = max_hits or cfg.max_hits_per_kmer
        seqs = np.asarray(seqs, np.int8)
        if seqs.ndim == 1:
            seqs = seqs[None]
        B, R = seqs.shape
        offsets = self._offsets(R)
        chunk = _seed_chunk(len(offsets), max_hits, 8192)
        route = cfg.shard_route_top
        if self.mesh is not None:
            cat, shard = self._align_mesh(seqs, offsets, chunk, top_k,
                                          max_hits)
        elif 0 < route < self.n_shards:
            cat, shard = self._align_routed(seqs, offsets, chunk, top_k,
                                            max_hits, route)
        else:
            kw = self._kw(top_k, max_hits)
            outs = []
            for lo in range(0, B, chunk):
                reads = torch.from_numpy(seqs[lo:lo + chunk]).to(self.device)
                outs.append(_reduce_shard_stack(
                    [_shard_best(reads, offsets, sh, **kw)
                     for sh in self.shards]))
            cat = {n: torch.cat([o[n] for o in outs]).cpu().numpy()
                   for n in outs[0]}
            shard = cat.pop("shard")
        # local -> global fold on the host in int64
        off64 = self.host_offs[shard]
        length = cat["length"]
        res = AlignmentResult(
            score=cat["score"].astype(np.int32),
            strand=cat["strand"].astype(np.int8),
            read_start=cat["read_start"].astype(np.int32),
            read_end=cat["read_end"].astype(np.int32),
            ref_start=cat["ref_start"].astype(np.int64) + off64,
            ref_end=cat["ref_end"].astype(np.int64) + off64,
            matches=cat["matches"].astype(np.int32),
            length=length.astype(np.int32),
            second_score=cat["second_score"].astype(np.int32),
            mapped=(cat["score"] >= min_score) & (length >= min_seg_len),
        )
        if cfg.gapped_refine:
            # the refinement windows come from the whole host genome, so the
            # sharded and single-index engines refine alike
            from anchored_fusion_tpu_torch.align.refine import refine_result
            res = refine_result(res, seqs, self.reference.seq, cfg,
                                min_score, 0.0, min_seg_len, self.device)
        return res

    def _align_mesh(self, seqs: np.ndarray, offsets, chunk: int, top_k: int,
                    max_hits: int):
        """Best hit per read with one shard a rank: this rank's shard's
        (fields, B) records, all-gathered over mp into shard order and
        reduced as on one device (first maximum wins).  Returns (host
        fields, winning shard)."""
        from anchored_fusion_tpu_torch.parallel.distributed import gather_rows
        kw = self._kw(top_k, max_hits)
        B = seqs.shape[0]
        mine = []
        for lo in range(0, B, chunk):
            reads = torch.from_numpy(seqs[lo:lo + chunk]).to(self.device)
            out = _shard_best(reads, offsets, self.shards[0], **kw)
            mine.append(torch.stack([out[n].to(torch.int32)
                                     for n in RESULT_FIELDS]).cpu().numpy())
        local = (np.concatenate(mine, axis=1) if mine
                 else np.zeros((len(RESULT_FIELDS), 0), np.int32))
        S = self.n_shards
        stack = gather_rows(local[None], [1] * S, self.mesh.get_group(1))
        cat = {n: v.cpu().numpy() for n, v in _reduce_best(
            {n: torch.from_numpy(stack[:, i])
             for i, n in enumerate(RESULT_FIELDS)}).items()}
        return cat, cat.pop("shard")

    def _align_routed(self, seqs: np.ndarray, offsets, chunk: int,
                      top_k: int, max_hits: int, route: int):
        """Routed alignment (``cfg.shard_route_top``): count each read's
        seed evidence in every shard from the bucket table alone, align
        each read only against its ``route`` best shards, and keep the best
        hit with strict ``>`` in ascending shard order — the tie rule of the
        all-shards reduce.  Returns (host fields, winning shard)."""
        S = self.n_shards
        B = seqs.shape[0]
        counts = []
        for lo in range(0, B, chunk):
            rk, kv = _pack_query_kmers(
                torch.from_numpy(seqs[lo:lo + chunk]).to(self.device),
                self.k, self.stride)
            counts.append(torch.stack([
                _count_from_keys(rk, kv, index.table, self.k, self.kb,
                                 max_hits) for index, _ in self.shards]))
        counts = torch.cat(counts, dim=1).cpu().numpy()       # (S, B)
        order = np.argsort(-counts, axis=0, kind="stable")[:route]
        kw = self._kw(top_k, max_hits)
        best = {n: np.zeros(B, np.int32) for n in RESULT_FIELDS}
        shard = np.zeros(B, np.int32)
        best_score = np.full(B, -1, np.int64)
        for s in range(S):
            sel = np.nonzero((order == s).any(axis=0))[0]
            for lo in range(0, len(sel), chunk):
                part = sel[lo:lo + chunk]
                out = _shard_best(
                    torch.from_numpy(seqs[part]).to(self.device), offsets,
                    self.shards[s], **kw)
                out = {n: v.cpu().numpy() for n, v in out.items()}
                sc = out["score"].astype(np.int64)
                upd = sc > best_score[part]
                tgt = part[upd]
                best_score[tgt] = sc[upd]
                for n in RESULT_FIELDS:
                    best[n][tgt] = out[n][upd]
                shard[tgt] = s
        return best, shard

    def align_multi(self, seqs: np.ndarray, min_score: int = 20,
                    min_identity: float = 0.0, min_seg_len: int = 10,
                    top_k: int = 8, max_hits: Optional[int] = None) -> MultiHits:
        """All-hits alignment: each shard's hits are flattened and folded to
        global coordinates, hits found by two neighbouring shards inside
        their overlap are deduplicated by (read, strand, query start, global
        ref start) keeping the first, and the result is sorted by read."""
        cfg = self.cfg
        max_hits = max_hits or cfg.max_hits_per_kmer
        seqs = np.asarray(seqs, np.int8)
        if seqs.ndim == 1:
            seqs = seqs[None]
        # the JAX engine pads the batch to a multiple of 64 with PAD reads,
        # which the filter keeps only when it passes empty hits
        B0 = seqs.shape[0]
        Bp = -(-B0 // 64) * 64
        if Bp != B0:
            seqs = np.concatenate(
                [seqs, np.full((Bp - B0, seqs.shape[1]), PAD, np.int8)])
        B, R = seqs.shape
        read_lens = (seqs != PAD).sum(axis=1).astype(np.int32)
        offsets = self._offsets(R)
        chunk = _seed_chunk(len(offsets), max_hits, 4096)
        kw = self._kw(top_k, max_hits)
        parts = []
        for lo in range(0, B, chunk):
            sub = seqs[lo:lo + chunk]
            reads = torch.from_numpy(sub).to(self.device)
            for s, sh in zip(self.shard_ids, self.shards):
                seg = to_numpy(_shard_multi(reads, offsets, sh, **kw))
                mh = _flatten_multi(seg, read_lens[lo:lo + len(sub)],
                                    len(sub), top_k, min_score, min_identity,
                                    min_seg_len, R)
                off_s = np.int64(self.host_offs[s])
                parts.append(dataclasses.replace(
                    mh, read_id=mh.read_id + lo,
                    ref_start=mh.ref_start + off_s,
                    ref_end=mh.ref_end + off_s))
        if self.mesh is not None:
            # one part a chunk here; chunk-major, shard-minor as on one device
            from anchored_fusion_tpu_torch.parallel.collectives import (
                gather_objects)
            per_shard = gather_objects(parts, self.mesh.get_group(1))
            parts = [p for chunk_parts in zip(*per_shard)
                     for p in chunk_parts]
        cat = MultiHits(**{
            f.name: np.concatenate([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(MultiHits)})
        key = np.stack([cat.read_id.astype(np.int64),
                        cat.strand.astype(np.int64),
                        cat.q_start.astype(np.int64), cat.ref_start], axis=1)
        _, uniq = np.unique(key, axis=0, return_index=True)
        uniq.sort()
        order = uniq[np.argsort(cat.read_id[uniq], kind="stable")]
        return MultiHits(**{f.name: getattr(cat, f.name)[order]
                            for f in dataclasses.fields(MultiHits)})
