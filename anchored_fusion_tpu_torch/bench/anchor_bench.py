"""Inputs, bounds and timing for the anchored aligner's kernels
(csrc/anchor.cu), and a comparison on one card with another version of
their source.

    python -m anchored_fusion_tpu_torch.bench.anchor_bench --baseline OLD/anchor.cu

builds OLD/anchor.cu (any source that exports ``seed_block_max_launch`` and
``extend_fold_launch`` with the package's signatures) beside the package's
own and prints one JSON line per case: ``seed_block_max`` at every shape of
ANCHOR_SHAPES and EDGE_SHAPES, ``extend_fold`` in block mode on the plain
seeding's outputs of each, and ``extend_fold`` in offsets mode on a flat
genome engine's voted offsets; where both sources export
``extend_segments_launch``, also the segments mode at every MULTI_SHAPES
case (keys from the package's seed_block_topk).  Each line holds both
versions' times, each launched through the same bare ctypes call and
taken in turns baseline,
new, new, baseline: the median of 20 warm calls between CUDA events
(``ms``; it includes the host's launch cost) and the mean device time of
the kernel over 20 calls from the profiler (``device_ms``); ``ratio`` and
``device_ratio`` = baseline / new; every output of both held equal to the
plain version; the bound and the new version's share of it (device
time).  chip_smoke.py takes its anchored inputs, bounds and cases from
this module, in the same order from the same seed, so both see the same
batches.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np

from anchored_fusion_tpu_torch.align.aligner import REF_PREPAD
from anchored_fusion_tpu_torch.align.genome_xl import TILE_C, TILE_HALO
from anchored_fusion_tpu_torch.bench import sw_bench as swb
from anchored_fusion_tpu_torch.ops.seed_vote import EMPTY_DIAG

# (name, reads, R, read length, reference bp, stride, k, kind): main_path's
# chunk (PipelineConfig.read_batch reads, 128-wide rows, its 6,798 bp
# anchor, k 4), a tie-heavy batch, sc_path's 160-wide rows, 320-wide rows
# (counts past 256 round through bfloat16), stride 2, and a 200 bp
# reference (2 blocks, fewer than k)
ANCHOR_SHAPES = [("main_path", 32768, 128, 101, 6798, 1, 4, "random"),
                 ("ties", 32768, 128, 101, 6798, 1, 4, "ties"),
                 ("R160", 32768, 160, 150, 6798, 1, 4, "random"),
                 ("R320", 8192, 320, 300, 6798, 1, 4, "random"),
                 ("stride2", 32768, 128, 101, 6798, 2, 4, "random"),
                 ("short_ref", 32768, 128, 101, 200, 1, 4, "random")]
# Edge shapes of the seeding's tiles: 2, 130 and 65,538 rows (off the
# 128-row tile), 1,024-wide reads (the K-chunked variant, 8 pieces of the
# extension's scan), a reference of a single 128-diagonal block, and stride
# 3 (a dilated read)
EDGE_SHAPES = [("rows2", 1, 128, 101, 6798, 1, 4, "random"),
               ("rows130", 65, 128, 101, 6798, 1, 4, "random"),
               ("rows65538", 32769, 128, 101, 6798, 1, 4, "random"),
               ("R1024", 2048, 1024, 1000, 6798, 1, 4, "random"),
               ("one_block", 32768, 64, 60, 60, 1, 4, "random"),
               ("stride3", 32768, 128, 101, 6798, 3, 4, "random")]
# the flat engine's offsets case: GenomeAligner.align's chunk of reads on a
# genome of this size, at the rescue stage's top 8 voted diagonals
GENOME_BP = 4_000_000
GENOME_READS = 8192
GENOME_K = 8
SEED = 4
ROW, READ_LEN = 128, 101
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
# int32 operations a read position of a candidate in the extension: the
# score (two PAD compares, the base compare, a select), the prefix add, the
# minimum-prefix compare and update, the segment subtract and compare, the
# match-count add
KADANE_OPS_PER_POS = 10
_COMP = (3, 2, 1, 0, 4, 5)


def anchor_reads(rng, ref, n: int, R: int, read_len: int, kind: str):
    """(n, R) int8 reads: a quarter copied from ``ref`` (half of them
    reverse-complemented, some hanging off its ends as N, 1% substitutions),
    the rest random background; for ``ties`` half come from the reference's
    tandem repeat and every 4th is a copy of an earlier read."""
    L = len(ref)
    m = min(read_len, L)
    reads = np.full((n, R), 5, np.int8)
    reads[:, :read_len] = rng.integers(0, 4, (n, read_len))
    on = n // 2 if kind == "ties" else n // 4
    lo, hi = (1000, 5000 - m) if kind == "ties" else (-m // 4, L - 3 * m // 4)
    idx = rng.integers(lo, hi, on)[:, None] + np.arange(m)
    seg = np.where((idx >= 0) & (idx < L), ref[np.clip(idx, 0, L - 1)], 4)
    err = rng.random(seg.shape) < 0.01
    seg[err] = (seg[err] + 1) % 4
    rc = np.arange(on) % 2 == 1
    seg[rc] = np.array(_COMP, np.int8)[seg[rc]][:, ::-1]
    reads[:on] = 5
    reads[:on, :m] = seg
    if kind == "ties":
        reads[3::4] = reads[:n // 4][:len(reads[3::4])]
    reads[0] = 5
    if n > 1:
        reads[1, :read_len] = 4
    return reads


def shape_inputs(rng, shape, device="cuda"):
    """One anchored case on ``device``: (oriented reads, coordinate offsets,
    SeedPatch, PAD-extended reference, stride, k)."""
    import torch
    from anchored_fusion_tpu_torch.align.aligner import (
        _seed_matrix_cached, both_strands)
    name, n, R, read_len, ref_bp, stride, k, kind = shape
    ref = rng.integers(0, 4, ref_bp).astype(np.int8)
    if kind == "ties":
        ref[1000:5000] = np.tile(rng.integers(0, 4, 40), 100)
    reads = anchor_reads(rng, ref, n, R, read_len, kind)
    flat, co = both_strands(torch.from_numpy(reads).to(device))
    seed, refp = _seed_matrix_cached(ref, R, stride, torch.device(device))
    return flat, co, seed, refp, stride, k


def genome_offsets_inputs(rng, device="cuda"):
    """A flat engine on a random GENOME_BP genome and one chunk of reads
    from it: (oriented reads, coordinate offsets, voted offsets (2B,
    GENOME_K), the engine's prepadded codes, prepad)."""
    import torch
    from anchored_fusion_tpu_torch.align.aligner import both_strands
    from anchored_fusion_tpu_torch.align.genome import (
        GenomeAligner, _seed_diagonals)
    from anchored_fusion_tpu_torch.config import AlignConfig
    from anchored_fusion_tpu_torch.io.fasta import Reference

    codes = rng.integers(0, 4, GENOME_BP).astype(np.int8)
    genome = Reference(["chrA"], np.zeros(1, np.int64),
                       np.asarray([len(codes)], np.int64), codes)
    ga = GenomeAligner(genome, AlignConfig(), device=device)
    reads = anchor_reads(rng, codes, GENOME_READS, ROW, READ_LEN, "random")
    flat, co = both_strands(torch.from_numpy(reads).to(device))
    offs = _seed_diagonals(flat, ga.index, ga._offsets(ROW), ga.stride,
                           ga.cfg.max_hits_per_kmer, GENOME_K)
    return flat, co, offs.contiguous(), ga.codes, ga.ref_prepad


def seed_bound_ms(M: int, R: int, seed) -> tuple:
    """The least time for the seeding: 2 M Rs*4 D int8 operations at the
    tensor-core peak, or its bytes (codes, the reference's 4-byte one-hots
    — the function needs no more of the patch matrix — and two int32
    outputs a block) at the HBM rate; and which of the two it is."""
    D, Rs = seed.diagonals, seed.positions
    nb = seed.i8.shape[0] // 128
    ops = 2 * M * Rs * 4 * D
    nbytes = M * R + 4 * D + 2 * M * nb * 4
    t_ops, t_bytes = ops / INT8_OPS_PER_S, nbytes / swb.HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def fold_bound_ms(N: int, R: int, k: int, Lp: int, nb: int) -> tuple:
    """The least time for the extension: KADANE_OPS_PER_POS int32
    operations a candidate position plus one pass over the blocks (the
    top-k), or its bytes (reads, offsets, the windows' reference codes up
    to the whole reference, block maxima and lanes, the records) at the
    HBM rate; and which of the two it is."""
    ops = N * k * R * KADANE_OPS_PER_POS + N * nb
    nbytes = (N * R + N * 4 + min(N * k * R, Lp) + N // 2 * 33
              + (2 * N * nb * 4 if nb else N * k * 4))
    t_ops, t_bytes = ops / swb.INT32_OPS_PER_S, nbytes / swb.HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


# The all-hits programs' shapes (the extension kernel's segments mode and
# the seeding kernel's top-k epilogue): (name, candidates, reads, R, read
# length, reference bp, stride, k, kind).  The flat engine's align_multi
# chunk (1,024 reads) on main_path's 100 Mbp prepadded genome, voted-like
# offsets with empty slots, repeats and offsets past both ends; a sharded
# chunk (4,096 reads) on a third of it with most slots empty; the XL
# engine's align_multi chunk (4,096 reads, 112-wide) over hg38-size tiles
# with empty slots on the all-PAD row T; the candidate sites' shapes at
# stride 3 — 128-wide tiles of the anchor against the candidate regions
# (REGIONS_BP) and 256-wide consensus queries against main_path's 6,798 bp
# anchor transcript (call/candidates.py's last site) — then k 1, a
# reference with D below 128, D off a multiple of 128, all-PAD rows, a
# reference of period 128 (equal keys in every block), 320-wide reads at
# stride 1 (the K-chunked seeding, counts past 256) and a 20 kb reference
# (~1,260 keys a row, most of them in the selection's uncached tail).
# REGIONS_BP: the largest candidate reference (call/candidates.py's
# regions.seq) that chip_smoke.py's main_path, sc_path, cli and bench
# paths built (their ``candidate_refs`` records: 234-2,186 bp; the
# anchor's tiles come up to 106 at a time, the consensus queries 1 or 2,
# so the queries' case takes 16, enough for a few copies of the anchor
# among anchor_reads' fixed PAD and N rows).
REGIONS_BP = 2_186
HG38_BP = 3_100_000_000
MULTI_SHAPES = [
    ("flat_align_multi", "offsets", 1024, 128, 101, 100_000_000, 1, 8,
     "genome"),
    ("sharded_offsets", "offsets", 4096, 128, 101, 33_334_000, 1, 8,
     "sparse"),
    ("xl_tiles", "tiles", 4096, 112, 101, HG38_BP, 1, 8, "tiles"),
    ("anchor_tiles", "keys", 106, 128, 128, REGIONS_BP, 3, 8, "random"),
    ("consensus_queries", "keys", 16, 256, 200, 6798, 3, 8, "random"),
    ("k1", "keys", 512, 128, 101, 6798, 1, 1, "random"),
    ("D_below_128", "keys", 512, 64, 50, 60, 1, 8, "random"),
    ("D_off_128", "keys", 512, 128, 101, 1000, 1, 8, "random"),
    ("all_pad", "keys", 512, 128, 101, 6798, 1, 8, "all_pad"),
    ("period128", "keys", 512, 128, 101, 6798, 1, 8, "period128"),
    ("R320_chunked", "keys", 512, 320, 320, 6798, 1, 8, "random"),
    ("long_reference", "keys", 106, 128, 128, 20_000, 3, 8, "random"),
]


def _genome_candidates(rng, n: int, R: int, read_len: int, L: int, k: int,
                       empty: float):
    """Reads copied from a genome of L codes at host-drawn starts (a third
    reverse-complemented), and (2n, k) offsets: each forward row's own
    start, starts a few diagonals off, random offsets (some past both
    ends), a repeat of slot 0 on every third row, and a share ``empty`` of
    EMPTY_DIAG slots."""
    start = rng.integers(0, L - read_len, n)
    offs = rng.integers(-R - 50, L + 50, (2 * n, k)).astype(np.int64)
    offs[:n, 0] = start
    if k > 2:
        offs[:n, 1] = start + rng.integers(-3, 4, n)
    offs[::3, -1] = offs[::3, 0]
    offs[rng.random((2 * n, k)) < empty] = EMPTY_DIAG
    offs[0] = EMPTY_DIAG
    return start, offs.astype(np.int32)


def multi_inputs(rng, shape, device="cuda"):
    """One all-hits case on ``device``: a dict with the oriented reads
    ``flat`` and, by candidate source, ``refp``, ``prepad`` and ``kw`` of
    extend_segments (offsets: the prepadded genome and offsets; tiles: the
    tiles, their halo and (rows, cols)) or the seeding's ``seed``,
    ``stride``, ``k`` and the PAD-extended reference ``refp`` (keys: the
    keys come from seed_block_topk)."""
    import torch
    from anchored_fusion_tpu_torch.align.aligner import (
        _seed_matrix_cached, both_strands)
    name, source, n, R, read_len, ref_bp, stride, k, kind = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    out = {"name": name, "source": source, "k": k}
    if source == "keys":
        if kind == "period128":
            ref = np.tile(rng.integers(0, 4, 128).astype(np.int8),
                          -(-ref_bp // 128))[:ref_bp].copy()
        else:
            ref = rng.integers(0, 4, ref_bp).astype(np.int8)
        reads = anchor_reads(rng, ref, n, R, read_len, "random")
        if kind == "all_pad":
            reads[::2] = 5
        flat, _ = both_strands(torch.from_numpy(reads).to(device))
        seed, refp = _seed_matrix_cached(ref, R, stride, torch.device(device))
        out.update(flat=flat, seed=seed, refp=refp, prepad=R, stride=stride)
        return out
    if source == "tiles":
        C, halo = TILE_C, TILE_HALO
        T = -(-ref_bp // C)
        tiles = torch.randint(0, 4, (T + 1, C + 2 * halo), generator=gen,
                              dtype=torch.int8, device=device)
        tiles[T] = 5
        row = rng.integers(0, T, n)
        col = rng.integers(-halo // 2, C - read_len, n)
        idx = (torch.from_numpy(row * (C + 2 * halo) + col + halo)[:, None]
               + torch.arange(read_len)).to(device)
        reads = torch.full((n, R), 5, dtype=torch.int8, device=device)
        reads[:, :read_len] = tiles.reshape(-1)[idx]
        reads[0] = 5
        flat, _ = both_strands(reads)
        rows = rng.integers(0, T, (2 * n, k))
        cols = rng.integers(-halo, C + halo - R, (2 * n, k))
        rows[:n, 0], cols[:n, 0] = row, col
        empty = rng.random((2 * n, k)) < 0.3
        rows[empty], cols[empty] = T, 0
        rows[::3, -1], cols[::3, -1] = rows[::3, 0], cols[::3, 0]
        t = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)  # noqa: E731
        out.update(flat=flat, refp=tiles, prepad=halo,
                   kw=dict(offs=t(cols), rows=t(rows)))
        return out
    P = REF_PREPAD
    codes = torch.randint(0, 4, (ref_bp,), generator=gen, dtype=torch.int8,
                          device=device)
    refp = torch.cat([torch.full((P,), 5, dtype=torch.int8, device=device),
                      codes, torch.full((P,), 5, dtype=torch.int8,
                                        device=device)])
    start, offs = _genome_candidates(rng, n, R, read_len, ref_bp, k,
                                     0.6 if kind == "sparse" else 0.2)
    idx = (torch.from_numpy(start)[:, None]
           + torch.arange(read_len)).to(device)
    reads = torch.full((n, R), 5, dtype=torch.int8, device=device)
    reads[:, :read_len] = codes[idx]
    reads[0] = 5
    flat, _ = both_strands(reads)
    out.update(flat=flat, refp=refp, prepad=P,
               kw=dict(offs=torch.from_numpy(offs).to(device)))
    return out


def topk_bound_ms(M: int, R: int, seed, k: int) -> tuple:
    """The least time for the seeding with its top-k epilogue: 2 M Rs*4 D
    int8 operations at the tensor-core peak, or its bytes (codes, the
    reference's 4-byte one-hots, k int32 keys a block) at the HBM rate."""
    D, Rs = seed.diagonals, seed.positions
    nb = seed.i8.shape[0] // 128
    ops = 2 * M * Rs * 4 * D
    nbytes = M * R + 4 * D + M * nb * k * 4
    t_ops, t_bytes = ops / INT8_OPS_PER_S, nbytes / swb.HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def segments_bound_ms(N: int, R: int, k: int, ref_bytes: int,
                      source: str, entries: int = 0) -> tuple:
    """The least time for the segments mode: KADANE_OPS_PER_POS int32
    operations a candidate position (keys mode: and one pass over a row's
    ``entries`` keys), or its bytes (reads, the candidates — offsets,
    (row, col) pairs or keys — the windows' codes up to the whole
    reference, 5 int32 fields a candidate, 6 in keys mode)."""
    ops = N * k * R * KADANE_OPS_PER_POS + N * entries
    cand = {"offsets": N * k * 4, "tiles": 2 * N * k * 4,
            "keys": N * entries * 4}[source]
    nbytes = (N * R + cand + min(N * k * R, ref_bytes)
              + N * k * 4 * (6 if source == "keys" else 5))
    t_ops, t_bytes = ops / swb.INT32_OPS_PER_S, nbytes / swb.HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def load_launches(source: str, name: str):
    """Build a version of csrc/anchor.cu and return its entries as bare
    calls: ``seed(flat, seed, stride) -> (bmax, lane)``, ``fold(flat,
    coord_off, refp, prepad, match, mismatch, k, offs=, bmax=, lane=, D=)
    -> (out (8, B), strand)`` and ``segs(flat, refp, prepad, match,
    mismatch, offs=, rows=, keys=, D=, k=) -> out (5 or 6, N, k)`` (None
    where the source has no segments mode)."""
    import torch
    from anchored_fusion_tpu_torch.ops import anchor_cuda, cuda_build
    lib = anchor_cuda.bind(ctypes.CDLL(cuda_build.build(source, name)))

    def check(err, fn):
        if err:
            raise RuntimeError(f"{name} {fn} failed: cudaError {err}")

    def seed(flat, patch, stride):
        M, R = flat.shape
        nb = patch.i8.shape[0] // 128
        bmax = torch.empty((M, nb), dtype=torch.int32, device=flat.device)
        lane = torch.empty_like(bmax)
        check(lib.seed_block_max_launch(
            flat.data_ptr(), M, R, stride, patch.positions,
            patch.i8.data_ptr(), patch.diagonals, patch.i8.shape[1], nb,
            bmax.data_ptr(), lane.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "seed")
        return bmax, lane

    def fold(flat, co, refp, prepad, match, mismatch, k, offs=None,
             bmax=None, lane=None, D=None):
        N, R = flat.shape
        B = N // 2
        out = torch.empty((8, B), dtype=torch.int32, device=flat.device)
        strand = torch.empty(B, dtype=torch.int8, device=flat.device)
        ptrs = ((offs.data_ptr(), None, None) if offs is not None else
                (None, bmax.data_ptr(), lane.data_ptr()))
        nb = 0 if offs is not None else bmax.shape[1]
        check(lib.extend_fold_launch(
            flat.data_ptr(), co.data_ptr(), B, R, k, refp.data_ptr(),
            refp.shape[0], prepad, *ptrs, nb, D or 0, match, mismatch,
            out.data_ptr(), strand.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "fold")
        return out, strand

    def segs(flat, refp, prepad, match, mismatch, offs=None, rows=None,
             keys=None, D=None, k=None):
        N, R = flat.shape
        if offs is not None:
            k, nb, kt = offs.shape[1], 0, 0
        else:
            nb, kt, k = keys.shape[1], keys.shape[2], min(k, D)
        out = torch.empty((5 if offs is not None else 6, N, k),
                          dtype=torch.int32, device=flat.device)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        check(lib.extend_segments_launch(
            flat.data_ptr(), N, R, k, refp.data_ptr(), refp.numel(), prepad,
            ptr(offs), ptr(rows), refp.shape[1] if rows is not None else 0,
            ptr(keys), nb, kt, D or 0, match, mismatch, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "segments")
        return out

    return seed, fold, (segs if hasattr(lib, "extend_segments_launch")
                        else None)


def _fold_plain(args, cand):
    import torch
    from anchored_fusion_tpu_torch.ops import anchor
    rec = anchor.extend_fold_plain(*args, **cand)
    names = ("score", "read_start", "read_end", "matches", "length",
             "second_score", "ref_start", "ref_end")
    return torch.stack([rec[n] for n in names]), rec["strand"]


def device_ms(fn, name: str, reps: int = 20) -> float:
    """The mean device time of the kernel named ``name`` over ``reps`` calls
    of ``fn`` (one launch each), after one warm call: its CUPTI intervals
    under torch.profiler, without the host's time to launch it (which CUDA
    events around one call include once a kernel takes ~0.1 ms).  The
    profiler may drop a few intervals; the mean is over those it kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.end - e.time_range.start) / 1e3
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.name]
    if not spans or len(spans) > reps:
        raise RuntimeError(f"{name}: {len(spans)} device intervals for "
                           f"{reps} calls")
    return sum(spans) / len(spans)


def _turns(old, new, name: str, reps: int = 20) -> dict:
    """Both versions in turns old, new, new, old: event times of one call
    and device times from the profiler; ``ratio`` = old / new."""
    t = [swb.time_ms(f, reps) for f in (old, new, new, old)]
    d = [device_ms(f, name, reps) for f in (old, new, new, old)]
    return {"baseline_ms": [t[0], t[3]], "ms": [t[1], t[2]],
            "ratio": (t[0] + t[3]) / (t[1] + t[2]),
            "baseline_device_ms": [d[0], d[3]], "device_ms": [d[1], d[2]],
            "device_ratio": (d[0] + d[3]) / (d[1] + d[2])}


def compare(baseline: str) -> list[dict]:
    """Both versions of the two kernels on every case, in turns; the
    records printed as they come."""
    import torch
    from anchored_fusion_tpu_torch.config import AlignConfig
    from anchored_fusion_tpu_torch.ops import anchor, anchor_cuda
    old_seed, old_fold, old_segs = load_launches(baseline, "anchor_baseline")
    new_seed, new_fold, new_segs = load_launches(anchor_cuda.SOURCE,
                                                 "anchor")
    cfg = AlignConfig()
    score = (cfg.match_score, cfg.mismatch_penalty)
    rng = np.random.default_rng(SEED)
    recs = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        recs.append(rec)

    def fold_case(name, args, cand, nb):
        want = _fold_plain(args, cand)
        eq = [all(torch.equal(a, b) for a, b in zip(f(*args, **cand), want))
              for f in (old_fold, new_fold)]
        times = _turns(lambda: old_fold(*args, **cand),
                       lambda: new_fold(*args, **cand), "extend_fold_kernel")
        N, R = args[0].shape
        bound, by = fold_bound_ms(N, R, args[6], args[2].shape[0], nb)
        emit({"kernel": "extend_fold", "case": name, "rows": N, "R": R,
              "k": args[6], "mode": "block" if nb else "offsets",
              "baseline_equal": eq[0], "equal": eq[1], **times,
              "bound_ms": bound, "bound_by": by,
              "share_of_bound": bound / min(times["device_ms"])})

    def shape_case(shape):
        flat, co, seed, refp, stride, k = shape_inputs(rng, shape)
        want = anchor.seed_block_max_plain(flat, seed.f32, stride)
        eq = [all(torch.equal(a, b) for a, b in
                  zip(f(flat, seed, stride), want))
              for f in (old_seed, new_seed)]
        times = _turns(lambda: old_seed(flat, seed, stride),
                       lambda: new_seed(flat, seed, stride),
                       "seed_block_max_kernel")
        M, R = flat.shape
        bound, by = seed_bound_ms(M, R, seed)
        emit({"kernel": "seed_block_max", "case": shape[0], "rows": M,
              "R": R, "stride": stride, "D": seed.diagonals,
              "plan": anchor_cuda.seed_plan(M, R, stride, seed.diagonals),
              "baseline_equal": eq[0], "equal": eq[1], **times,
              "bound_ms": bound, "bound_by": by,
              "share_of_bound": bound / min(times["device_ms"])})
        fold_case(shape[0], (flat, co, refp, R, *score, k),
                  dict(bmax=want[0], lane=want[1], D=seed.diagonals),
                  want[0].shape[1])

    for shape in ANCHOR_SHAPES:
        shape_case(shape)
    flat, co, offs, codes, prepad = genome_offsets_inputs(rng)
    fold_case("flat_offsets", (flat, co, codes, prepad, *score, GENOME_K),
              dict(offs=offs), 0)
    del flat, co, offs, codes
    for shape in EDGE_SHAPES:
        shape_case(shape)
    if old_segs is None:
        return recs
    rng = np.random.default_rng(SEED + 12)   # chip_smoke.py's batches
    for shape in MULTI_SHAPES:
        x = multi_inputs(rng, shape)
        args = (x["flat"], x["refp"], x["prepad"], *score)
        kw = x.get("kw") or dict(
            keys=anchor_cuda.seed_block_topk_cuda(x["flat"], x["seed"],
                                                  x["stride"], x["k"]),
            D=x["seed"].diagonals, k=x["k"])
        want = anchor.extend_segments_plain(*args, **kw)
        want = torch.stack([want[n] for n in want])
        eq = [torch.equal(f(*args, **kw), want) for f in (old_segs, new_segs)]
        times = _turns(lambda: old_segs(*args, **kw),
                       lambda: new_segs(*args, **kw), "extend_fold_kernel")
        N, R = x["flat"].shape
        entries = (kw["keys"].shape[1] * kw["keys"].shape[2]
                   if "keys" in kw else 0)
        bound, by = segments_bound_ms(N, R, want.shape[2],
                                      x["refp"].numel(), x["source"],
                                      entries)
        emit({"kernel": "extend_segments", "case": shape[0], "rows": N,
              "R": R, "k": want.shape[2], "mode": x["source"],
              "keys_a_row": entries, "baseline_equal": eq[0],
              "equal": eq[1], **times, "bound_ms": bound, "bound_by": by,
              "share_of_bound": bound / min(times["device_ms"])})
        del x, args, kw, want
        torch.cuda.empty_cache()
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="another version of csrc/anchor.cu to time beside it")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("anchor_bench: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    recs = compare(args.baseline)
    ok = all(r["equal"] and r["baseline_equal"] for r in recs)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
