"""hg38-scale genome-stage benchmark and recall characterization.

The reference's default operating point is the whole human genome: bwa
indexes and aligns against hg38 for mate rescue, multi-mapper rescue and
negative mining (Anchored_Fusion.py:102/:178, functions.py:716).  hg38 is
not shipped, so this harness measures the same regime on a synthetic genome
of the requested size, with implanted segmental duplications that skew
k-mer hit counts the way real repeats do:

  * index build wall time and the bytes of the resident index tensors,
  * device placement time (the sharded engine's host-build route),
  * genome-stage alignment throughput (reads/s) in production batches,
  * recall against the reads' known positions, swept over
    ``max_hits_per_kmer`` (H) at the requested ``index_stride``.

Four routes: ``--xl`` (the merged-index GenomeAlignerXL), ``--flat``
(GenomeAligner), and the sharded engine with its index built on the device
(the default past 200 Mbp, or ``--device-build``) or on the host and then
placed through ``ShardedGenomeAligner(prebuilt=...)``.

Run (on the card):
  python -m anchored_fusion_tpu_torch.bench.hg_scale --gbp 1.0 --shards 4 \
      --index-stride 4 --hits 8,16,32 --reads 16384
Emits one JSON line, with the JAX harness's keys; drop ``--json-only`` for
progress logs on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(msg: str, quiet: bool):
    if not quiet:
        print(f"[hg_scale] {msg}", file=sys.stderr, flush=True)


def make_genome(rng: np.random.Generator, length: int,
                repeat_frac: float = 0.1, seg_len: int = 10_000,
                family_copies: int = 0, family_count: int = 50,
                family_len: int = 1_000, family_div: float = 0.03):
    """Random genome codes with ``repeat_frac`` of positions covered by
    copies of earlier segments (segmental duplications -> k-mer skew).

    Returns (codes, repeat_intervals sorted (R, 2), family intervals (F,
    2)): reads sampled inside a duplicated interval legitimately map to
    either copy, so truth-position recall is only meaningful on reads
    outside them.

    ``family_copies`` > 0 also implants ``family_count`` repeat families of
    ``family_copies`` copies each, every copy diverged by ``family_div``
    point mutations (uniquely placeable, but its k-mer buckets hold ~
    ``family_copies`` entries).  Zero-divergence copies are legitimate
    multi-mappers and join the repeat intervals instead."""
    codes = rng.integers(0, 4, length, dtype=np.int8)
    n_rep = int(length * repeat_frac / seg_len)
    ivals = []
    for _ in range(n_rep):
        src = int(rng.integers(0, length - seg_len))
        dst = int(rng.integers(0, length - seg_len))
        codes[dst:dst + seg_len] = codes[src:src + seg_len]
        ivals += [(src, src + seg_len), (dst, dst + seg_len)]
    fam_ivals = []
    for _ in range(family_count if family_copies else 0):
        seg = rng.integers(0, 4, family_len, dtype=np.int8)
        for _ in range(family_copies):
            dst = int(rng.integers(0, length - family_len))
            c = seg.copy()
            if family_div > 0:
                m = np.nonzero(rng.random(family_len) < family_div)[0]
                c[m] = (c[m] + rng.integers(1, 4, len(m))) % 4
                fam_ivals.append((dst, dst + family_len))
            else:
                ivals.append((dst, dst + family_len))
            codes[dst:dst + family_len] = c
    ivals = np.asarray(sorted(ivals), np.int64).reshape(-1, 2)
    fam = np.asarray(sorted(fam_ivals), np.int64).reshape(-1, 2)
    return codes, ivals, fam


def _reads_at(rng: np.random.Generator, codes: np.ndarray,
              starts: np.ndarray, read_len: int, error_rate: float,
              pad_to: int) -> np.ndarray:
    """(len(starts), pad_to) int8 PAD rows of the ``read_len`` bases at
    ``starts``, with substitutions at ``error_rate``, every odd read
    reverse-complemented."""
    from anchored_fusion_tpu_torch.ops.encode import revcomp
    batch = np.full((len(starts), pad_to), 5, np.int8)
    for i, s in enumerate(starts):
        r = codes[s:s + read_len].copy()
        errs = np.nonzero(rng.random(read_len) < error_rate)[0]
        for e in errs:
            r[e] = (r[e] + int(rng.integers(1, 4))) % 4
        if i % 2:
            r = revcomp(r)
        batch[i, :read_len] = r
    return batch


def sample_reads(rng: np.random.Generator, codes: np.ndarray, n: int,
                 repeats: np.ndarray, read_len: int = 101,
                 error_rate: float = 0.005, pad_to: int = 128,
                 intervals: np.ndarray = None):
    """Reads sampled at known positions; every second one
    reverse-complemented.

    ``intervals`` restricts sampling to those (start, end) spans (targeted
    repeat-family reads); by default genome-wide.  Returns (batch (n,
    pad_to) int8, truth_start, truth_end, clean mask)."""
    L = len(codes)
    if intervals is None:
        starts = rng.integers(0, L - read_len, n)
    else:
        picks = intervals[rng.integers(0, len(intervals), n)]
        span = np.maximum(picks[:, 1] - picks[:, 0] - read_len, 1)
        starts = picks[:, 0] + (rng.random(n) * span).astype(np.int64)
        starts = np.minimum(starts, L - read_len)
    batch = _reads_at(rng, codes, starts, read_len, error_rate, pad_to)
    ends = starts + read_len - 1
    clean = ~overlaps_any(repeats, starts, ends)
    return batch, starts.astype(np.int64), ends.astype(np.int64), clean


def overlaps_any(intervals: np.ndarray, starts: np.ndarray,
                 ends: np.ndarray) -> np.ndarray:
    """Per-read bool: overlaps some (start, end) interval.  A conservative
    sweep over merged bounds (interval start <= read end AND that
    interval's running max end > read start)."""
    if not len(intervals):
        return np.zeros(len(starts), bool)
    idx = np.searchsorted(intervals[:, 0], ends, side="right")
    prev_end_cum = np.maximum.accumulate(intervals[:, 1])
    has_prev = idx > 0
    return has_prev & (prev_end_cum[np.clip(idx - 1, 0, None)] > starts)


def profile_xl_stages(ga, reads, batch: int, top_k: int, max_hits: int):
    """Seed and extension wall seconds of the XL engine's two device
    programs (on the card the seeding kernel and the extension kernel's
    tile mode) over ``reads`` in ``batch``-read chunks, with a device sync
    after each.  The residual of the whole align() time over their sum is
    the refine post-pass, the host fold and the copies."""
    import torch
    from anchored_fusion_tpu_torch.align.genome_xl import (
        _xl_extend_core, _xl_seed_core)
    from anchored_fusion_tpu_torch.index.kmer import read_kmer_offsets
    from anchored_fusion_tpu_torch.utils.device import sync

    dev = ga.device
    reads = ga._trim_width(np.asarray(reads, np.int8))
    R = reads.shape[1]
    offsets = torch.from_numpy(read_kmer_offsets(R, ga.k, ga.stride)).to(dev)
    t_seed = t_ext = 0.0
    for lo in range(0, len(reads), batch):
        sub = torch.from_numpy(reads[lo:lo + batch]).to(dev)
        sync(dev)
        t0 = time.time()
        r, c = _xl_seed_core(
            sub, ga.table, ga.pos_div, offsets, k=ga.k, kb=ga.k,
            stride_idx=ga.index_stride, stride_q=ga.stride,
            max_hits=max_hits, top_k=top_k,
            T=ga.tiles.shape[0] - 1, C=ga.C)
        sync(dev)
        t_seed += time.time() - t0
        t0 = time.time()
        _xl_extend_core(sub, ga.tiles, r, c, top_k=top_k,
                        match=ga.cfg.match_score,
                        mismatch=ga.cfg.mismatch_penalty, halo=ga.halo)
        sync(dev)
        t_ext += time.time() - t0
    return t_seed, t_ext


def recall_of(res, t_start, t_end, tol: int = 30) -> np.ndarray:
    """Per-read bool: the best hit overlaps the truth span (+-tol)."""
    return (np.asarray(res.mapped)
            & (np.asarray(res.ref_start) <= t_end + tol)
            & (np.asarray(res.ref_end) >= t_start - tol))


def tensor_bytes(*tensors) -> int:
    """Bytes the tensors hold."""
    return sum(t.numel() * t.element_size() for t in tensors)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="hg38-scale genome-stage bench")
    ap.add_argument("--gbp", type=float, default=1.0,
                    help="genome size in Gbp (hg38 is ~3.1)")
    ap.add_argument("--shards", type=int, default=0,
                    help="index shards (0 = the pipeline's auto sizing)")
    ap.add_argument("--index-stride", type=int, default=1)
    ap.add_argument("--kmer", type=int, default=0,
                    help="genome k-mer size (0 = AlignConfig default). "
                         "At hg38/stride 8 the k=13 table holds 5.8 "
                         "positions per bucket, so the H cap truncates most "
                         "buckets; k=14 (1.07 GB table) drops the load to "
                         "1.45, making small H near-lossless")
    ap.add_argument("--query-stride", type=int, default=0,
                    help="0 = auto (k//2 dense index, 1 sparse index)")
    ap.add_argument("--hits", type=str, default="16",
                    help="comma list of max_hits_per_kmer values to sweep")
    ap.add_argument("--reads", type=int, default=16384)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--repeat-frac", type=float, default=0.1)
    ap.add_argument("--family-copies", type=int, default=0,
                    help="implant repeat families at this copy number "
                         "(0 = off; 8/16/32 stress the H-capped buckets)")
    ap.add_argument("--family-count", type=int, default=50)
    ap.add_argument("--family-len", type=int, default=1000)
    ap.add_argument("--family-div", type=float, default=0.03,
                    help="per-copy divergence (>0: copies uniquely "
                         "placeable, reads count toward recall)")
    ap.add_argument("--family-reads", type=int, default=2048,
                    help="extra reads sampled INSIDE family copies")
    ap.add_argument("--error-rate", type=float, default=0.005)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-refine", action="store_true",
                    help="disable the gapped-refine post-pass")
    ap.add_argument("--chunk", type=int, default=0,
                    help="flat-path chunk (0 = aligner default)")
    ap.add_argument("--device-build", action="store_true",
                    help="build the index on the device (auto past 200Mbp)")
    ap.add_argument("--flat", action="store_true",
                    help="use the flat single-index GenomeAligner "
                         "(genome must fit int32 coords, < 2.1Gbp)")
    ap.add_argument("--xl", action="store_true",
                    help="use the merged-index GenomeAlignerXL (one "
                         "device, any size; requires index-stride >= 2 "
                         "past 2.1Gbp)")
    ap.add_argument("--two-pass", action="store_true",
                    help="XL two-pass seeding (pass-1 cheap point + "
                         "confidence-gated rescue; AlignConfig.xl_two_pass)")
    ap.add_argument("--pass1-hits", type=int, default=4)
    ap.add_argument("--pass1-topk", type=int, default=4)
    ap.add_argument("--rescue-hits", type=int, default=16)
    ap.add_argument("--rescue-topk", type=int, default=8)
    ap.add_argument("--confident-frac", type=float, default=0.90)
    ap.add_argument("--profile-stages", action="store_true",
                    help="XL path: report the seed/extension wall split per "
                         "sweep point (device syncs; the residual vs "
                         "align() is refine + host fold + copies)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    ap.add_argument("--json-only", action="store_true")
    args = ap.parse_args(argv)
    quiet = args.json_only

    from anchored_fusion_tpu_torch.config import AlignConfig
    from anchored_fusion_tpu_torch.io.fasta import Reference
    from anchored_fusion_tpu_torch.parallel.sharded_genome import (
        ShardedGenomeAligner, _build_shard_arrays)
    from anchored_fusion_tpu_torch.utils.device import resolve_device, sync

    device = resolve_device(args.device)
    L = int(args.gbp * 1e9)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    codes, repeats, fam_ivals = make_genome(
        rng, L, args.repeat_frac, family_copies=args.family_copies,
        family_count=args.family_count, family_len=args.family_len,
        family_div=args.family_div)
    t_gen = time.time() - t0
    log(f"genome generated: {L/1e9:.2f} Gbp in {t_gen:.1f}s"
        + (f" ({len(fam_ivals)} diverged family copies)"
           if len(fam_ivals) else ""), quiet)
    ref = Reference(names=["chrS"], starts=np.zeros(1, np.int64),
                    lengths=np.asarray([L], np.int64), seq=codes)

    kmer_kw = {"genome_kmer": args.kmer} if args.kmer else {}
    cfg = AlignConfig(index_stride=args.index_stride,
                      genome_query_stride=args.query_stride,
                      gapped_refine=not args.no_refine,
                      **kmer_kw,
                      xl_two_pass=args.two_pass,
                      xl_pass1_hits=args.pass1_hits,
                      xl_pass1_top_k=args.pass1_topk,
                      xl_rescue_hits=args.rescue_hits,
                      xl_rescue_top_k=args.rescue_topk,
                      xl_confident_frac=args.confident_frac)
    int32_safe = 2**31 - 2**20
    n_shards = args.shards or max(2, -(-L // (int32_safe // 2)))

    device_build = args.device_build or L > 200_000_000
    t_place = 0.0
    if args.xl:
        from anchored_fusion_tpu_torch.align.genome_xl import GenomeAlignerXL
        t0 = time.time()
        ga = GenomeAlignerXL(ref, cfg=cfg, verbose=not quiet, device=device)
        sync(device)
        t_build = time.time() - t0
        kb = ga.k
        n_shards = 1
        dev_bytes = tensor_bytes(ga.table, ga.pos_div, ga.tiles)
        log(f"XL merged index built: kb={kb}, {dev_bytes/2**30:.2f} GiB in "
            f"{t_build:.1f}s", quiet)
    elif args.flat:
        from anchored_fusion_tpu_torch.align.genome import GenomeAligner
        t0 = time.time()
        ga = GenomeAligner(ref, cfg=cfg, device_build=device_build,
                           device=device)
        sync(device)
        t_build = time.time() - t0
        kb = ga.index.kb
        n_shards = 1
        dev_bytes = tensor_bytes(ga.index.table, ga.index.keys_sorted,
                            ga.index.pos_sorted, ga.codes)
        log(f"flat index built: kb={kb}, {dev_bytes/2**30:.2f} GiB in "
            f"{t_build:.1f}s", quiet)
    elif device_build:
        t0 = time.time()
        ga = ShardedGenomeAligner(ref, n_shards=n_shards, cfg=cfg,
                                  device_build=True, device=device)
        sync(device)
        t_build = time.time() - t0
        kb = ga.kb
        dev_bytes = sum(tensor_bytes(ix.table, ix.keys_sorted,
                                     ix.pos_sorted, seq)
                        for ix, seq in ga.shards)
        log(f"device index built: {n_shards} shards, kb={kb}, "
            f"{dev_bytes/2**30:.2f} GiB in {t_build:.1f}s", quiet)
    else:
        t0 = time.time()
        prebuilt = _build_shard_arrays(codes, n_shards, cfg.genome_kmer,
                                       512, stride=args.index_stride)
        t_build = time.time() - t0
        keys, pos, tbl, seq, offs, kb = prebuilt
        dev_bytes = keys.nbytes + pos.nbytes + tbl.nbytes + seq.nbytes
        log(f"host index built: {n_shards} shards, kb={kb}, "
            f"{dev_bytes/2**30:.2f} GiB in {t_build:.1f}s", quiet)
        t0 = time.time()
        ga = ShardedGenomeAligner(ref, n_shards=n_shards, cfg=cfg,
                                  prebuilt=prebuilt, device=device)
        sync(device)
        t_place = time.time() - t0
        log(f"device placement: {t_place:.1f}s", quiet)

    reads, t_s, t_e, clean = sample_reads(rng, codes, args.reads, repeats,
                                          error_rate=args.error_rate)
    # genome-wide reads that fall in a diverged family copy face the same
    # crowded buckets as the targeted family reads: they count as family,
    # not as unique
    fam_mask = overlaps_any(fam_ivals, t_s, t_e)
    if len(fam_ivals) and args.family_reads:
        # targeted reads inside diverged family copies: uniquely placeable
        # (divergence > 0), but their k-mer buckets hold ~family_copies
        # entries, the adversarial case for the H cap
        fr, fs, fe, fc = sample_reads(rng, codes, args.family_reads, repeats,
                                      error_rate=args.error_rate,
                                      intervals=fam_ivals)
        reads = np.concatenate([reads, fr])
        t_s = np.concatenate([t_s, fs])
        t_e = np.concatenate([t_e, fe])
        clean = np.concatenate([clean, fc])
        fam_mask = np.concatenate([fam_mask, np.ones(args.family_reads, bool)])
    n_total = reads.shape[0]
    log(f"reads sampled: {n_total} ({int(clean.sum())} outside repeats, "
        f"{int(fam_mask.sum())} in diverged families)", quiet)
    sweep = {}
    akw = {"chunk": args.chunk} if (args.chunk and args.flat) else {}
    for h in [int(x) for x in args.hits.split(",")]:
        # two-pass mode uses the configured pass-1/rescue points: an
        # explicit max_hits would pin a single-pass point instead
        if not (args.two_pass and args.xl):
            akw["max_hits"] = h
        # one untimed pass first: it builds the SW kernel and warms the
        # allocator at every batch shape the timed pass meets
        for lo in range(0, n_total, args.batch):
            ga.align(reads[lo:lo + args.batch], **akw)
        sync(device)
        t0 = time.time()
        parts = [ga.align(reads[lo:lo + args.batch], **akw)
                 for lo in range(0, n_total, args.batch)]
        sync(device)
        dt = time.time() - t0
        ok = np.concatenate([
            recall_of(r, t_s[lo:lo + args.batch], t_e[lo:lo + args.batch])
            for lo, r in zip(range(0, n_total, args.batch), parts)])
        key = (f"2P_h{args.pass1_hits}k{args.pass1_topk}_r{args.rescue_hits}"
               f"t{args.rescue_topk}" if args.two_pass else f"H{h}")
        sweep[key] = {
            "reads_per_s": round(n_total / dt, 1),
            "recall": round(float(ok.mean()), 4),
            # truth-position recall counts only outside duplications (a
            # repeat read maps correctly to the other copy)
            "recall_unique": round(float(ok[clean & ~fam_mask].mean()), 4),
        }
        if fam_mask.any():
            sweep[key]["recall_family"] = round(float(ok[fam_mask].mean()), 4)
        if args.profile_stages and args.xl:
            ts, te = profile_xl_stages(ga, reads, args.batch,
                                       args.pass1_topk if args.two_pass
                                       else ga.cfg.top_diagonals,
                                       args.pass1_hits if args.two_pass
                                       else h)
            sweep[key]["profile"] = {
                "seed_s": round(ts, 3), "extend_s": round(te, 3),
                "align_s": round(dt, 3),
                "residual_s": round(dt - ts - te, 3)}
        log(f"{key}: {sweep[key]}", quiet)

    print(json.dumps({
        "genome_gbp": round(L / 1e9, 3),
        "repeat_frac": args.repeat_frac,
        "n_shards": n_shards,
        "index_stride": args.index_stride,
        "query_stride": ga.stride,
        "kmer": cfg.genome_kmer,
        "bucket_bases": kb,
        "device_build": device_build,
        "index_build_s": round(t_build, 1),
        "device_place_s": round(t_place, 1),
        "index_gib": round(dev_bytes / 2**30, 2),
        "per_shard_gib": round(dev_bytes / 2**30 / n_shards, 2),
        "gapped_refine": not args.no_refine,
        "two_pass": args.two_pass,
        "family_copies": args.family_copies,
        "family_div": args.family_div if args.family_copies else None,
        "n_reads": int(n_total),
        "error_rate": args.error_rate,
        "sweep": sweep,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
