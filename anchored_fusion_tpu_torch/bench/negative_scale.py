"""Whole-sample negative-mining characterization.

The reference mines negatives from EVERY SA-tagged read of a whole-genome
BAM (functions.py:1425-1441): no row cap, sample-scale input.  This harness
drives ``mine_negative_junctions`` (streamed, uncapped) over a synthetic
cohort of the requested size on ``--device`` and records wall time,
throughput, yield and peak host memory.  Mining goes through
``GenomeAligner.align_multi``, which does not refine, so it launches no SW
kernel.

Run:  python -m anchored_fusion_tpu_torch.bench.negative_scale --reads 1000000
Emits one JSON line, with the JAX harness's keys.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time

import numpy as np


def _rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def build_cohort(rng: np.random.Generator, sg, n_reads: int,
                 chimera_frac: float, read_len: int = 101, pad_to: int = 128):
    """Mostly-linear reads plus chimeric artifacts between random gene pairs
    (the SA-tag-like population the miner exists to harvest).  Returns
    ((n_reads, pad_to) int8 reads, number of chimeras)."""
    codes = np.asarray(sg.genome.seq)
    L = len(codes)
    n_chim = int(n_reads * chimera_frac)
    n_lin = n_reads - n_chim
    batch = np.full((n_reads, pad_to), 5, np.int8)
    # linear reads: one vectorized gather
    starts = rng.integers(0, L - read_len, n_lin)
    batch[:n_lin, :read_len] = codes[starts[:, None]
                                     + np.arange(read_len)[None, :]]
    # chimeric artifacts: left part from one gene's exon, right from another
    genes = list(sg.genes.values())
    for i in range(n_chim):
        ga, gb = rng.choice(len(genes), 2, replace=False)
        ea = genes[ga].exons[rng.integers(len(genes[ga].exons))]
        eb = genes[gb].exons[rng.integers(len(genes[gb].exons))]
        cut = int(rng.integers(35, read_len - 35))
        pa = int(rng.integers(ea[0] - 1, max(ea[0], ea[1] - cut)))
        pb = int(rng.integers(eb[0] - 1, max(eb[0], eb[1] - (read_len - cut))))
        batch[n_lin + i, :cut] = codes[pa:pa + cut]
        batch[n_lin + i, cut:read_len] = codes[pb:pb + (read_len - cut)]
    return batch, n_chim


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="negative-mining scale bench")
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--genes", type=int, default=400)
    ap.add_argument("--chimera-frac", type=float, default=0.02)
    ap.add_argument("--chunk", type=int, default=65_536)
    ap.add_argument("--pair-depth", type=int, default=6)
    ap.add_argument("--max-rows", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    args = ap.parse_args(argv)

    from anchored_fusion_tpu_torch.align.genome import GenomeAligner
    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.bench.simulate import make_synthetic_genome
    from anchored_fusion_tpu_torch.models.negative import (
        mine_negative_junctions)
    from anchored_fusion_tpu_torch.utils.device import resolve_device, sync

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    # distinct 3-letter name prefixes per gene: the miner's name check
    # rejects any pair sharing its first 3 characters (paralog families),
    # so one shared prefix would reject every mined pair.  No first letter
    # is 'I' or 'E' (the auto-rejected IG/EN prefixes); the numeric suffix
    # keeps names unique up to 24*26*26 genes.
    first = [c for c in map(chr, range(65, 91)) if c not in "IE"]
    if args.genes > len(first) * 676:
        raise ValueError(f"--genes {args.genes} exceeds the distinct-prefix "
                         f"capacity {len(first) * 676}")
    namer = lambda gi: (first[gi // 676 % len(first)]  # noqa: E731
                        + chr(65 + gi // 26 % 26) + chr(65 + gi % 26)
                        + str(gi))
    sg = make_synthetic_genome(rng, n_genes=args.genes,
                               exons_per_gene=(3, 6), exon_len=(200, 400),
                               intergenic=(20_000, 40_000), namer=namer)
    index = ExonIndex(sg.gtf_dic, inject_loci=False)
    ga = GenomeAligner(sg.genome, device=device)
    sync(device)
    t_setup = time.time() - t0
    reads, n_chim = build_cohort(rng, sg, args.reads, args.chimera_frac)
    rss_before = _rss_gib()

    t0 = time.time()
    rows = mine_negative_junctions(
        ga, sg.genome, index, reads, ["NOTAGENE"],
        min_locus_distance=10_000, max_rows=args.max_rows,
        chunk_reads=args.chunk, pair_depth=args.pair_depth)
    dt = time.time() - t0

    print(json.dumps({
        "n_reads": args.reads,
        "n_chimeric": n_chim,
        "genome_mbp": round(sg.genome.total_length / 1e6, 1),
        "genes": args.genes,
        "chunk_reads": args.chunk,
        "pair_depth": args.pair_depth,
        "max_rows": args.max_rows,
        "rows_mined": len(rows),
        "yield_per_chimeric": round(len(rows) / max(n_chim, 1), 3),
        "mining_wall_s": round(dt, 1),
        "reads_per_s": round(args.reads / dt, 1),
        "setup_s": round(t_setup, 1),
        "peak_rss_gib": round(_rss_gib(), 2),
        "rss_before_mining_gib": round(rss_before, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
