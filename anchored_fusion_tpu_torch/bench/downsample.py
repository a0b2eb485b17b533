"""Paired-consistent FASTQ downsampler.

Parity with ``utils/downsample_reads.py``: halve the read pairs per step
(mates kept together) to build a depth-titration ladder for
sensitivity-vs-depth benchmarks.  Host code only.

Run:  python -m anchored_fusion_tpu_torch.bench.downsample \
          --fastq1 r_1.fastq.gz --fastq2 r_2.fastq.gz --out_prefix ds
"""

from __future__ import annotations

import numpy as np

from anchored_fusion_tpu_torch.bench.simulate import write_fastq_pair
from anchored_fusion_tpu_torch.io.fastq import ReadBatch, read_fastq_pair
from anchored_fusion_tpu_torch.ops.encode import decode_to_str


def downsample_batch(rb: ReadBatch, fraction: float = 0.5,
                     seed: int = 0) -> ReadBatch:
    """Keep a paired-consistent random fraction of the read pairs."""
    rng = np.random.default_rng(seed)
    n_keep = int(round(rb.n_pairs * fraction))
    keep = np.sort(rng.choice(rb.n_pairs, size=n_keep, replace=False))
    return ReadBatch([rb.names[i] for i in keep], rb.seq[keep],
                     rb.length[keep])


def halving_ladder(path1: str, path2: str, out_prefix: str, steps: int = 4,
                   seed: int = 0):
    """Write ``steps`` successively halved FASTQ pairs; returns
    [(path1, path2, pairs)] per step."""
    rb = read_fastq_pair(path1, path2)
    out = []
    for s in range(1, steps + 1):
        rb = downsample_batch(rb, 0.5, seed + s)
        p1 = f"{out_prefix}_x{2**s}_1.fastq.gz"
        p2 = f"{out_prefix}_x{2**s}_2.fastq.gz"
        r1 = [decode_to_str(rb.seq[i, 0, :rb.length[i, 0]])
              for i in range(rb.n_pairs)]
        r2 = [decode_to_str(rb.seq[i, 1, :rb.length[i, 1]])
              for i in range(rb.n_pairs)]
        write_fastq_pair(p1, p2, rb.names, r1, r2)
        out.append((p1, p2, rb.n_pairs))
    return out


def main(argv=None) -> int:
    """Depth-titration ladder CLI (utils/downsample_reads.py:8-30 parity)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="anchored-fusion-downsample-torch",
        description="paired-consistent 2x FASTQ downsampling ladder")
    ap.add_argument("--fastq1", required=True)
    ap.add_argument("--fastq2", required=True)
    ap.add_argument("--out_prefix", required=True)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for p1, p2, n in halving_ladder(args.fastq1, args.fastq2, args.out_prefix,
                                    steps=args.steps, seed=args.seed):
        print(f"{p1} {p2}: {n} pairs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
