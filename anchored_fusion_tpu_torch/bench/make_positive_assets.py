"""Generate the shipped positive training set (data/positive_samples.txt).

The reference ships ``data/positive_seq.txt``: 3,381 201-bp 'H'-junction
rows from curated real fusions, which the filter trainer reads.  No curated
fusion table or real genome is shipped here, so the equivalent is generated
deterministically from a synthetic spliced-gene cohort: random distinct gene
pairs, exonic breakpoints, strand-aware exon walks, through
``models/positive.py::build_positive_junctions`` (the path a user runs on a
STAR-Fusion table), in the shipped format ``<100bp>H<100bp>\\t<A->B>``.
The rows equal the JAX package's byte for byte.  Host code only.

Run:  python -m anchored_fusion_tpu_torch.bench.make_positive_assets \
          [--rows 3381] [--out data/positive_samples.txt]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def generate_rows(n_rows: int = 3381, seed: int = 0):
    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.bench.simulate import make_synthetic_genome
    from anchored_fusion_tpu_torch.models.positive import (
        build_positive_junctions)

    rng = np.random.default_rng(seed)
    # distinct 3-character prefixes, none starting with 'I' or 'E', so no
    # name takes the IG/EN prefixes (clean of them, as the curated set is)
    first = [c for c in map(chr, range(65, 91)) if c not in "IE"]
    namer = lambda gi: (first[gi // 676 % len(first)]  # noqa: E731
                        + chr(65 + gi // 26 % 26) + chr(65 + gi % 26)
                        + str(gi))
    sg = make_synthetic_genome(rng, n_genes=400, namer=namer)
    index = ExonIndex(sg.gtf_dic, inject_loci=False)
    genes = list(sg.genes.values())
    rows = []
    seen = set()
    while len(rows) < n_rows:
        gi, gj = rng.choice(len(genes), size=2, replace=False)
        g1, g2 = genes[int(gi)], genes[int(gj)]
        key = (g1.name, g2.name)
        if key in seen:
            continue
        seen.add(key)
        e1 = g1.exons[int(rng.integers(len(g1.exons)))]
        e2 = g2.exons[int(rng.integers(len(g2.exons)))]
        p1 = int(rng.integers(e1[0] + 1, e1[1]))
        p2 = int(rng.integers(e2[0] + 1, e2[1]))
        rows += build_positive_junctions(
            [(f"{g1.name}->{g2.name}", (g1.chrom, p1, g1.strand),
              (g2.chrom, p2, g2.strand))], sg.genome, index)
    return rows[:n_rows]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=3381)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="data/positive_samples.txt")
    args = ap.parse_args(argv)
    rows = generate_rows(args.rows, args.seed)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    print(f"wrote {len(rows)} positive junction rows to {args.out}")


if __name__ == "__main__":
    main()
