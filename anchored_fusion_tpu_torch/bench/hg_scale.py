"""hg38-scale synthetic genome (the part of the JAX package's
``bench/hg_scale.py`` that the hg38 harness ``bench/hg_e2e.py`` uses).

hg38 itself is not shipped, so the harness builds a random genome of the
requested size with implanted segmental duplications, which skew k-mer hit
counts the way real repeats do.
"""

from __future__ import annotations

import sys

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
