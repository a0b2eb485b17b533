"""The plain reference: best local alignment scores, in plain PyTorch.

Affine-gap Smith-Waterman with bwa-mem's scoring as the configuration
states it (match +1, mismatch -4, a gap of n bases costs open + n·extend =
6 + n).  Written from the recurrence, not from the program: the read runs
down the rows, the reference along a (N, W) row state; F (a gap in the
reference) comes from the row above, E (a gap in the read) is a running
maximum along the row of the cells before it, which is exact because
opening a gap never costs less than extending one.  N (code 4) is a base
that matches nothing; PAD (code 5) is no base: a read row of PAD is
skipped, a reference column of PAD scores no match and no mismatch (a gap
may still run through it, at its cost).

Imports nothing of the program.  ``clamp`` holds every stored score in a
saturating range, to compute the control in a lower precision (control.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

PAD = 5
NEG = -(1 << 20)
_COMP = np.array([3, 2, 1, 0, 4, 5], np.int8)
# the scoring the configurations state (bwa mem defaults: -A1 -B4 -O6 -E1)
MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND = 1, 4, 6, 1


def left_aligned(rows: np.ndarray) -> np.ndarray:
    """Rows with their bases first and PAD after them."""
    order = np.argsort(rows == PAD, axis=1, kind="stable")
    return np.take_along_axis(rows, order, axis=1)


def revcomp(rows: np.ndarray) -> np.ndarray:
    """The reverse complement of each row's bases, left-aligned."""
    return left_aligned(_COMP[rows][:, ::-1])


def sw_best(reads: torch.Tensor, refs: torch.Tensor,
            clamp: Optional[Tuple[int, int]] = None,
            chunk: int = 4096) -> torch.Tensor:
    """(N,) best local alignment score of each left-aligned read row
    against its reference row (``refs`` (N, W), or (1, W) for all)."""
    out = []
    for lo in range(0, reads.shape[0], chunk):
        ref = refs if refs.shape[0] == 1 else refs[lo:lo + chunk]
        out.append(_sw_rows(reads[lo:lo + chunk], ref, clamp))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=reads.device)
    return torch.cat(out)


def _sw_rows(reads, refs, clamp):
    N, W = reads.shape[0], refs.shape[1]
    dev = reads.device
    i32 = torch.int32
    go, ge = GAP_OPEN + GAP_EXTEND, GAP_EXTEND
    jge = (torch.arange(W, device=dev, dtype=i32) * ge)[None, :]
    ref_base = refs < 4
    ref_pad = refs == PAD
    H = torch.zeros((N, W), dtype=i32, device=dev)
    F = torch.full((N, W), NEG, dtype=i32, device=dev)
    best = torch.zeros(N, dtype=i32, device=dev)
    neg_col = torch.full((N, 1), NEG, dtype=i32, device=dev)
    zero_col = torch.zeros((N, 1), dtype=i32, device=dev)
    sat = (lambda x: x.clamp(*clamp)) if clamp else (lambda x: x)  # noqa
    rows = int((reads != PAD).sum(1).max()) if N else 0
    for i in range(rows):
        c = reads[:, i:i + 1]
        s = torch.where((refs == c) & (c < 4) & ref_base, MATCH, -MISMATCH)
        s = torch.where(ref_pad, NEG, s).to(i32)
        diag = torch.cat([zero_col, H[:, :-1]], dim=1)
        f = sat(torch.maximum(H - go, F - ge))
        hp = torch.clamp(torch.maximum(diag + s, f), min=0)
        run = torch.cummax(hp + jge, dim=1).values
        e = sat(torch.cat([neg_col, run[:, :-1]], dim=1) - go - (jge - ge))
        h = sat(torch.maximum(hp, e))
        live = c != PAD
        H = torch.where(live, h, H)
        F = torch.where(live, f, F)
        best = torch.maximum(best, H.max(dim=1).values)
    return best


def both_strands_best(reads: np.ndarray, refs: torch.Tensor, device,
                      clamp=None) -> np.ndarray:
    """The better of each read's two strands against ``refs`` ((1, W) or
    one row a read): (N,) int."""
    reads = left_aligned(np.asarray(reads, np.int8))
    fwd = torch.from_numpy(reads).to(device)
    rc = torch.from_numpy(revcomp(reads)).to(device)
    if refs.shape[0] > 1:
        refs = torch.cat([refs, refs])
    best = sw_best(torch.cat([fwd, rc]), refs, clamp)
    n = len(reads)
    return torch.maximum(best[:n], best[n:]).cpu().numpy()


def windows(codes: np.ndarray, start: np.ndarray, end: np.ndarray,
            pad: int) -> np.ndarray:
    """(N, W) int8 slices codes[start - pad .. end + pad] (``end``
    inclusive), PAD where a slice leaves the sequence or is shorter than
    the widest."""
    start = np.asarray(start, np.int64) - pad
    end = np.asarray(end, np.int64) + pad
    W = int((end - start).max()) + 1 if len(start) else 1
    idx = start[:, None] + np.arange(W)
    ok = (idx >= 0) & (idx < len(codes)) & (idx <= end[:, None])
    out = np.full(idx.shape, PAD, np.int8)
    out[ok] = codes[idx[ok]]
    return out
