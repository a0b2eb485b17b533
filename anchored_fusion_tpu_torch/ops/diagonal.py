"""All-diagonal seeding as one matrix product.

For every read and every alignment diagonal, the exact number of matching
bases:

    diag_count[b, j] = sum_r sum_c read1h[b, r, c] * ref1h[j - (R-1) + r, c]

i.e. the match count when read ``b`` starts at reference offset ``j-(R-1)``.
The reference side is lowered once into an im2col "patch matrix" W of shape
(R*4, L+R-1) with W[r*4+c, j] = ref1h[j-(R-1)+r, c]; every read batch is then
a single (B, R*4) @ (R*4, L+R-1) product.  N and PAD one-hot to zero, so they
never match.

The product runs in float32: the one-hots are 0/1 and every count is an
integer <= R, exact in float32 (and in TF32, whose inputs 0 and 1 are exact
and whose sums accumulate in float32), so counts equal the integer result.
"""

from __future__ import annotations

import numpy as np
import torch

from anchored_fusion_tpu_torch.ops.encode import one_hot, N_REAL


def build_seed_matrix(ref: np.ndarray, read_len: int, device,
                      stride: int = 1) -> torch.Tensor:
    """Im2col the reference for diagonal seeding against reads of width R.

    Returns float32 W of shape (Rs*4, D) with D = L + R - 1 and
    Rs = ceil(R/stride); column j holds the one-hot reference window starting
    at offset j - (R-1) (out-of-bounds rows zero), sampled at every
    ``stride``-th read position.
    """
    R = read_len
    ref_t = torch.as_tensor(np.asarray(ref, np.int8), device=device)
    L = ref_t.shape[0]
    D = L + R - 1
    rows = torch.arange(0, R, stride, device=device)
    ref1h = one_hot(ref_t)
    pad = torch.zeros((R - 1, N_REAL), dtype=ref1h.dtype, device=device)
    ref1h_p = torch.cat([pad, ref1h, pad], dim=0)           # (L + 2(R-1), 4)
    idx = torch.arange(D, device=device)[None, :] + rows[:, None]  # (Rs, D)
    win = ref1h_p[idx.reshape(-1)].reshape(len(rows), D, N_REAL)
    return win.permute(0, 2, 1).reshape(len(rows) * N_REAL, D).contiguous()


def diag_match_counts_w(reads: torch.Tensor, seed_matrix: torch.Tensor,
                        stride: int = 1) -> torch.Tensor:
    """Match counts for every (read, diagonal) via the prebuilt patch matrix.

    Args:
      reads:       (B, R) int8 codes.
      seed_matrix: (ceil(R/stride)*4, L+R-1) from :func:`build_seed_matrix`.
    Returns:
      (B, L+R-1) float32 diagonal match counts (exact integers).
    """
    B = reads.shape[0]
    read1h = one_hot(reads[:, ::stride], seed_matrix.dtype).reshape(B, -1)
    return read1h @ seed_matrix


def diag_match_counts(reads: torch.Tensor, ref: np.ndarray) -> torch.Tensor:
    """One-shot form: build the patch matrix of ``ref`` ((L,) int8 codes)
    on the reads' device and multiply.  (B, L+R-1) float32 exact counts."""
    reads = torch.as_tensor(reads)
    W = build_seed_matrix(np.asarray(ref), int(reads.shape[1]), reads.device)
    return diag_match_counts_w(reads, W)


def diag_index_to_ref_offset(idx, read_len_padded: int):
    """The reference offset of read position 0 on diagonal ``idx``."""
    return idx - (read_len_padded - 1)
