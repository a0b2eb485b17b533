"""Plain version of the genome engines' seeding kernel (csrc/seed_vote.cu,
ops/seed_vote_cuda.py): read k-mer keys, the bucket-table hit gather, the
per-row sort of the hits' diagonals, the run-length vote and the stable
top-k, as one function with two key modes.

- diag mode (the flat and sharded engines): a hit's diagonal is the int32
  ``position - k-mer offset``; the (2B, top_k) most-voted diagonals, with
  EMPTY_DIAG in slots without votes.
- tile mode (the XL engine, ``tile=(rowdiv, stride_idx, T)``): a hit's
  diagonal is the pair ``row = hit // rowdiv``, ``col = (hit % rowdiv) *
  stride_idx - offset`` of the tiled genome; (rows_c, cols_c), (2B,
  top_k) each, rows clipped to [0, T - 1], and (T, 0) in slots without
  votes.

This is the JAX package's chain (``index/kmer.py`` pack_read_kmers_strided,
lookup_hits_table, vote_diagonals / vote_diagonals2, in align/genome.py
``_seed_diagonals`` and align/genome_xl.py ``_xl_seed_core``) as the port
ran it before the kernel; invalid hits vote on the sentinel 2^30, and a run
on the sentinel scores 0, a valid diagonal equal to it included.
"""

from __future__ import annotations

from typing import Optional

import torch

from anchored_fusion_tpu_torch.index.kmer import (
    lookup_hits_table, pack_read_kmers_strided, vote_diagonals,
    vote_diagonals2)

# Offset given to empty vote slots in diag mode: far outside any genome, so
# its window is all PAD.
EMPTY_DIAG = -(2 ** 30) // 2


def seed_vote_plain(flat: torch.Tensor, table: torch.Tensor,
                    keys_sorted: torch.Tensor, pos: torch.Tensor,
                    offsets: torch.Tensor, k: int, kb: int, stride: int,
                    max_hits: int, top_k: int,
                    tile: Optional[tuple] = None):
    """(2B, R) oriented reads -> the top_k voted diagonals of each row.

    ``offsets`` (Q,) int32 are the k-mer offsets subtracted from the hit
    positions (kmer.read_kmer_offsets at ``stride``); ``keys_sorted`` is
    read only when ``kb < k``.  Diag mode returns (2B, top_k) int32; tile
    mode ``tile=(rowdiv, stride_idx, T)`` returns (rows_c, cols_c).
    """
    N = flat.shape[0]
    keys, kvalid = pack_read_kmers_strided(flat, k, stride)      # (2B, Q)
    hit, hvalid = lookup_hits_table(table, keys_sorted, pos, keys, kvalid,
                                    max_hits, k, kb)             # (2B, Q, H)
    C = hit.shape[1] * hit.shape[2]
    if tile is None:
        diags = hit - offsets[None, :, None]
        diag, votes = vote_diagonals(diags.reshape(N, C),
                                     hvalid.reshape(N, C), top_k)
        return torch.where(votes > 0, diag, EMPTY_DIAG)
    rowdiv, stride_idx, T = tile
    row = hit // rowdiv
    col = (hit % rowdiv) * stride_idx - offsets[None, :, None]
    vrow, vcol, votes = vote_diagonals2(row.reshape(N, C), col.reshape(N, C),
                                        hvalid.reshape(N, C), top_k)
    rows_c = torch.where(votes > 0, torch.clamp(vrow, 0, T - 1), T)
    cols_c = torch.where(votes > 0, vcol, 0)
    return rows_c, cols_c
