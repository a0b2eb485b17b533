"""Plain versions of the anchored aligner's two device kernels
(csrc/anchor.cu, ops/anchor_cuda.py), and the pieces they share with the
aligner.

- ``seed_block_max_plain``: the match count of every (read, diagonal) as
  the one-hot product (ops/diagonal.py), rounded through bfloat16, then for
  each 128-diagonal block its maximum and the first lane holding it; lanes
  past the last diagonal count as -1.  ``seed_block_topk_plain`` (the
  seeding's top-k epilogue) keeps each block's k largest keys instead, and
  ``select_topk_plain`` merges them into the row's top k diagonals.
- ``extend_fold_plain``: for each oriented read k candidate offsets — the
  stable top-k of the block maxima (block mode) or given (offsets mode) —
  a window of the PAD-extended reference, the Kadane maximal segment
  (ops/kadane.py), the best and the runner-up over k, and the fold of the
  two strands into one record per read.  In tile mode (the XL engine) the
  candidates are (row, col) pairs of the tiled genome and the windows are
  rows of the tiles.

- ``extend_segments_plain``: the extension's segments mode — the Kadane
  segment of every candidate (``offset_segments`` over a PAD-extended
  reference, ``tile_segments`` over the tiles, or the candidates selected
  from the top-k keys), with no best-of-k and no fold.

These are the JAX package's ``_block_topk_diagonals``,
``extend_diagonals`` and ``fold_strands`` (align/aligner.py), and
``_xl_extend_core`` (align/genome_xl.py), split where the kernels split
them, and the all-hits programs' ``extend_diagonals_all``, ``lax.top_k``
of bfloat16 counts (``_align_multi_core``) and ``_xl_multi_extend_core``;
tie order is kept: top-k keeps the lower index, the best is the first
maximum, the reverse strand wins only when strictly better.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from anchored_fusion_tpu_torch.ops import kadane
from anchored_fusion_tpu_torch.ops.diagonal import (
    build_seed_matrix, diag_match_counts_w)
from anchored_fusion_tpu_torch.ops.encode import PAD

BLOCK = 128     # diagonals per block of the two-level top-k
K_CHUNK = 128   # the int8 patch matrix's k padding: 32 positions
SEGMENT_FIELDS = ("score", "start", "end", "matches", "length")
# The tile mode's record rows: genome_xl.py's XL_FIELDS; the host folds
# ``ref = row * C + col`` in int64.
TILE_FIELDS = ("score", "strand", "read_start", "read_end", "matches",
               "length", "second_score", "row", "col_start", "col_end")


@dataclasses.dataclass(frozen=True)
class SeedPatch:
    """The reference patch matrix for reads of one width and stride.

    ``f32`` is ops/diagonal.py's (Rs*4, D) float32 matrix; ``i8`` is the
    same 0/1 matrix as int8, transposed to (nb*128, Kp) with zero rows past
    D and zero columns past Rs*4 (Kp a multiple of K_CHUNK): the seeding
    kernel's operand.  Row y's first 4 bytes are the one-hot of reference
    position y - (R-1); the kernel builds its Toeplitz B tiles from them.
    """

    f32: torch.Tensor
    i8: torch.Tensor

    @property
    def diagonals(self) -> int:
        return self.f32.shape[1]

    @property
    def positions(self) -> int:
        return self.f32.shape[0] // 4


def seed_patch(ref: np.ndarray, read_len: int, device,
               stride: int = 1) -> SeedPatch:
    f32 = build_seed_matrix(ref, read_len, device, stride=stride)
    K, D = f32.shape
    i8 = torch.zeros((-(-D // BLOCK) * BLOCK, -(-K // K_CHUNK) * K_CHUNK),
                     dtype=torch.int8, device=f32.device)
    i8[:D, :K] = f32.t().to(torch.int8)
    return SeedPatch(f32, i8)


def pad_reference(ref: np.ndarray, read_len: int, device) -> torch.Tensor:
    """``[PAD * R, ref, PAD * R]`` as one int8 tensor: the window of offset
    o is ``refp[clamp(o + R, 0, L + R) : ... + R]``."""
    R = read_len
    refp = np.concatenate([np.full(R, PAD, np.int8),
                           np.asarray(ref, np.int8),
                           np.full(R, PAD, np.int8)])
    return torch.from_numpy(refp).to(device)


def block_max_plain(counts: torch.Tensor, block: int = BLOCK):
    """(N, D) counts -> (N, nb) int32 block maxima and first arg-max lanes,
    counts rounded through bfloat16, the ragged last block padded with -1."""
    N, D = counts.shape
    Dp = -(-D // block) * block
    c = counts.to(torch.bfloat16).float()
    if Dp != D:
        c = torch.nn.functional.pad(c, (0, Dp - D), value=-1.0)
    cb = c.reshape(N, Dp // block, block)
    return (cb.max(dim=-1).values.to(torch.int32),
            kadane.first_argmax(cb).to(torch.int32))


def block_topk_plain(bmax: torch.Tensor, lane: torch.Tensor, k: int,
                     D: int, block: int = BLOCK) -> torch.Tensor:
    """(N, k) int32 diagonal indices: the stable top-k blocks (lower index
    first on ties) and their lanes; fewer than k blocks repeat the last
    index; clamped to D - 1."""
    N, nb = bmax.shape
    kk = min(k, nb)
    bidx = torch.sort(bmax, dim=1, descending=True, stable=True).indices
    bidx = bidx[:, :kk]
    idx = (bidx * block + torch.gather(lane, 1, bidx)).to(torch.int32)
    if kk < k:
        idx = torch.cat([idx, idx[:, -1:].expand(N, k - kk)], dim=1)
    return torch.clamp(idx, max=D - 1)


def seed_block_max_plain(flat: torch.Tensor, seed_matrix: torch.Tensor,
                         stride: int = 1):
    """(2B, R) oriented reads, the float32 patch matrix -> (bmax, lane),
    each (2B, nb) int32."""
    return block_max_plain(diag_match_counts_w(flat, seed_matrix,
                                               stride=stride))


def block_topk_keys(counts: torch.Tensor, k: int,
                    block: int = BLOCK) -> torch.Tensor:
    """(N, D) counts -> (N, nb, k) int32: each 128-diagonal block's k
    largest keys ``count * 256 + (255 - lane)``, counts rounded through
    bfloat16, in descending order; -1 where the block has fewer than k
    lanes before D."""
    N, D = counts.shape
    nb = -(-D // block)
    c = counts.to(torch.bfloat16).to(torch.int32)
    lane = torch.arange(block, dtype=torch.int32, device=counts.device)
    key = torch.full((N, nb * block), -1, dtype=torch.int32,
                     device=counts.device)
    key[:, :D] = c * 256 + (255 - lane.repeat(nb)[:D])
    key = key.reshape(N, nb, block)
    return torch.sort(key, dim=-1, descending=True).values[..., :k]


def seed_block_topk_plain(flat: torch.Tensor, seed_matrix: torch.Tensor,
                          stride: int, k: int) -> torch.Tensor:
    """(2B, R) oriented reads, the float32 patch matrix -> (2B, nb, k) int32
    per-block top-k keys (block_topk_keys)."""
    return block_topk_keys(diag_match_counts_w(flat, seed_matrix,
                                               stride=stride), k)


def select_topk_plain(keys: torch.Tensor, k: int, D: int) -> torch.Tensor:
    """(N, nb, kt) per-block top-k keys -> (N, min(k, D)) int32 diagonals:
    the row's top k in (count descending, diagonal ascending) order, which
    is ``stable_topk`` of the bfloat16 counts (lax.top_k: the lower index
    first on ties).

    Merging per-block lists gives the row's top k because the order is
    total (no two diagonals tie): an entry of the row's top k has fewer
    than k entries before it in the row, so fewer than k in its own block,
    so it is in its block's top k.  Inside a block the order is (count
    descending, lane ascending), which is the key's descending order, so
    each list holds exactly its block's top k; kt >= min(k, 128) keeps
    every needed entry (a block holds 128).  (The key alone does not order
    two blocks: an equal count at a lower lane of a later block has the
    larger key.)
    """
    N, nb, kt = keys.shape
    kk = min(k, D)
    if min(kk, BLOCK) > kt:
        raise ValueError(f"{kt} keys a block cannot give the top {kk}")
    keys = keys.long()
    q = torch.arange(nb * kt, device=keys.device).reshape(nb, kt)
    diag = (q // kt) * BLOCK + 255 - (keys & 255)
    rank = torch.where(keys >= 0, (keys >> 8) * 2 ** 32 + (2 ** 31 - 1 - diag),
                       -1 - q)
    order = torch.sort(rank.reshape(N, -1), dim=1, descending=True).indices
    return torch.gather(diag.reshape(N, -1), 1,
                        order[:, :kk]).to(torch.int32)


def offset_segments(flat: torch.Tensor, refp: torch.Tensor,
                    offs: torch.Tensor, prepad: int, match: int,
                    mismatch: int) -> dict:
    """The Kadane maximal segment of every candidate: (N, R) reads, (N, k)
    offsets, windows ``refp[clamp(o + prepad, 0, len(refp) - R) : ... + R]``
    -> dict of (N, k) score, start, end, matches, length."""
    R = flat.shape[1]
    start = torch.clamp(offs.long() + prepad, 0, refp.shape[0] - R)
    win = refp[start[..., None] + torch.arange(R, device=refp.device)]
    return window_segments(flat, win, match, mismatch)


def window_segments(flat: torch.Tensor, win: torch.Tensor, match: int,
                    mismatch: int) -> dict:
    """The Kadane maximal segment of (N, R) reads against their (N, k, R)
    windows; a position counts where neither side is PAD."""
    valid = (win != PAD) & (flat != PAD)[:, None, :]
    sc, ism = kadane.segment_scores(flat[:, None, :].expand(win.shape), win,
                                    valid, match=match, mismatch=mismatch)
    return kadane.best_segment(sc, ism)


def tile_segments(flat: torch.Tensor, tiles: torch.Tensor,
                  rows: torch.Tensor, cols: torch.Tensor, halo: int,
                  match: int, mismatch: int) -> dict:
    """offset_segments over a tiled genome: the window of candidate (row,
    col) is ``tiles[row, clamp(col + halo, 0, W - R) : ... + R]``."""
    R = flat.shape[1]
    start = torch.clamp(cols + halo, 0, tiles.shape[1] - R)
    idx = start[..., None] + torch.arange(R, dtype=torch.int32,
                                          device=flat.device)
    win = tiles[rows.long()[..., None], idx.long()]          # (N, k, R)
    return window_segments(flat, win, match, mismatch)


def extend_segments_plain(flat: torch.Tensor, refp: torch.Tensor,
                          prepad: int, match: int, mismatch: int,
                          offs: Optional[torch.Tensor] = None,
                          rows: Optional[torch.Tensor] = None,
                          keys: Optional[torch.Tensor] = None,
                          D: Optional[int] = None,
                          k: Optional[int] = None) -> dict:
    """The extension's segments mode: dict of (N, k) SEGMENT_FIELDS, the
    Kadane segment of every candidate of (N, R) reads.

    Offsets mode (``offs``): windows ``refp[clamp(o + prepad, 0, len(refp)
    - R) : ... + R]``.  Tile mode (``rows`` and ``offs``, the columns):
    windows of the (T+1, W) tiles ``refp``, ``prepad`` their halo.  Keys
    mode (``keys`` (N, nb, kt) from the seeding's top-k epilogue, ``D``,
    ``k``): the candidates are the row's top min(k, D) diagonals
    (select_topk_plain) at offset ``diagonal - (R - 1)``, returned as
    ``off`` beside the fields.
    """
    if rows is not None:
        return tile_segments(flat, refp, rows, offs, prepad, match, mismatch)
    if offs is not None:
        return offset_segments(flat, refp, offs, prepad, match, mismatch)
    off = select_topk_plain(keys, k, D) - (flat.shape[1] - 1)
    seg = offset_segments(flat, refp, off, prepad, match, mismatch)
    seg["off"] = off
    return seg


def best_of_k(seg: dict, offs: torch.Tensor,
              rows: Optional[torch.Tensor] = None) -> dict:
    """(N, k) segments -> (N,) best candidate (the first maximum) and the
    runner-up's score (the second of a stable descending order; 0 for
    k = 1); with ``rows`` (tile mode) also the best candidate's row."""
    N, k = offs.shape
    order = torch.argsort(-seg["score"], dim=1, stable=True)
    b1 = order[:, :1]
    b2 = order[:, min(1, k - 1):min(1, k - 1) + 1]
    take = lambda a, j: torch.gather(a, 1, j)[:, 0]  # noqa: E731
    return {
        "score": take(seg["score"], b1),
        "second": (take(seg["score"], b2) if k > 1 else
                   torch.zeros(N, dtype=torch.int32, device=offs.device)),
        "rs": take(seg["start"], b1),
        "re": take(seg["end"], b1),
        "mt": take(seg["matches"], b1),
        "ln": take(seg["length"], b1),
        "off": take(offs, b1),
        **({"row": take(rows, b1)} if rows is not None else {}),
    }


def fold_strands(cand: dict, B: int, coord_off: torch.Tensor) -> dict:
    """Fold the (2B,) forward/revcomp candidate halves into per-read records.

    ``coord_off`` (from aligner.both_strands) converts raw reverse-row
    coordinates (PAD-prefixed) into the left-aligned oriented-read convention;
    reference coordinates use the raw values, so they are unaffected.
    """
    fwd = {n: v[:B] for n, v in cand.items()}
    rev = {n: v[B:] for n, v in cand.items()}
    use_rev = rev["score"] > fwd["score"]
    pick = lambda n: torch.where(use_rev, rev[n], fwd[n])  # noqa: E731
    off_best = pick("off")
    rs_raw = pick("rs")
    re_raw = pick("re")
    co = torch.where(use_rev, coord_off[B:], coord_off[:B])
    return {
        "score": pick("score"),
        "strand": use_rev.to(torch.int8),
        "read_start": rs_raw - co,
        "read_end": re_raw - co,
        "matches": pick("mt"),
        "length": pick("ln"),
        "second_score": torch.maximum(
            torch.where(use_rev, rev["second"], fwd["second"]),
            torch.where(use_rev, fwd["score"], rev["score"])),
        "ref_start": off_best + rs_raw,
        "ref_end": off_best + re_raw,
        **({"row": pick("row")} if "row" in cand else {}),
    }


def extend_fold_plain(flat: torch.Tensor, coord_off: torch.Tensor,
                      refp: torch.Tensor, prepad: int, match: int,
                      mismatch: int, k: int,
                      offs: Optional[torch.Tensor] = None,
                      bmax: Optional[torch.Tensor] = None,
                      lane: Optional[torch.Tensor] = None,
                      D: Optional[int] = None,
                      rows: Optional[torch.Tensor] = None) -> dict:
    """Per-read records (dict of (B,)) of (2B, R) oriented reads.

    Block mode (``bmax``, ``lane``, ``D``): the candidates are the stable
    top-k diagonals, offset ``idx - (R - 1)``.  Offsets mode (``offs``,
    (2B, k) int32).  Windows come from ``refp`` with ``prepad`` PAD codes
    before reference position 0.  Tile mode (``rows`` and ``offs``, (2B, k)
    int32 rows and columns of the (T+1, W) tiles ``refp``, ``prepad`` the
    tiles' halo): the TILE_FIELDS records, int32.
    """
    N, R = flat.shape
    if rows is not None:
        seg = tile_segments(flat, refp, rows, offs, prepad, match, mismatch)
        rec = fold_strands(best_of_k(seg, offs, rows), N // 2, coord_off)
        rec["col_start"] = rec.pop("ref_start")
        rec["col_end"] = rec.pop("ref_end")
        return {f: rec[f].to(torch.int32) for f in TILE_FIELDS}
    if offs is None:
        offs = block_topk_plain(bmax, lane, k, D) - (R - 1)
    seg = offset_segments(flat, refp, offs, prepad, match, mismatch)
    return fold_strands(best_of_k(seg, offs), N // 2, coord_off)
