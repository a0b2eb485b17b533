"""The yardstick of the kernels' roofline shares: the card's peaks, and the
least time each kernel's calls could take, from what the calls need.

The counts come from a call's inputs (rows, widths, diagonals, the index's
hits), never from how the program computes the call, so a later kernel is
held against the same work.  Frozen copies of the bounds of the port's
``bench/anchor_bench.py::seed_bound_ms`` and ``topk_bound_ms`` and of
``bench/seed_vote_bench.py::seed_vote_work`` and ``seed_vote_bound_ms``.
"""

from __future__ import annotations

import math

import torch

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
INT8_OPS_PER_S = 1979e12          # int8 tensor-core operations
HBM_BYTES_PER_S = 3.35e12         # HBM3
INT32_OPS_PER_S = 132 * 64 * 1.98e9   # int32 lanes: 132 SMs x 64 x boost
BLOCK = 128                       # diagonals a block of the seeding


def seed_block_bound_s(M: int, R: int, Rs: int, D: int, k: int = 0) -> float:
    """The least time of one launch of the anchored seeding: 2·M·Rs·4·D
    int8 operations (the one-hot product of M reads of Rs positions
    against D diagonals) at the int8 peak, or its bytes — the codes, the
    reference's 4-byte one-hots, and two int32 outputs a block (block max)
    or k int32 keys a block (its top-k epilogue) — at the HBM rate."""
    nb = -(-D // BLOCK)
    ops = 2 * M * Rs * 4 * D
    out = M * nb * k * 4 if k else 2 * M * nb * 4
    nbytes = M * R + 4 * D + out
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def pack_kmers(flat: torch.Tensor, k: int, stride: int):
    """Keys of each row's k-mers at offsets 0, stride, ... up to R - k and
    whether each holds only bases: ((N, Q) int64, (N, Q) bool)."""
    N, R = flat.shape
    n = R - k + 1
    keys = torch.zeros((N, n), dtype=torch.int64, device=flat.device)
    ok = torch.ones((N, n), dtype=torch.bool, device=flat.device)
    for j in range(k):
        c = flat[:, j:j + n].long()
        keys = keys * 4 + torch.where(c < 4, c, 0)
        ok &= c < 4
    return keys[:, ::stride], ok[:, ::stride]


def seed_vote_work(flat: torch.Tensor, table: torch.Tensor,
                   keys_sorted: torch.Tensor, offsets: torch.Tensor, k: int,
                   kb: int, stride: int, H: int, top_k: int,
                   tile: bool) -> dict:
    """What one launch of the genome seeding needs: each byte read once
    (the read codes, the k-mer offsets, two table entries a valid k-mer,
    a position slot a hit and, with kb < k, a key slot a slot in range, the
    outputs) and the fewest comparisons a comparison sort of each row's h
    hits needs, h·log2(h)."""
    N, R = flat.shape
    keys, valid = pack_kmers(flat, k, stride)
    b = keys >> (2 * (k - kb)) if kb < k else keys
    b = torch.clamp(b, 0, table.shape[0] - 2)
    lo, hi = table[b].long(), table[b + 1].long()
    cnt = torch.where(valid, torch.clamp(hi - lo, 0, H), 0)
    if kb < k:
        take = torch.arange(H, device=flat.device)
        idx = lo[..., None] + take
        ok = (take < cnt[..., None])
        idxc = torch.clamp(idx, 0, keys_sorted.shape[0] - 1)
        hit = ok & (keys_sorted[idxc].long() == keys[..., None])
        per_row = hit.sum((1, 2))
    else:
        per_row = cnt.sum(1)
    slots = int(cnt.sum())
    hits = int(per_row.sum())
    n_kmers = int(valid.sum())
    outs = N * top_k * 4 * (2 if tile else 1)
    nbytes = (N * R + offsets.numel() * 4 + 8 * n_kmers + 4 * hits
              + (4 * slots if kb < k else 0) + outs)
    h = per_row.double()
    comparisons = float((h * torch.log2(torch.clamp(h, min=2))).sum())
    return {"bytes": nbytes, "comparisons": comparisons, "hits": hits,
            "rows": N}


def seed_vote_bound_s(work: dict) -> float:
    """The bytes at the HBM rate, or one int32 operation a comparison at the
    int32 rate, whichever is longer."""
    return max(work["bytes"] / HBM_BYTES_PER_S,
               work["comparisons"] / INT32_OPS_PER_S)


def share(bounds: list, device_s: float, recorded: int):
    """A roofline share in %: the least time of the launches over their
    device time, or None where the profiler recorded no interval (never 0
    for an unmeasured share).  Where it recorded fewer intervals than there
    were launches, only that fraction of the launches' least time is set
    against the time it recorded."""
    if not device_s or not bounds or not recorded or math.isnan(device_s):
        return None
    bound = sum(bounds) * min(1.0, recorded / len(bounds))
    return 100.0 * bound / device_s
