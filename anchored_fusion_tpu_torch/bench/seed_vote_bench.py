"""Inputs, bounds and yardsticks of the genome engines' seeding kernel
(csrc/seed_vote.cu) and of the extension kernel's tile mode
(csrc/anchor.cu), at the shapes the engines give them.

chip_smoke.py's kernel phase takes its cases from here.  Each case is a
seeding launch on the card: the XL engine's pass-1 and rescue points (tile
mode, an hg38-size index: 4^14 + 1 table entries, 387.5M ``pos // 8``
slots), the flat engine's main-path chunk (diag mode, a 100 Mbp index) and
the sharded engine's hit cap on a third of hg38 (diag mode, H 32), then
edge shapes: rows past the shared-memory workspace, 2 rows, an odd row
count, and a prefix table (kb < k) built on the host from a random genome.
The indexes are synthetic: bucket sizes drawn from a Poisson law with the
real mean load, positions uniform, reads random codes with N and a PAD
tail; so every gather lands where an hg38 gather does (off L2).
"""

from __future__ import annotations

import numpy as np

from anchored_fusion_tpu_torch.bench import sw_bench as swb

SECTOR = 32                 # bytes a DRAM sector
# (name, mode, rows, R, read length, k, kb, query stride, H, top_k,
#  index positions, index stride, tile columns)
HG38 = 3_100_000_000
SHAPES = [
    ("xl_pass1", "tile", 16384, 112, 101, 14, 14, 1, 4, 4, HG38 // 8, 8,
     1 << 24),
    ("xl_rescue", "tile", 16384, 112, 101, 14, 14, 1, 16, 8, HG38 // 8, 8,
     1 << 24),
    ("flat_main_path", "diag", 16384, 128, 101, 13, 13, 6, 8, 4,
     100_000_000, 1, 0),
    ("sharded_wide_hits", "diag", 16384, 128, 101, 13, 13, 6, 32, 4,
     HG38 // 3 + 512, 1, 0),
]
EDGE_SHAPES = [
    ("global_scratch", "tile", 512, 1024, 1000, 14, 14, 1, 32, 8,
     HG38 // 8, 8, 1 << 24),
    ("rows2", "diag", 2, 128, 101, 13, 13, 6, 8, 4, 100_000_000, 1, 0),
    ("rows_odd", "diag", 1001, 128, 101, 13, 13, 6, 8, 4, 100_000_000, 1, 0),
    ("prefix_table", "diag", 16384, 128, 101, 13, 12, 6, 8, 4, 4_000_000,
     1, 0),
]
TILE_HALO = 768


def synthetic_index(gen, n_pos: int, k: int, device):
    """(table (4^k + 1,) int32, positions (M,) int32) with Poisson bucket
    sizes of mean n_pos / 4^k and positions uniform in [0, n_pos)."""
    import torch
    lam = torch.full((4 ** k,), n_pos / 4 ** k, device=device)
    counts = torch.poisson(lam, generator=gen).to(torch.int32)
    del lam
    table = torch.zeros(4 ** k + 1, dtype=torch.int32, device=device)
    torch.cumsum(counts, 0, dtype=torch.int32, out=table[1:])
    del counts
    M = int(table[-1])
    pos = torch.randint(0, n_pos, (M,), generator=gen, dtype=torch.int32,
                        device=device)
    return table, pos


def random_reads(gen, n: int, R: int, read_len: int, device):
    """(n, R) int8 random codes, ~1% N, PAD past ``read_len``; read 0 all
    PAD."""
    import torch
    r = torch.randint(0, 4, (n, R), generator=gen, dtype=torch.int8,
                      device=device)
    r[torch.rand((n, R), generator=gen, device=device) < 0.01] = 4
    r[:, read_len:] = 5
    r[0] = 5
    return r


def prefix_index(rng, k: int, n_pos: int, device):
    """A host build on a random genome of n_pos bases whose bucket width
    is below k: (table, keys_sorted, pos, kb, codes)."""
    import torch
    from anchored_fusion_tpu_torch.index.kmer import build_index_arrays
    codes = rng.integers(0, 4, n_pos).astype(np.int8)
    kv, pos, table, kb = build_index_arrays(codes, k)
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return put(table), put(kv), put(pos), kb, codes


def shape_inputs(shape, device="cuda", seed: int = 14):
    """One case: (seed_vote's positional arguments, its ``tile``, the
    oriented reads' both_strands coordinate offsets).  Reads of the prefix
    case are copied from its genome (a quarter) so its buckets hold keys
    that match and keys that do not."""
    import torch
    from anchored_fusion_tpu_torch.align.aligner import both_strands
    from anchored_fusion_tpu_torch.index.kmer import read_kmer_offsets
    (name, mode, rows, R, read_len, k, kb, stride, H, top_k, n_pos, sidx,
     C) = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    reads = random_reads(gen, -(-rows // 2), R, read_len, device)
    if kb < k:
        rng = np.random.default_rng(seed)
        table, keys, pos, kb_built, codes = prefix_index(rng, k, n_pos,
                                                          device)
        assert kb_built == kb, (kb_built, kb)
        starts = rng.integers(0, n_pos - read_len, reads.shape[0] // 4)
        reads[:len(starts), :read_len] = torch.from_numpy(
            codes[starts[:, None] + np.arange(read_len)]).to(device)
    else:
        table, pos = synthetic_index(gen, n_pos, k, device)
        keys = table[:1]
    flat, co = both_strands(reads)
    flat = flat[:rows].contiguous()
    offs = torch.from_numpy(read_kmer_offsets(R, k, stride)).to(device)
    tile = None
    if mode == "tile":
        T = -(-(n_pos * sidx) // C)
        tile = (C // sidx, sidx, T)
    return ((flat, table, keys, pos, offs, k, kb, stride, H, top_k), tile,
            co[:rows])


def seed_vote_work(args, tile) -> dict:
    """What this launch's data needs: valid k-mers, hit slots read (and key
    slots, kb < k), bytes each read once (read codes, k-mer offsets, two
    table entries a valid k-mer, the position and key slots, the outputs),
    the 32-byte sectors those gathers touch, and the fewest comparisons a
    comparison sort of each row's valid hits needs (h log2 h for h hits;
    the invalid slots all hold one sentinel)."""
    import torch
    from anchored_fusion_tpu_torch.index.kmer import (
        lookup_hits_table, pack_read_kmers_strided)
    flat, table, keys_sorted, pos, offs, k, kb, stride, H, top_k = args
    N, R = flat.shape
    keys, kvalid = pack_read_kmers_strided(flat, k, stride)
    b = keys >> (2 * (k - kb)) if kb < k else keys
    b = torch.clamp(b, 0, table.shape[0] - 2).long()
    lo, hi = table[b].long(), table[b + 1].long()
    cnt = torch.where(kvalid, torch.clamp(hi - lo, 0, H), 0)
    _, hvalid = lookup_hits_table(table, keys_sorted, pos, keys, kvalid, H,
                                  k, kb)
    n_kmers = int(kvalid.sum())
    slots = int(cnt.sum())
    hits = int(hvalid.sum())
    slot_sectors = int(torch.where(
        cnt > 0, (lo + cnt - 1) // 8 - lo // 8 + 1, 0).sum())
    table_sectors = int(torch.where(kvalid, 1 + (b % 8 == 7).long(),
                                    0).sum())
    outs = N * top_k * 4 * (2 if tile is not None else 1)
    nbytes = (N * R + offs.numel() * 4 + 8 * n_kmers + 4 * hits
              + (4 * slots if kb < k else 0) + outs)
    sectors = (table_sectors + slot_sectors * (2 if kb < k else 1))
    h = hvalid.reshape(N, -1).sum(1).double()
    comparisons = int((h * torch.log2(torch.clamp(h, min=2))).sum())
    return {"valid_kmers": n_kmers, "slots_in_range": slots,
            "hits": hits, "bytes": nbytes, "sectors": sectors,
            "sector_bytes": N * R + SECTOR * sectors + outs,
            "comparisons": comparisons}


def seed_vote_bound_ms(work: dict) -> tuple:
    """The least time: the bytes at the HBM rate, or one int32 operation a
    comparison at the int32 rate; and which of the two it is.  The time of
    the sectors the gathers touch at the HBM rate rides beside it."""
    t_bytes = work["bytes"] / swb.HBM_BYTES_PER_S
    t_ops = work["comparisons"] / swb.INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            work["sector_bytes"] / swb.HBM_BYTES_PER_S * 1e3)


def sort_library_ms(N: int, n: int, device="cuda", reps: int = 5) -> float:
    """The yardstick: one torch.sort of (N, n) int64 keys along rows, the
    seeding's largest single step (no PyTorch call computes the whole
    function)."""
    import torch
    keys = torch.randint(0, 2 ** 62, (N, n), dtype=torch.int64,
                         device=device)
    return swb.time_ms(lambda: torch.sort(keys, dim=1), reps)


def synthetic_tiles(gen, n_pos: int, sidx: int, C: int, device):
    """(T + 1, C + 2 * halo) int8 random tiles of an n_pos * sidx genome,
    the last row all PAD."""
    import torch
    T = -(-(n_pos * sidx) // C)
    tiles = torch.randint(0, 4, (T + 1, C + 2 * TILE_HALO), generator=gen,
                          dtype=torch.int8, device=device)
    tiles[T] = 5
    return tiles


def tile_fold_bound_ms(N: int, R: int, k: int, tile_bytes: int) -> tuple:
    """The extension's bound (anchor_bench.fold_bound_ms in offsets mode)
    with the candidates' rows read beside their columns and ten int32
    record rows written."""
    from anchored_fusion_tpu_torch.bench import anchor_bench as ab
    ops = N * k * R * ab.KADANE_OPS_PER_POS
    nbytes = (N * R + N * 4 + min(N * k * R, tile_bytes) + 2 * N * k * 4
              + N // 2 * 40)
    t_ops, t_bytes = ops / swb.INT32_OPS_PER_S, nbytes / swb.HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")
