"""Inputs, bounds and yardsticks of the genome engines' seeding kernels
(csrc/seed_vote.cu) and of the extension kernel's tile mode
(csrc/anchor.cu), at the shapes the engines give them, and a comparison on
one card with another version of the seeding source.

    python -m anchored_fusion_tpu_torch.bench.seed_vote_bench --baseline OLD/seed_vote.cu
    python -m anchored_fusion_tpu_torch.bench.seed_vote_bench --split

builds OLD/seed_vote.cu beside the package's own and prints one JSON line
per case of SHAPES and EDGE_SHAPES: both versions launched through bare
ctypes calls and taken in turns baseline, new, new, baseline — the median
of 20 warm calls between CUDA events (``ms``, the host's launch cost
included) and the mean device time of the seeding kernels over 20 calls
from the profiler (``device_ms``: the per-kernel means summed, the
counter's memset included) — ``ratio`` and ``device_ratio`` = baseline /
new, both versions' outputs held equal to the plain version, the bound
and the new version's share of it, and the yardstick (one torch.sort of
the rows' int64 keys).  A baseline whose source has no warp kernel is
launched with the one-block-a-row layout it was written for (BLOCK_ABI).
``--split`` times the warp kernel beside copies of it cut short after
its k-mer keys, its table loads and its gathers (split()).

chip_smoke.py's kernel phase takes its cases from here.  Each case is a
seeding launch on the card: the XL engine's pass-1 and rescue points (tile
mode, an hg38-size index: 4^14 + 1 table entries, 387.5M ``pos // 8``
slots), the flat engine's main-path chunk (diag mode, a 100 Mbp index) and
the sharded engine's hit cap on a third of hg38 (diag mode, H 32), then
edge shapes: 1,024-wide rows (past the warp kernel; their sorts once lay
in global scratch), 2 rows, an odd row count, a prefix table (kb < k)
built on the host from a random genome, a repeat-rich index whose rows
mostly pass the warp's 256 hits, and an index where every slot of every
1,024-wide row is valid (each row's 32,480 keys sorted in global scratch).
The indexes are synthetic: bucket sizes drawn from a Poisson law with the
real mean load (or the edge's), positions uniform, reads random codes with
N and a PAD tail; so every gather lands where an hg38 gather does (off L2).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

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
    # a mean bucket load of 3 at k 12: ~270 hits a row, most past the warp
    ("overflow_heavy", "tile", 16384, 112, 101, 12, 12, 1, 16, 8,
     3 * 4 ** 12, 8, 1 << 24),
    # a mean load of 64 at k 10, reads without N or PAD: every slot valid
    ("all_slots_valid", "diag", 512, 1024, 1024, 10, 10, 1, 32, 8,
     64 * 4 ** 10, 1, 0),
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
    if name == "all_slots_valid":
        reads[reads == 4] = 0
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
    the invalid slots all hold one sentinel); and the most in-range slots
    of a row and the rows past the warp kernel's WARP_HITS."""
    import torch
    from anchored_fusion_tpu_torch.ops import seed_vote_cuda
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
    row_slots = cnt.sum(1)
    return {"valid_kmers": n_kmers, "slots_in_range": slots,
            "hits": hits, "bytes": nbytes, "sectors": sectors,
            "sector_bytes": N * R + SECTOR * sectors + outs,
            "comparisons": comparisons,
            "max_row_slots": int(row_slots.max()) if N else 0,
            "rows_past_warp": int((row_slots > seed_vote_cuda.WARP_HITS)
                                  .sum())}


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


# ------------------------------------------------------------ comparison


def device_ms(fn, prefix: str = "seed_vote", reps: int = 20):
    """The mean device time of one call of ``fn`` over ``reps`` calls after
    a warm one: under torch.profiler, the mean interval of each kernel
    whose name holds ``prefix`` (and of any memset), summed over those
    kernels; None where the profiler recorded none.  The profiler may drop
    a few intervals: each mean is over those it kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans: dict = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and (prefix in e.name or "emset" in e.name)):
            spans.setdefault(e.name, []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    if not spans or any(len(v) > reps for v in spans.values()):
        return None
    return sum(sum(v) / len(v) for v in spans.values())


# The launch of a baseline written as one block a row (no warp kernel): its
# C entry's argument types and its plan (sort slots P, a power of two from
# 64; workspace 12 P + 12 Q bytes in shared memory up to 200 KB, else in a
# global scratch of at most 528 blocks and 1 GB; P / 2 threads up to 512).
BLOCK_ABI = "block"


def _bind_block(lib):
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.seed_vote_launch.restype = i32
    lib.seed_vote_launch.argtypes = [
        ptr, *[i32] * 6, ptr, ptr, i64, ptr, ptr, i64, *[i32] * 7, ptr, i64,
        i32, i32, ptr, ptr, ptr]
    return lib


def _launch_block(lib, flat, table, keys_sorted, pos, offs, k, kb, stride,
                  H, top_k, tile=None):
    import torch
    N, R = flat.shape
    Q = offs.shape[0]
    n = Q * H
    P = max(64, 1 << max(0, n - 1).bit_length())
    ws = -(-(12 * P + 12 * Q) // 16) * 16
    shared = ws <= 200 * 1024
    grid = N if shared else max(1, min(N, 528, (1 << 30) // ws))
    rowdiv, sidx, T = tile if tile is not None else (1, 1, 0)
    out0 = torch.empty((N, top_k), dtype=torch.int32, device=flat.device)
    out1 = torch.empty_like(out0) if tile is not None else None
    scratch = (None if shared else
               torch.empty(grid * ws, dtype=torch.uint8, device=flat.device))
    err = lib.seed_vote_launch(
        flat.data_ptr(), N, R, k, kb, stride, Q, offs.data_ptr(),
        table.data_ptr(), table.shape[0], keys_sorted.data_ptr(),
        pos.data_ptr(), pos.shape[0], H, top_k, P, int(tile is not None),
        rowdiv, sidx, T, None if scratch is None else scratch.data_ptr(), ws,
        grid, min(512, P // 2), out0.data_ptr(),
        None if out1 is None else out1.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"baseline seed_vote_launch failed: cudaError "
                           f"{err}")
    return out0 if tile is None else (out0, out1)


def load_launch(source: str, name: str):
    """Build a version of csrc/seed_vote.cu; a call ``run(args, tile)`` of
    it, with the package's launch for a source with the warp kernel and
    BLOCK_ABI's for one without."""
    from anchored_fusion_tpu_torch.ops import cuda_build, seed_vote_cuda
    lib = ctypes.CDLL(cuda_build.build(source, name))
    with open(source) as fh:
        warp = "seed_vote_warp_kernel" in fh.read()
    if warp:
        seed_vote_cuda.bind(lib)
        return lambda args, tile: seed_vote_cuda.launch(*args, tile=tile,
                                                        lib=lib)
    _bind_block(lib)
    return lambda args, tile: _launch_block(lib, *args, tile=tile)


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def compare(baseline: str) -> list[dict]:
    """Both versions on every case, in turns; the records printed as they
    come."""
    import torch
    from anchored_fusion_tpu_torch.ops import seed_vote, seed_vote_cuda
    old = load_launch(baseline, "seed_vote_baseline")
    new = load_launch(seed_vote_cuda.SOURCE, "seed_vote")
    recs = []
    for shape in SHAPES + EDGE_SHAPES:
        args, tile, _ = shape_inputs(shape)
        want = _outputs(seed_vote.seed_vote_plain(*args, tile=tile))
        eq = [all(torch.equal(a, b) for a, b in
                  zip(_outputs(f(args, tile)), want)) for f in (old, new)]
        runs = [lambda f=f: f(args, tile) for f in (old, new, new, old)]
        t = [swb.time_ms(f, 20) for f in runs]
        d = [device_ms(f) for f in runs]
        w = seed_vote_work(args, tile)
        bound, by, sector_bound = seed_vote_bound_ms(w)
        flat, H = args[0], args[8]
        N, R = flat.shape
        Q = args[4].numel()
        dev = [x for x in d[1:3] if x]
        rec = {"kernel": "seed_vote", "case": shape[0],
               "mode": "diag" if tile is None else "tile", "rows": N, "R": R,
               "k": args[5], "kb": args[6], "H": H, "top_k": args[9],
               "plan": seed_vote_cuda.plan(N, Q, H, R),
               "baseline_equal": eq[0], "equal": eq[1],
               "baseline_ms": [t[0], t[3]], "ms": [t[1], t[2]],
               "ratio": (t[0] + t[3]) / (t[1] + t[2]),
               "baseline_device_ms": [d[0], d[3]], "device_ms": [d[1], d[2]],
               "device_ratio": (d[0] + d[3]) / (d[1] + d[2])
               if all(d) else None,
               "bound_ms": bound, "bound_by": by,
               "sector_bound_ms": sector_bound,
               "share_of_bound": bound / min(dev) if dev else None,
               "sort_ms": sort_library_ms(N, Q * H), "work": w}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
        del args, tile, want
        torch.cuda.empty_cache()
    return recs


# split()'s cuts of the warp kernel, each an edit of csrc/seed_vote.cu's
# text: the row's result written (S, or h) and the warp returned right
# after the table loads or after the gathers and compaction; "keys" also
# replaces the table loads by arithmetic on the bucket.
_CUT_TABLE = "  if (S > cap) {  // past the warp: the rows kernel takes it"
_CUT_GATHERS = "  __syncwarp();\n  if (h == 0) {\n    for (int x = lane;"
_TABLE_LOADS = ("    lo = __ldg(a.table + b);\n"
                "    hi = __ldg(a.table + b + 1);")


def _cut(text: str, at: str, value: str) -> str:
    assert at in text, at
    return text.replace(at, "  if (lane == 0) a.out0[static_cast<size_t>(row)"
                        f" * a.top_k] = {value};\n  return;\n" + at)


def split() -> list[dict]:
    """Where the warp kernel's time goes at SHAPES: the device ms of the
    package's kernels beside copies cut short after the k-mer keys, after
    the table loads and after the gathers (their outputs are not the
    function's: timing only), in turns."""
    import os
    import torch
    from anchored_fusion_tpu_torch.ops import cuda_build, seed_vote_cuda
    with open(seed_vote_cuda.SOURCE) as fh:
        text = fh.read()
    table = _cut(text, _CUT_TABLE, "S")
    assert _TABLE_LOADS in table
    cuts = {"full": text,
            "to_gathers": _cut(text, _CUT_GATHERS, "h"),
            "to_table": table,
            "to_keys": table.replace(_TABLE_LOADS,
                                     "    lo = static_cast<int>(b & 3);\n"
                                     "    hi = lo + (key & 1);")}
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    fns = {}
    for name, src in cuts.items():
        path = os.path.join(cuda_build.BUILD_DIR, f"seed_vote_{name}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        fns[name] = load_launch(path, f"seed_vote_{name}")
    recs = []
    for shape in SHAPES:
        args, tile, _ = shape_inputs(shape)
        rec = {"kernel": "seed_vote", "split": shape[0]}
        for order in (list(cuts), list(cuts)[::-1]):
            for name in order:
                rec.setdefault(name, []).append(
                    device_ms(lambda f=fns[name]: f(args, tile)))
        print(json.dumps(rec), flush=True)
        recs.append(rec)
        del args, tile
        torch.cuda.empty_cache()
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline",
                    help="another version of csrc/seed_vote.cu to time "
                         "beside it")
    ap.add_argument("--split", action="store_true",
                    help="time the warp kernel cut short at each step")
    args = ap.parse_args()
    if not args.baseline and not args.split:
        ap.error("give --baseline, --split or both")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("seed_vote_bench: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.split:
        split()
    if not args.baseline:
        return 0
    recs = compare(args.baseline)
    ok = all(r["equal"] and r["baseline_equal"] for r in recs)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
