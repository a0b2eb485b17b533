"""Inputs, bounds and timing for the Smith-Waterman kernel (csrc/sw.cu), and
a comparison on one card with another version of its source.

    python -m anchored_fusion_tpu_torch.bench.sw_bench --baseline OLD/sw.cu

builds OLD/sw.cu (any source that exports ``sw_align_launch``, with or
without the strips' ``scratch`` argument) beside the package's own kernel
and prints one JSON line per shape: both kernels' times, each launched by
the same bare ctypes call (median of 50 warm launches, CUDA events), taken
in turns baseline, new, new, baseline; the time of the package's wrapper
(``sw_align_fused_cuda``, its checks and allocations included); every
output held equal to the plain version; and the bound of the shape.  chip_smoke.py uses the inputs,
bounds and timer of this module for its kernel phase.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess

import numpy as np

PAD = 5

# H100 SXM peak rates, for the bound: HBM at 3.35 TB/s; int32 add, subtract,
# compare, select, min and max issue on 64 lanes per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0), 132 SMs at 1.98 GHz.  The DPX max-plus instructions are counted at
# the same rate: no separate peak is published for them.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per DP cell in the kernel's recurrence (csrc/sw.cu):
# compare and select for s, IADD3 (diag + s + column penalty),
# __vimax3_s32_relu for H, one subtract for H - go, __viaddmax_s32 for E and
# for F (7), plus the running best (a __vimax3_s32 per two rows and a
# __vibmax_s32 per lane step, rounded up to 1).
KERNEL_OPS_PER_CELL = 8
# The same count for the recurrence as ops/sw.py writes it: the substitution
# select, E (2 subtracts, 1 max), HnoF (1 add, 2 max), F (2 subtracts,
# 1 max), H (1 max) and the running best (1 max).
PLAIN_OPS_PER_CELL = 12


def sw_inputs(rng, B, R, W, read_len):
    """SW pairs: reads of ``read_len`` bases in R-wide rows; windows holding
    each read with implanted indels and SNPs, plus N bases, PAD tails and
    all-PAD rows."""
    reads = rng.integers(0, 4, (B, R)).astype(np.int8)
    reads[:, read_len:] = PAD
    wins = rng.integers(0, 4, (B, W)).astype(np.int8)
    for b in range(B):
        seg = reads[b, :read_len].copy()
        p = int(rng.integers(read_len // 4, 3 * read_len // 4))
        if b % 4 == 1:
            seg = np.concatenate([seg[:p], seg[p + 3:]])
        elif b % 4 == 2:
            seg = np.concatenate([seg[:p], rng.integers(0, 4, 2).astype(
                np.int8), seg[p:]])
        elif b % 4 == 3:
            seg[p] = (seg[p] + 1) % 4
        o = int(rng.integers(0, max(1, W - read_len)))
        seg = seg[:W - o]
        wins[b, o:o + len(seg)] = seg
        if b % 5 == 0:
            reads[b, int(rng.integers(0, read_len))] = 4
        if b % 7 == 0:
            wins[b, int(rng.integers(0, W))] = 4
        if b % 6 == 0:
            wins[b, W - int(rng.integers(1, 24)):] = PAD
        if b % 97 == 0:
            reads[b, :] = PAD
    return reads, wins


def tie_inputs(rng, B, R, W, read_len):
    """Pairs whose best score is reached at many cells: all-A reads against
    all-A windows, period-2 and period-3 repeats at shifted phases, and one
    read repeated against one window, in turn."""
    reads = np.full((B, R), PAD, np.int8)
    wins = np.full((B, W), PAD, np.int8)
    one_r, one_w = sw_inputs(rng, 1, R, W, read_len)
    for b in range(B):
        kind = b % 4
        n = read_len - b % 7
        if kind == 0:
            reads[b, :n] = 0
            wins[b, :W - b % 5] = 0
        elif kind in (1, 2):
            p = kind + 1
            reads[b, :n] = np.arange(n) % p
            wins[b] = (np.arange(W) + b) % p
        else:
            reads[b], wins[b] = one_r[0], one_w[0]
    return reads, wins


def random_masks(rng, reads, wins):
    """Validity masks for sw_end: ``code != PAD`` with 10% of the cells
    cleared at random, 3% of the cells set (a valid PAD code scores a
    mismatch) and every 7th read row cleared."""
    rv = (reads != PAD) & (rng.random(reads.shape) > 0.1)
    wv = (wins != PAD) & (rng.random(wins.shape) > 0.1)
    rv |= rng.random(reads.shape) < 0.03
    wv |= rng.random(wins.shape) < 0.03
    rv[::7] = False
    return rv, wv


def dp_cells(read_valid, window_valid, end_read=None, end_win=None) -> float:
    """DP cells this data needs: valid read x valid window bases per pair
    (forward pass) and, given the forward end, the same over each pair's
    prefix up to it (reverse pass).  Tensors of one device."""
    import torch
    rv, wv = read_valid.bool(), window_valid.bool()
    cells = rv.sum(1).double() * wv.sum(1).double()
    if end_read is not None:
        ar_r = torch.arange(rv.shape[1], device=rv.device)[None, :]
        ar_w = torch.arange(wv.shape[1], device=wv.device)[None, :]
        cells = cells + ((rv & (ar_r <= end_read.long()[:, None])).sum(1)
                         .double() * (wv & (ar_w <= end_win.long()[:, None]))
                         .sum(1).double())
    return float(cells.sum())


def bound_ms(cells: float, nbytes: int, ops_per_cell: int) -> float:
    """Least time for the work: cells x ops at the int32 rate, or the bytes
    in and out at the HBM rate, whichever is larger."""
    return max(cells * ops_per_cell / INT32_OPS_PER_S,
               nbytes / HBM_BYTES_PER_S) * 1e3


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` timed calls (CUDA events), after one warm call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        st = torch.cuda.Event(enable_timing=True)
        en = torch.cuda.Event(enable_timing=True)
        st.record()
        fn()
        en.record()
        torch.cuda.synchronize()
        times.append(st.elapsed_time(en))
    times.sort()
    return times[len(times) // 2]


def load_baseline(source: str):
    """Build another version of csrc/sw.cu and return its fused entry as
    ``fn(reads, windows) -> (5, B) int32``."""
    import torch
    from anchored_fusion_tpu_torch.ops import sw_cuda
    with open(source, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    so = os.path.join(sw_cuda.BUILD_DIR, f"baseline_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(sw_cuda.BUILD_DIR, exist_ok=True)
        cmd = [sw_cuda._nvcc(), *sw_cuda.NVCC_FLAGS, "-o", so, source]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {proc.stderr}")
    with open(source) as fh:
        strips = "void* scratch" in fh.read()
    lib = ctypes.CDLL(so)
    lib.sw_align_launch.restype = ctypes.c_int
    lib.sw_align_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p] * (3 if strips else 2)

    def run(reads, wins, match=1, mismatch=4, gap_open=6, gap_extend=1):
        B, R = reads.shape
        W = wins.shape[1]
        out = torch.empty((5, B), dtype=torch.int32, device=reads.device)
        scratch = []
        if strips:
            buf = (torch.empty((B, 2, W, 2), dtype=torch.int32,
                               device=reads.device)
                   if R > sw_cuda.STRIP_ROWS else None)
            scratch = [None if buf is None else buf.data_ptr()]
        err = lib.sw_align_launch(
            reads.data_ptr(), wins.data_ptr(), B, R, W, match,
            mismatch, gap_open, gap_extend, *scratch, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline launch failed: cudaError {err}")
        return out
    return run


# (B, R, W, read length): the main path's two batches, then the rest of
# chip_smoke.py's KERNEL_SHAPES (every one within a single strip of rows)
COMPARE_SHAPES = [(30, 128, 160, 101), (22, 128, 160, 101),
                  (64, 128, 160, 101), (256, 128, 160, 101),
                  (1024, 128, 160, 101), (1000, 128, 160, 101),
                  (4096, 128, 160, 101), (1000, 101, 133, 101),
                  (1000, 256, 288, 250), (64, 1024, 1056, 1000)]


def compare(baseline: str, seed: int = 0) -> list[dict]:
    import torch
    from anchored_fusion_tpu_torch.ops import sw_cuda
    from anchored_fusion_tpu_torch.ops.sw import sw_align_fused_plain
    base = load_baseline(baseline)
    cur = load_baseline(sw_cuda.SOURCE)
    rng = np.random.default_rng(seed)
    recs = []
    for B, R, W, lr in COMPARE_SHAPES:
        reads, wins = (torch.from_numpy(x).cuda()
                       for x in sw_inputs(rng, B, R, W, lr))
        want = sw_align_fused_plain(reads, wins)
        new = lambda: cur(reads, wins)  # noqa: E731
        old = lambda: base(reads, wins)  # noqa: E731
        wrap = lambda: sw_cuda.sw_align_fused_cuda(reads, wins)  # noqa: E731
        equal = [bool(torch.equal(f(), want)) for f in (old, new, wrap)]
        t = [time_ms(f, 50) for f in (old, new, new, old)]
        cells = dp_cells(reads != PAD, wins != PAD, want[1], want[2])
        nbytes = reads.numel() + wins.numel() + want.numel() * 4
        rec = {"B": B, "R": R, "W": W, "baseline_equal": equal[0],
               "equal": equal[1] and equal[2], "baseline_ms": [t[0], t[3]],
               "ms": [t[1], t[2]], "wrapper_ms": time_ms(wrap, 50),
               "bound_ms": bound_ms(cells, nbytes, KERNEL_OPS_PER_CELL),
               "bound_ms_12op": bound_ms(cells, nbytes, PLAIN_OPS_PER_CELL)}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="another version of csrc/sw.cu to time beside it")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sw_bench: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    recs = compare(args.baseline)
    ok = all(r["equal"] and r["baseline_equal"] for r in recs)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
