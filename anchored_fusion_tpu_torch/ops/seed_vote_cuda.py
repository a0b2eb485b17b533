"""Wrapper of the genome engines' seeding kernel (csrc/seed_vote.cu).

``seed_vote``: (2B, R) oriented reads and a k-mer index -> the top_k
most-voted diagonals of each row, in diag mode (flat and sharded engines)
or tile mode (XL engine); see ops/seed_vote.py for what it computes.

A tensor on the CPU goes to the plain version (ops/seed_vote.py); a CUDA
tensor launches the kernel, which is built at first use with ``nvcc`` for
sm_90a from the package's own source (ops/cuda_build.py) and bound with
ctypes.  A failed build or launch raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import re
from typing import Optional

import torch

from anchored_fusion_tpu_torch.ops import cuda_build
from anchored_fusion_tpu_torch.ops.seed_vote import seed_vote_plain

SOURCE = os.path.join(cuda_build.CSRC, "seed_vote.cu")
# The warp kernel: a warp a row, WARP_ROWS rows a block (the source's
# kWarpRows), for launches of at most WARP_KMERS k-mers a row and rows at
# most WARP_MAX_R wide.  A warp lists up to WARP_CAPACITY in-range hit
# slots (12 bytes each in shared memory) and sorts as many keys in
# registers (the source's kWarpHits); a row with more than WARP_HITS of
# them (0 lists every row with a slot) is listed for the rows kernel.
WARP_ROWS = 8
WARP_KMERS = 128
WARP_MAX_R = 2048
WARP_CAPACITY = 256
WARP_HITS = WARP_CAPACITY
# The rows kernel: a block of ROW_THREADS (the source's kRowThreads) a row,
# at most BLOCK_GRID blocks; a row's k-mer area and sort area in at most
# SMEM_BYTES of shared memory, past it in a global scratch buffer of at
# most SCRATCH_BYTES.
ROW_THREADS = 256
BLOCK_GRID = 528
SMEM_BYTES = 64 * 1024
SCRATCH_BYTES = 1 << 30

_lib = None
# Kernel launches in this process (one a call: the warp kernel and the
# rows kernel behind it); the plain version never counts.
launches = 0


def build() -> str:
    return cuda_build.build(SOURCE, "seed_vote")


def ptxas_usage() -> list[dict]:
    """Registers, shared memory and spill bytes of both kernels in both
    instantiations (diag and tile mode), from the ptxas report of the
    build."""
    out = []
    for e in cuda_build.ptxas_report(SOURCE, "seed_vote"):
        m = re.search(r"(seed_vote_(?:warp|rows)_kernel)ILb([01])E",
                      e["entry"])
        if m:
            out.append({"kernel": m.group(1),
                        "mode": "tile" if m.group(2) == "1" else "diag",
                        **{k: v for k, v in e.items() if k != "entry"}})
    return out


def bind(lib):
    """Set the C entry's argument types on a loaded library."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.seed_vote_launch.restype = i32
    lib.seed_vote_launch.argtypes = [
        ptr, *[i32] * 6, ptr, ptr, i64, ptr, ptr, i64, *[i32] * 9, ptr,
        *[i32] * 3, ptr, i64, ptr, ptr, ptr]
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(build()))
    return _lib


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def plan(N: int, Q: int, H: int, R: int) -> dict:
    """How a launch of N rows of width R, Q k-mers and H slots is laid out.

    ``warp``: whether the warp kernel runs (``warp_grid`` blocks,
    ``warp_smem`` bytes of shared memory, rows of at most ``warp_hits``
    in-range slots); the rows kernel then takes the rows it lists, else
    every row.  ``slots``: the largest sort of the rows kernel (a power of
    two at or above Q*H); ``kmer_bytes`` its k-mer area, in shared memory
    when ``kmer_shared``; ``block_smem`` its shared memory; ``scratch_ws``
    the bytes of a block's scratch slice (0: no scratch, every row fits in
    shared memory); ``block_grid`` its blocks."""
    warp = Q <= WARP_KMERS and R <= WARP_MAX_R
    P = 2
    while P < Q * H:
        P <<= 1
    kmer = _align16(12 * Q + 4)
    need = kmer + 12 * P
    smem = min(need, SMEM_BYTES)
    kmer_shared = need <= smem or kmer <= smem // 2
    ws = 0 if need <= smem else (0 if kmer_shared else kmer) + 12 * P
    grid = max(1, min(N, BLOCK_GRID,
                      SCRATCH_BYTES // ws if ws else BLOCK_GRID))
    return {"warp": warp, "warp_grid": -(-N // WARP_ROWS) if warp else 0,
            "warp_smem": WARP_ROWS * (_align16(R) + 12 * WARP_CAPACITY),
            "warp_hits": WARP_HITS, "slots": P, "kmer_bytes": kmer,
            "kmer_shared": kmer_shared, "block_smem": smem,
            "scratch_ws": ws, "block_grid": grid}


def _require(tensors, device) -> None:
    """Types first, then layout and device, of (name, tensor, dtype)."""
    for name, t, dtype in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    for name, t, _ in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                             f"got {t.device}")


def _check(flat, table, keys_sorted, pos, offsets, k, kb, stride, max_hits,
           top_k) -> tuple:
    """Shape and type checks common to both versions: (N, R, Q)."""
    if flat.dim() != 2:
        raise ValueError("flat must be a (2B, R) tensor")
    for name, t in (("table", table), ("keys_sorted", keys_sorted),
                    ("pos", pos), ("offsets", offsets)):
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D")
    N, R = flat.shape
    if not 1 <= k <= 15 or not 1 <= kb <= k or stride < 1:
        raise ValueError(f"k = {k}, kb = {kb}, stride = {stride} out of "
                         "range (1 <= kb <= k <= 15)")
    if R < k:
        raise ValueError(f"read width {R} is below k = {k}")
    Q = (R - k) // stride + 1
    if offsets.shape[0] != Q:
        raise ValueError(f"{offsets.shape[0]} offsets for {Q} k-mers")
    if max_hits < 1 or not 1 <= top_k <= Q * max_hits:
        raise ValueError(f"top_k = {top_k} outside 1..{Q * max_hits} "
                         f"(max_hits = {max_hits})")
    if table.shape[0] < 2 or pos.shape[0] < 1:
        raise ValueError("empty table or position array")
    if kb < k and keys_sorted.shape[0] < pos.shape[0]:
        raise ValueError("keys_sorted is shorter than pos")
    if Q * max_hits >= 2 ** 30:
        raise ValueError(f"{Q * max_hits} hit slots a row exceed the kernel")
    return N, R, Q


def launch(flat: torch.Tensor, table: torch.Tensor,
           keys_sorted: torch.Tensor, pos: torch.Tensor,
           offsets: torch.Tensor, k: int, kb: int, stride: int,
           max_hits: int, top_k: int, tile: Optional[tuple] = None,
           lib=None):
    """Check the inputs and launch seed_vote_launch of ``lib`` (a library
    bound by ``bind``; the package's own by default) on the current
    stream; the outputs of ops/seed_vote.py::seed_vote_plain.  Counts
    nothing."""
    dev = flat.device
    N, R, Q = _check(flat, table, keys_sorted, pos, offsets, k, kb, stride,
                     max_hits, top_k)
    _require((("flat", flat, torch.int8), ("table", table, torch.int32),
              ("keys_sorted", keys_sorted, torch.int32),
              ("pos", pos, torch.int32), ("offsets", offsets, torch.int32)),
             dev)
    rowdiv, stride_idx, T = tile if tile is not None else (1, 1, 0)
    if tile is not None and (rowdiv < 1 or stride_idx < 1 or T < 1):
        raise ValueError(f"tile geometry {tile} out of range")
    if not 0 <= WARP_HITS <= WARP_CAPACITY:
        raise ValueError(f"WARP_HITS = {WARP_HITS} outside "
                         f"0..{WARP_CAPACITY}")
    p = plan(N, Q, max_hits, R)
    out0 = torch.empty((N, top_k), dtype=torch.int32, device=dev)
    out1 = (torch.empty((N, top_k), dtype=torch.int32, device=dev)
            if tile is not None else None)
    if N:
        spill = (torch.empty(1 + N, dtype=torch.int32, device=dev)
                 if p["warp"] else None)
        scratch = (torch.empty(p["block_grid"] * p["scratch_ws"],
                               dtype=torch.uint8, device=dev)
                   if p["scratch_ws"] else None)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        lib = _load() if lib is None else lib
        with torch.cuda.device(dev):
            err = lib.seed_vote_launch(
                flat.data_ptr(), N, R, k, kb, stride, Q, offsets.data_ptr(),
                table.data_ptr(), table.shape[0], keys_sorted.data_ptr(),
                pos.data_ptr(), pos.shape[0], max_hits, top_k,
                int(tile is not None), rowdiv, stride_idx, T,
                p["warp_grid"], p["warp_smem"], WARP_HITS, ptr(spill),
                p["block_grid"], p["block_smem"], int(p["kmer_shared"]),
                ptr(scratch), p["scratch_ws"], out0.data_ptr(), ptr(out1),
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"seed_vote_launch failed: cudaError {err}")
    return out0 if tile is None else (out0, out1)


def seed_vote_cuda(flat: torch.Tensor, table: torch.Tensor,
                   keys_sorted: torch.Tensor, pos: torch.Tensor,
                   offsets: torch.Tensor, k: int, kb: int, stride: int,
                   max_hits: int, top_k: int, tile: Optional[tuple] = None):
    """Launch the seeding kernels on the current stream; the outputs of
    ops/seed_vote.py::seed_vote_plain."""
    global launches
    out = launch(flat, table, keys_sorted, pos, offsets, k, kb, stride,
                 max_hits, top_k, tile)
    if flat.shape[0]:
        launches += 1
    return out


def seed_vote(flat: torch.Tensor, table: torch.Tensor,
              keys_sorted: torch.Tensor, pos: torch.Tensor,
              offsets: torch.Tensor, k: int, kb: int, stride: int,
              max_hits: int, top_k: int, tile: Optional[tuple] = None):
    """(2B, R) int8 oriented reads -> (2B, top_k) int32 voted diagonals
    (diag mode), or (rows_c, cols_c) with ``tile=(rowdiv, stride_idx,
    T)``.  CUDA tensors run the kernel, CPU tensors the plain version."""
    args = (flat, table, keys_sorted, pos, offsets, k, kb, stride, max_hits,
            top_k)
    if flat.is_cuda:
        return seed_vote_cuda(*args, tile=tile)
    _check(*args)
    return seed_vote_plain(*args, tile=tile)
