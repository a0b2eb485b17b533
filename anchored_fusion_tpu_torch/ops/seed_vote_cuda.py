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
# A row's workspace (sort keys, run counts, k-mer keys and ranges) lives in
# shared memory up to this many bytes, past it in a global scratch buffer.
SMEM_BYTES = 200 * 1024
# Blocks of a launch whose rows use the global scratch, and its byte budget.
SCRATCH_BLOCKS = 528
SCRATCH_BYTES = 1 << 30
MIN_SLOTS = 64          # the smallest sort (a block of 32 threads or more)
MAX_THREADS = 512

_lib = None
# Kernel launches in this process; the plain version never counts.
launches = 0


def build() -> str:
    return cuda_build.build(SOURCE, "seed_vote")


def ptxas_usage() -> list[dict]:
    """Registers, shared memory and spill bytes of both instantiations
    (diag and tile mode), from the ptxas report of the build."""
    out = []
    for e in cuda_build.ptxas_report(SOURCE, "seed_vote"):
        m = re.search(r"seed_vote_kernelILb([01])E", e["entry"])
        if m:
            out.append({"kernel": "seed_vote_kernel",
                        "mode": "tile" if m.group(1) == "1" else "diag",
                        **{k: v for k, v in e.items() if k != "entry"}})
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.seed_vote_launch.restype = i32
        lib.seed_vote_launch.argtypes = [
            ptr, *[i32] * 6, ptr, ptr, i64, ptr, ptr, i64, *[i32] * 7,
            ptr, i64, i32, i32, ptr, ptr, ptr]
        _lib = lib
    return _lib


def plan(N: int, Q: int, H: int) -> dict:
    """How a launch of N rows of Q k-mers and H slots is laid out: the
    sort's slots P (a power of two), the workspace bytes a row, whether it
    lies in shared memory, the grid and the threads a block."""
    n = Q * H
    P = max(MIN_SLOTS, 1 << max(0, n - 1).bit_length())
    ws = -(-(12 * P + 12 * Q) // 16) * 16
    shared = ws <= SMEM_BYTES
    grid = N if shared else max(1, min(N, SCRATCH_BLOCKS,
                                       SCRATCH_BYTES // ws))
    return {"slots": P, "workspace_bytes": ws, "shared": shared,
            "grid": grid, "threads": min(MAX_THREADS, P // 2)}


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


def seed_vote_cuda(flat: torch.Tensor, table: torch.Tensor,
                   keys_sorted: torch.Tensor, pos: torch.Tensor,
                   offsets: torch.Tensor, k: int, kb: int, stride: int,
                   max_hits: int, top_k: int, tile: Optional[tuple] = None):
    """Launch the seeding kernel on the current stream; the outputs of
    ops/seed_vote.py::seed_vote_plain."""
    global launches
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
    p = plan(N, Q, max_hits)
    out0 = torch.empty((N, top_k), dtype=torch.int32, device=dev)
    out1 = (torch.empty((N, top_k), dtype=torch.int32, device=dev)
            if tile is not None else None)
    if N:
        scratch = (None if p["shared"] else
                   torch.empty(p["grid"] * p["workspace_bytes"],
                               dtype=torch.uint8, device=dev))
        lib = _load()
        with torch.cuda.device(dev):
            err = lib.seed_vote_launch(
                flat.data_ptr(), N, R, k, kb, stride, Q, offsets.data_ptr(),
                table.data_ptr(), table.shape[0], keys_sorted.data_ptr(),
                pos.data_ptr(), pos.shape[0], max_hits, top_k, p["slots"],
                int(tile is not None), rowdiv, stride_idx, T,
                None if scratch is None else scratch.data_ptr(),
                p["workspace_bytes"], p["grid"], p["threads"],
                out0.data_ptr(), None if out1 is None else out1.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"seed_vote_launch failed: cudaError {err}")
        launches += 1
    return out0 if tile is None else (out0, out1)


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
