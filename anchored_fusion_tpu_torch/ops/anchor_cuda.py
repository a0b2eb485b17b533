"""Wrapper of the anchored aligner's hand-written CUDA kernels
(csrc/anchor.cu).

- ``seed_block_max``: (2B, R) oriented reads and a SeedPatch -> the
  per-128-diagonal-block maximum of the bfloat16-rounded match counts and
  its first lane, (2B, nb) int32 each, without the (2B, D) count matrix.
- ``extend_fold``: the Kadane extension of k candidates per oriented read
  — the stable top-k of those block maxima, or given offsets — and the
  strand fold: the nine per-read record fields; in tile mode (the XL
  engine) given (row, col) candidates of a tiled genome and the ten
  TILE_FIELDS rows.
- ``seed_block_topk`` (the seeding kernel's top-k epilogue) and
  ``extend_segments`` (the extension kernel's segments mode): the
  all-hits programs — each 128-diagonal block's top-k keys, (2B, nb, k)
  int32, and the Kadane segment of every candidate with no best-of-k and
  no fold, (N, k) int32 fields, its candidates given offsets, (row, col)
  tile candidates, or the row's top k of those keys.

A tensor on the CPU goes to the plain version (ops/anchor.py); a CUDA
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
from anchored_fusion_tpu_torch.ops.anchor import (
    BLOCK, K_CHUNK, SEGMENT_FIELDS, TILE_FIELDS, SeedPatch,
    extend_fold_plain, extend_segments_plain, seed_block_max_plain,
    seed_block_topk_plain)

SOURCE = os.path.join(cuda_build.CSRC, "anchor.cu")
MAX_K = 128             # candidates a row: the extension's offset table
MAX_TOPK = 16           # keys a block of the seeding's top-k epilogue
MAX_ROWS = 65535 * 128  # rows a seeding launch takes

_lib = None
# Kernel launches in this process, one count per kernel; the plain versions
# never count.
seed_launches = 0       # seed_block_max_cuda
fold_launches = 0       # extend_fold_cuda, block and offsets modes
tile_launches = 0       # extend_fold_cuda, tile mode
topk_launches = 0       # seed_block_topk_cuda
segment_launches = 0    # extend_segments_cuda, every candidate source


def build() -> str:
    return cuda_build.build(SOURCE, "anchor")


def ptxas_usage() -> list[dict]:
    """Registers, static shared memory and spill bytes of every kernel
    instantiation (the seeding kernel's by stream stride and variant), from
    the ptxas report of the build."""
    out = []
    for e in cuda_build.ptxas_report(SOURCE, "anchor"):
        m = re.search(r"(seed_block_max_kernel|extend_fold_kernel)"
                      r"(?:ILi(\d+)ELb([01])ELi(\d+)E(?:Li(\d+)E)?)?",
                      e["entry"])
        if not m:
            continue
        cur = {"kernel": m.group(1)}
        if m.group(2):
            cur["stream_stride"] = int(m.group(2))
            cur["chunked"] = m.group(3) == "1"
            cur["stage_steps"] = int(m.group(4))
            cur["topk_list"] = int(m.group(5) or 0)
        out.append({**cur, **{k: v for k, v in e.items() if k != "entry"}})
    return out


def seed_plan(M: int, R: int, stride: int, D: int) -> dict:
    """How the seeding kernel lays out a launch of this shape on the current
    card: stream stride and dilation, the read's k-steps and those a stage
    (a bucket, or a chunk), the K-chunked variant, the item split (G groups
    of TPG diagonal tiles a 128-row tile), the persistent grid and the
    dynamic shared memory a CTA."""
    lib = _load()
    out = (ctypes.c_int * 9)()
    err = lib.seed_block_max_plan(M, R, stride, -(-R // stride), D, out)
    if err != 0:
        raise RuntimeError(f"seed_block_max_plan failed: cudaError {err}")
    return dict(zip(("stream_stride", "dilation", "k_steps", "stage_steps",
                     "chunked", "G", "TPG", "grid", "smem_bytes"),
                    list(out)))


def bind(lib):
    """Set the argument types of a built anchor library's C entries (the
    plan, tile-mode, top-k and segments entries only where the source has
    them)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.seed_block_max_launch.restype = i32
    lib.seed_block_max_launch.argtypes = [ptr, *[i32] * 4, ptr,
                                          *[i32] * 3, ptr, ptr, ptr]
    lib.extend_fold_launch.restype = i32
    lib.extend_fold_launch.argtypes = [ptr, ptr, *[i32] * 3, ptr, i64,
                                       i64, ptr, ptr, ptr, *[i32] * 4,
                                       ptr, ptr, ptr]
    if hasattr(lib, "extend_fold_tiles_launch"):
        lib.extend_fold_tiles_launch.restype = i32
        lib.extend_fold_tiles_launch.argtypes = [ptr, ptr, *[i32] * 3, ptr,
                                                 i64, i64, i64, ptr, ptr,
                                                 i32, i32, ptr, ptr]
    if hasattr(lib, "seed_block_topk_launch"):
        lib.seed_block_topk_launch.restype = i32
        lib.seed_block_topk_launch.argtypes = [ptr, *[i32] * 4, ptr,
                                               *[i32] * 4, ptr, ptr]
    if hasattr(lib, "extend_segments_launch"):
        lib.extend_segments_launch.restype = i32
        lib.extend_segments_launch.argtypes = [ptr, *[i32] * 3, ptr, i64,
                                               i64, ptr, ptr, i64, ptr,
                                               *[i32] * 5, ptr, ptr]
    if hasattr(lib, "seed_block_max_plan"):
        lib.seed_block_max_plan.restype = i32
        lib.seed_block_max_plan.argtypes = [*[i32] * 5, ptr]
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(build()))
    return _lib


def _require(name: str, t: torch.Tensor, dtype, dim: int,
             device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D tensor")
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                         f"got {t.device}")


def _run(fn: str, args, device: torch.device) -> None:
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} failed: cudaError {err}")


def _check_seed(flat: torch.Tensor, seed: SeedPatch, stride: int) -> int:
    """The seeding kernel's input checks; the patch matrix's block count."""
    _require("flat", flat, torch.int8, 2, flat.device)
    _require("seed.i8", seed.i8, torch.int8, 2, flat.device)
    M, R = flat.shape
    D, Rs = seed.diagonals, seed.positions
    nb = -(-D // BLOCK)
    if stride < 1 or Rs != -(-R // stride):
        raise ValueError(f"patch matrix of {Rs} positions does not fit "
                         f"reads of width {R} at stride {stride}")
    if tuple(seed.i8.shape) != (nb * BLOCK, -(-4 * Rs // K_CHUNK) * K_CHUNK):
        raise ValueError(f"seed.i8 shape {tuple(seed.i8.shape)} is not the "
                         f"padded transpose of a ({4 * Rs}, {D}) matrix")
    if M > MAX_ROWS or R * 256 >= 2 ** 31:
        raise ValueError(f"{M} rows of width {R} exceed the kernel's grid")
    return nb


def seed_block_max_cuda(flat: torch.Tensor, seed: SeedPatch,
                        stride: int = 1):
    """Launch the seeding kernel on the current stream; (bmax, lane)."""
    global seed_launches
    nb = _check_seed(flat, seed, stride)
    M, R = flat.shape
    D, Rs = seed.diagonals, seed.positions
    bmax = torch.empty((M, nb), dtype=torch.int32, device=flat.device)
    lane = torch.empty((M, nb), dtype=torch.int32, device=flat.device)
    if M:
        _run("seed_block_max_launch",
             (flat.data_ptr(), M, R, stride, Rs, seed.i8.data_ptr(), D,
              seed.i8.shape[1], nb, bmax.data_ptr(), lane.data_ptr()),
             flat.device)
        seed_launches += 1
    return bmax, lane


def seed_block_topk_cuda(flat: torch.Tensor, seed: SeedPatch, stride: int,
                         k: int) -> torch.Tensor:
    """Launch the seeding kernel with its top-k epilogue on the current
    stream; keys (M, nb, k) int32 (ops/anchor.py::block_topk_keys)."""
    global topk_launches
    if not 1 <= k <= MAX_TOPK:
        # the epilogue's lists are registers
        raise ValueError(f"k = {k} outside 1..{MAX_TOPK}")
    nb = _check_seed(flat, seed, stride)
    M, R = flat.shape
    keys = torch.empty((M, nb, k), dtype=torch.int32, device=flat.device)
    if M:
        _run("seed_block_topk_launch",
             (flat.data_ptr(), M, R, stride, seed.positions,
              seed.i8.data_ptr(), seed.diagonals, seed.i8.shape[1], nb, k,
              keys.data_ptr()), flat.device)
        topk_launches += 1
    return keys


def extend_segments_cuda(flat: torch.Tensor, refp: torch.Tensor,
                         prepad: int, match: int, mismatch: int,
                         offs: Optional[torch.Tensor] = None,
                         rows: Optional[torch.Tensor] = None,
                         keys: Optional[torch.Tensor] = None,
                         D: Optional[int] = None,
                         k: Optional[int] = None) -> dict:
    """Launch the extension kernel's segments mode on the current stream;
    the fields of ops/anchor.py::extend_segments_plain (keys mode: and
    ``off``)."""
    global segment_launches
    dev = flat.device
    _require("flat", flat, torch.int8, 2, dev)
    N, R = flat.shape
    if rows is not None:
        if offs is None:
            raise ValueError("tile mode takes rows and offs (the columns)")
        _require("tiles", refp, torch.int8, 2, dev)
        W = refp.shape[1]
        for name, t in (("rows", rows), ("cols", offs)):
            _require(name, t, torch.int32, 2, dev)
            if tuple(t.shape) != tuple(rows.shape) or t.shape[0] != N:
                raise ValueError(f"{name} shape {tuple(t.shape)} is not "
                                 f"({N}, k)")
    else:
        _require("refp", refp, torch.int8, 1, dev)
        W = 0
    if R > (W if rows is not None else refp.shape[0]):
        raise ValueError(f"read width {R} exceeds the reference's row of "
                         f"{W if rows is not None else refp.shape[0]} codes")
    nb = kt = 0
    if offs is not None:
        _require("offs", offs, torch.int32, 2, dev)
        if offs.shape[0] != N:
            raise ValueError(f"offs shape {tuple(offs.shape)} is not "
                             f"({N}, k)")
        k = offs.shape[1]
        ptrs = (offs.data_ptr(), None if rows is None else rows.data_ptr(),
                None)
    else:
        _require("keys", keys, torch.int32, 3, dev)
        nb, kt = keys.shape[1], keys.shape[2]
        if keys.shape[0] != N or D is None or nb != -(-D // BLOCK):
            raise ValueError("keys must be (N, ceil(D / 128), kt)")
        if k is None or k < 1 or min(k, D) > kt or kt > MAX_TOPK:
            raise ValueError(f"top {k} of {kt} keys a block (at most "
                             f"{MAX_TOPK})")
        k = min(k, D)
        ptrs = (None, None, keys.data_ptr())
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k} outside 1..{MAX_K}")
    fields = SEGMENT_FIELDS + (("off",) if keys is not None and offs is None
                               else ())
    out = torch.empty((len(fields), N, k), dtype=torch.int32, device=dev)
    if N:
        _run("extend_segments_launch",
             (flat.data_ptr(), N, R, k, refp.data_ptr(), refp.numel(),
              prepad, ptrs[0], ptrs[1], W, ptrs[2], nb, kt, D or 0, match,
              mismatch, out.data_ptr()), dev)
        segment_launches += 1
    return dict(zip(fields, out))


def _extend_fold_tiles_cuda(flat, coord_off, tiles, halo, match, mismatch,
                            k, rows, cols) -> dict:
    """The extension kernel's tile mode: candidates (rows, cols), windows
    ``tiles[row, clamp(col + halo, 0, W - R) : ... + R]``."""
    global tile_launches
    dev = flat.device
    N, R = flat.shape
    _require("tiles", tiles, torch.int8, 2, dev)
    for name, t in (("rows", rows), ("cols", cols)):
        _require(name, t, torch.int32, 2, dev)
        if tuple(t.shape) != (N, k):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(N, k)}")
    if R > tiles.shape[1]:
        raise ValueError(f"read width {R} exceeds the tile width "
                         f"{tiles.shape[1]}")
    B = N // 2
    out = torch.empty((len(TILE_FIELDS), B), dtype=torch.int32, device=dev)
    if B:
        _run("extend_fold_tiles_launch",
             (flat.data_ptr(), coord_off.data_ptr(), B, R, k,
              tiles.data_ptr(), tiles.numel(), tiles.shape[1], halo,
              rows.data_ptr(), cols.data_ptr(), match, mismatch,
              out.data_ptr()), dev)
        tile_launches += 1
    return dict(zip(TILE_FIELDS, out))


def extend_fold_cuda(flat: torch.Tensor, coord_off: torch.Tensor,
                     refp: torch.Tensor, prepad: int, match: int,
                     mismatch: int, k: int,
                     offs: Optional[torch.Tensor] = None,
                     bmax: Optional[torch.Tensor] = None,
                     lane: Optional[torch.Tensor] = None,
                     D: Optional[int] = None,
                     rows: Optional[torch.Tensor] = None) -> dict:
    """Launch the extension kernel on the current stream; the records of
    ops/anchor.py::extend_fold_plain."""
    global fold_launches
    dev = flat.device
    _require("flat", flat, torch.int8, 2, dev)
    _require("coord_off", coord_off, torch.int32, 1, dev)
    N, R = flat.shape
    if N % 2 or coord_off.shape[0] != N:
        raise ValueError("flat must hold 2B rows and coord_off 2B offsets")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k} outside 1..{MAX_K}")
    if rows is not None:
        return _extend_fold_tiles_cuda(flat, coord_off, refp, prepad, match,
                                       mismatch, k, rows, offs)
    _require("refp", refp, torch.int8, 1, dev)
    if R > refp.shape[0]:
        raise ValueError(f"read width {R} exceeds the reference's "
                         f"{refp.shape[0]} codes")
    if offs is not None:
        _require("offs", offs, torch.int32, 2, dev)
        if tuple(offs.shape) != (N, k):
            raise ValueError(f"offs shape {tuple(offs.shape)} != {(N, k)}")
        nb, D, ptrs = 0, 0, (offs.data_ptr(), None, None)
    else:
        _require("bmax", bmax, torch.int32, 2, dev)
        _require("lane", lane, torch.int32, 2, dev)
        nb = bmax.shape[1]
        if bmax.shape[0] != N or tuple(lane.shape) != tuple(bmax.shape) \
                or D is None or nb != -(-D // BLOCK):
            raise ValueError("bmax and lane must be (2B, ceil(D / 128))")
        ptrs = (None, bmax.data_ptr(), lane.data_ptr())
    B = N // 2
    out = torch.empty((8, B), dtype=torch.int32, device=dev)
    strand = torch.empty(B, dtype=torch.int8, device=dev)
    if B:
        _run("extend_fold_launch",
             (flat.data_ptr(), coord_off.data_ptr(), B, R, k,
              refp.data_ptr(), refp.shape[0], prepad, *ptrs, nb, D, match,
              mismatch, out.data_ptr(), strand.data_ptr()), dev)
        fold_launches += 1
    return {"score": out[0], "strand": strand, "read_start": out[1],
            "read_end": out[2], "matches": out[3], "length": out[4],
            "second_score": out[5], "ref_start": out[6], "ref_end": out[7]}


def seed_block_max(flat: torch.Tensor, seed: SeedPatch, stride: int = 1):
    """(2B, R) int8 oriented reads -> (bmax, lane), (2B, nb) int32.  CUDA
    tensors run the kernel, CPU tensors the plain version."""
    if flat.is_cuda:
        return seed_block_max_cuda(flat, seed, stride)
    return seed_block_max_plain(flat, seed.f32, stride)


def seed_block_topk(flat: torch.Tensor, seed: SeedPatch, stride: int,
                    k: int) -> torch.Tensor:
    """(2B, R) int8 oriented reads -> (2B, nb, min(k, 128)) int32, each
    128-diagonal block's k largest keys.  CUDA tensors run the kernel
    (1 <= k <= MAX_TOPK), CPU tensors the plain version (any k >= 1)."""
    if flat.is_cuda:
        return seed_block_topk_cuda(flat, seed, stride, k)
    if k < 1:
        raise ValueError(f"k = {k} below 1")
    return seed_block_topk_plain(flat, seed.f32, stride, min(k, BLOCK))


def extend_segments(flat: torch.Tensor, refp: torch.Tensor, prepad: int,
                    match: int, mismatch: int,
                    offs: Optional[torch.Tensor] = None,
                    rows: Optional[torch.Tensor] = None,
                    keys: Optional[torch.Tensor] = None,
                    D: Optional[int] = None,
                    k: Optional[int] = None) -> dict:
    """The Kadane segment of every candidate of (N, R) int8 reads, dict of
    (N, k) int32 score, start, end, matches, length: offsets ``offs``
    into ``refp`` with ``prepad`` PAD codes before position 0; with
    ``rows``, (row, col) candidates of the tiles ``refp``, ``prepad`` their
    halo; with ``keys``/``D``/``k``, the row's top min(k, D) diagonals of
    seed_block_topk's keys, their offsets returned as ``off``.  CUDA
    tensors run the kernel, CPU tensors the plain version."""
    if flat.shape[1] > prepad:
        # a clipped window must stay inside the PAD run (the tiles' halo)
        raise ValueError(f"read width {flat.shape[1]} exceeds the "
                         f"reference's prepad {prepad}")
    args = (flat, refp, prepad, match, mismatch)
    kw = dict(offs=offs, rows=rows, keys=keys, D=D, k=k)
    if flat.is_cuda:
        return extend_segments_cuda(*args, **kw)
    return extend_segments_plain(*args, **kw)


def extend_fold(flat: torch.Tensor, coord_off: torch.Tensor,
                refp: torch.Tensor, prepad: int, match: int, mismatch: int,
                k: int, offs: Optional[torch.Tensor] = None,
                bmax: Optional[torch.Tensor] = None,
                lane: Optional[torch.Tensor] = None,
                D: Optional[int] = None,
                rows: Optional[torch.Tensor] = None) -> dict:
    """Per-read records (score, strand, read_start, read_end, matches,
    length, second_score, ref_start, ref_end) of (2B, R) oriented reads:
    block mode with ``bmax``/``lane``/``D``, offsets mode with ``offs``;
    tile mode with ``rows`` and ``offs`` (the columns), ``refp`` the tiles
    and ``prepad`` their halo: the TILE_FIELDS records.  CUDA tensors run
    the kernel, CPU tensors the plain version."""
    if flat.shape[1] > prepad:
        # a clipped window must stay inside the PAD run (the tiles' halo)
        raise ValueError(f"read width {flat.shape[1]} exceeds the "
                         f"reference's prepad {prepad}")
    args = (flat, coord_off, refp, prepad, match, mismatch, k)
    kw = dict(offs=offs, bmax=bmax, lane=lane, D=D, rows=rows)
    if flat.is_cuda:
        return extend_fold_cuda(*args, **kw)
    return extend_fold_plain(*args, **kw)
