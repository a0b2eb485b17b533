"""Wrapper of the hand-written CUDA Smith-Waterman kernel (csrc/sw.cu).

Two entries of one kernel source:

- ``sw_align_fused``: the forward + reverse affine-gap SW that gapped
  refinement runs, validity ``code != PAD``; (5, B) int32.
- ``sw_end_device``: the forward pass alone with explicit validity masks,
  the contract of ops/sw.py::sw_end; (best, end_read, end_win) int32.

A tensor on the CPU goes to the plain version (ops/sw.py); a CUDA tensor
launches the kernel, which is built at first use with ``nvcc`` for sm_90a
from the package's own source into ``_build/`` beside the package, keyed by
a hash of the source, and bound with ctypes.  A failed build or launch
raises: there is no fallback.

Any read width up to ``MAX_W`` runs: pairs of more than ``STRIP_ROWS`` rows
are walked in strips, with a per-pair boundary row in scratch that the
wrapper allocates (csrc/sw.cu).
"""

from __future__ import annotations

import ctypes
import os
import re

import torch

from anchored_fusion_tpu_torch.ops import cuda_build
from anchored_fusion_tpu_torch.ops.sw import sw_align_fused_plain, sw_end

SOURCE = os.path.join(cuda_build.CSRC, "sw.cu")
MAX_W = 32768
# Rows one warp holds in registers (32 lanes x 32 rows); taller pairs run in
# strips of this height.
STRIP_ROWS = 1024
# H * 32 + 31 must fit an int32: match * min(R, W) stays below this.
KEY_BOUND = 1 << 26

_lib = None
# Kernel launches in this process, one count per entry; the plain versions
# never count.
launches = 0        # sw_align_fused_cuda
end_launches = 0    # sw_end_cuda

def build() -> str:
    """Compile csrc/sw.cu into a shared library (once per source hash); the
    compiler's per-kernel resource report is kept beside it."""
    return cuda_build.build(SOURCE, "sw")


def ptxas_usage() -> list[dict]:
    """Registers and spill bytes of each kernel instantiation, from the
    ptxas report of the build: [{"rpl", "masked", "strips", "registers",
    "spill_stores", "spill_loads"}]."""
    out = []
    for e in cuda_build.ptxas_report(SOURCE, "sw"):
        t = re.search(r"sw_kernelILi(\d+)ELb([01])ELb([01])E", e["entry"])
        if t:
            out.append({"rpl": int(t.group(1)), "masked": t.group(2) == "1",
                        "strips": t.group(3) == "1",
                        **{k: e[k] for k in ("registers", "spill_stores",
                                             "spill_loads")}})
    return sorted(out, key=lambda d: (d["masked"], d["strips"], d["rpl"]))


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sw_align_launch.restype = i32
        lib.sw_align_launch.argtypes = [ptr, ptr, *[i32] * 7, ptr, ptr, ptr]
        lib.sw_end_launch.restype = i32
        lib.sw_end_launch.argtypes = [ptr] * 4 + [i32] * 7 + [ptr] * 3
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtypes, shape=None) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")


def _check_inputs(reads, windows, match, gap_open, gap_extend,
                  masks=()) -> tuple[int, int, int]:
    """Validate the kernel's inputs; returns (B, R, W)."""
    _check("reads", reads, (torch.int8,))
    _check("windows", windows, (torch.int8,))
    B, R = reads.shape
    W = windows.shape[1]
    if windows.shape[0] != B:
        raise ValueError("reads and windows must share the batch size")
    for name, m, width in zip(("read_valid", "window_valid"), masks, (R, W)):
        _check(name, m, (torch.bool, torch.uint8), (B, width))
    for name, n in (("read", R), ("window", W)):
        if not 0 < n <= MAX_W:
            raise ValueError(f"{name} width {n} outside 1..{MAX_W}")
    if gap_open < 0 or gap_extend < 0:
        # the kernel's Gotoh F equals the plain prefix-max F only for
        # open + extend >= extend, and its lanes compute PAD columns outside
        # a pass, which must leave H = 0 (csrc/sw.cu)
        raise ValueError(f"gap_open {gap_open} and gap_extend {gap_extend} "
                         "must be >= 0")
    if match * min(R, W) >= KEY_BOUND:
        # the kernel keeps the best as the key H * 32 + (31 - row)
        raise ValueError(f"match {match} x min(R, W) {min(R, W)} >= 2^26 "
                         "is not supported")
    for name, t in (("reads", reads), ("windows", windows),
                    *zip(("read_valid", "window_valid"), masks)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.device != reads.device:
            raise ValueError(f"{name} is on {t.device}, reads on "
                             f"{reads.device}")
    return B, R, W


def _launch(fn, args, shape, out: torch.Tensor, device) -> None:
    """Launch ``fn`` on ``device``'s current stream; ``shape`` is (B, R, W).
    Pairs taller than one strip get the strips' boundary rows, (B, 2, W)
    int2, as scratch."""
    lib = _load()
    B, R, W = shape
    scratch = (torch.empty((B, 2, W, 2), dtype=torch.int32, device=device)
               if R > STRIP_ROWS else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(
            *args, None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn} failed: cudaError {err}")


def sw_align_fused_cuda(reads: torch.Tensor, windows: torch.Tensor,
                        match: int = 1, mismatch: int = 4, gap_open: int = 6,
                        gap_extend: int = 1) -> torch.Tensor:
    """Launch the fused kernel on the current stream; returns (5, B) int32."""
    global launches
    B, R, W = _check_inputs(reads, windows, match, gap_open, gap_extend)
    out = torch.empty((5, B), dtype=torch.int32, device=reads.device)
    if B == 0:
        return out
    _launch("sw_align_launch",
            (reads.data_ptr(), windows.data_ptr(), B, R, W, match, mismatch,
             gap_open, gap_extend), (B, R, W), out, reads.device)
    launches += 1
    return out


def sw_end_cuda(reads: torch.Tensor, windows: torch.Tensor,
                read_valid: torch.Tensor, window_valid: torch.Tensor,
                match: int = 1, mismatch: int = 4, gap_open: int = 6,
                gap_extend: int = 1):
    """Launch the forward-only kernel with validity masks (bool or uint8, the
    shapes of reads and windows); returns (best, end_read, end_win) int32."""
    global end_launches
    B, R, W = _check_inputs(reads, windows, match, gap_open, gap_extend,
                            (read_valid, window_valid))
    out = torch.empty((3, B), dtype=torch.int32, device=reads.device)
    if B:
        _launch("sw_end_launch",
                (reads.data_ptr(), windows.data_ptr(), read_valid.data_ptr(),
                 window_valid.data_ptr(), B, R, W, match, mismatch, gap_open,
                 gap_extend), (B, R, W), out, reads.device)
        end_launches += 1
    return out[0], out[1], out[2]


def sw_align_fused(reads: torch.Tensor, windows: torch.Tensor,
                   match: int = 1, mismatch: int = 4, gap_open: int = 6,
                   gap_extend: int = 1) -> torch.Tensor:
    """Forward + reverse SW, (5, B) int32 rows score, end_read, end_win,
    start_read, start_win.  CUDA tensors run the kernel, CPU tensors the
    plain version."""
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend)
    if reads.is_cuda:
        return sw_align_fused_cuda(reads, windows, **kw)
    return sw_align_fused_plain(reads, windows, **kw)


def sw_end_device(reads: torch.Tensor, windows: torch.Tensor,
                  read_valid: torch.Tensor, window_valid: torch.Tensor,
                  match: int = 1, mismatch: int = 4, gap_open: int = 6,
                  gap_extend: int = 1):
    """Forward SW with validity masks, (best, end_read, end_win) int32 per
    pair.  CUDA tensors run the kernel, CPU tensors ops/sw.py::sw_end."""
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend)
    if reads.is_cuda:
        return sw_end_cuda(reads, windows, read_valid, window_valid, **kw)
    return sw_end(reads, windows, read_valid, window_valid, **kw)
