"""Loader for the native sequence codec (``codec.c``).

Compiles ``codec.c`` at first use with the system C compiler
(``cc -O3 -shared -fPIC``) into ``anchored_fusion_tpu_torch/_build/``, keyed
by a hash of the source, and binds it with ctypes.  Only a machine without a
C compiler gets no library (``get_lib()`` is None) and the callers' Python
parsing; a compiler that fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "codec.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
COMPILERS = ("cc", "gcc", "clang")
_lib = None
_tried = False


def build() -> Optional[str]:
    """Path of the compiled codec, building it if needed; None when no C
    compiler is installed."""
    with open(_SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"codec_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    for cc in COMPILERS:
        cmd = [cc, "-O3", "-shared", "-fPIC", _SRC, "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError:
            continue
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
        return so
    return None


def get_lib():
    """The loaded codec library, or None on a machine without a C
    compiler."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    so = build()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.aft_encode_dna.restype = ctypes.c_long
    lib.aft_encode_dna.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p]
    lib.aft_decode_fastq.restype = ctypes.c_long
    lib.aft_decode_fastq.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    lib.aft_fastq_max_len.restype = ctypes.c_long
    lib.aft_fastq_max_len.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.aft_fastq_count.restype = ctypes.c_long
    lib.aft_fastq_count.argtypes = [ctypes.c_char_p, ctypes.c_long]
    _lib = lib
    return _lib


def decode_fastq_native(data: bytes, max_len: Optional[int] = None
                        ) -> Optional[Tuple[list, np.ndarray, np.ndarray]]:
    """(names, seq (N, L) int8 PAD-padded, lengths (N,)); None without the
    library or on a malformed buffer."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(lib.aft_fastq_count(data, len(data)))
    if n == 0:
        return [], np.zeros((0, max_len or 8), np.int8), np.zeros(0, np.int32)
    if max_len is None:
        longest = int(lib.aft_fastq_max_len(data, len(data)))
        max_len = max(8, -(-longest // 128) * 128)
    seq = np.full((n, max_len), 5, np.int8)
    lens = np.zeros(n, np.int32)
    name_off = np.zeros(n, np.int64)
    name_len = np.zeros(n, np.int32)
    got = int(lib.aft_decode_fastq(
        data, len(data), seq.ctypes.data_as(ctypes.c_void_p), max_len,
        lens.ctypes.data_as(ctypes.c_void_p),
        name_off.ctypes.data_as(ctypes.c_void_p),
        name_len.ctypes.data_as(ctypes.c_void_p), n))
    if got < 0:
        return None
    names = []
    for i in range(got):
        nm = data[name_off[i]: name_off[i] + name_len[i]].decode()
        if nm.endswith("/1") or nm.endswith("/2"):
            nm = nm[:-2]
        names.append(nm)
    return names, seq[:got], lens[:got]


def encode_dna_native(data: bytes) -> Optional[np.ndarray]:
    """(len(data),) int8 codes of a raw DNA byte string (A/C/G/T in either
    case; anything else N); None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(len(data), np.int8)
    lib.aft_encode_dna(data, len(data), out.ctypes.data_as(ctypes.c_void_p))
    return out
