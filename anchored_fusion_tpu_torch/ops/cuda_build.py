"""Build a CUDA source of the package into a shared library with a plain C
interface, for ctypes.

Each source is compiled with ``nvcc`` for sm_90a at first use into
``_build/`` beside the package, once per hash of its text; the compiler's
per-kernel resource report (``-Xptxas -v``) is kept beside the library.  A
failed build raises: there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import re
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def paths(source: str, name: str) -> tuple[str, str]:
    """(library, ptxas report) of ``source`` under the name ``name``."""
    with open(source, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"{name}_{tag}.so")
    return so, so[:-3] + ".ptxas.txt"


def build(source: str, name: str) -> str:
    """Compile ``source`` (once per source hash); returns the library."""
    so, log = paths(source, name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    with open(log, "w") as fh:
        fh.write(proc.stderr)
    os.replace(tmp, so)
    return so


def ptxas_report(source: str, name: str) -> list[dict]:
    """Each kernel entry of ``source``'s build (compiled first if need
    be), from its ptxas report: {"entry" (the mangled name), "registers",
    "smem_bytes", "spill_stores", "spill_loads"}."""
    build(source, name)
    with open(paths(source, name)[1]) as fh:
        text = fh.read()
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"entry": m.group(1)}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m:
            cur["registers"] = int(m.group(1))
            cur["smem_bytes"] = int(m.group(2) or 0)
            out.append(cur)
            cur = None
    return out
