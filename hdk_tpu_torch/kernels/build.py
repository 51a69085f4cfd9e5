"""Build and load the hand-written CUDA kernels of ``hdk_tpu_torch/csrc``.

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds).  The library lands in ``hdk_tpu_torch/_build/``, named by a hash
of the sources and flags, so an edited source rebuilds at first use and an
unchanged one loads from disk.  Nothing is built at import time.

    python -m hdk_tpu_torch.kernels.build [NAME_PART]

compiles the sources once more with ``-Xptxas -v`` and prints, for each
kernel whose mangled name contains NAME_PART, what ptxas reports
(registers, spills) and the atomic instructions of its SASS
(``cuobjdump -sass``): a native ``ATOMS``/``RED`` add, or a
compare-and-swap loop.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("hist.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int64
# C entry points of csrc/hist.cu: (gid, [vals,] n_rows, [n_slots,]
# n_entries, out, use_shared or mode, stream) -> cudaError_t; K1's vals
# is a host array of column pointers
_SIGNATURES = {
    "hdk_count_hist": [_P, _I, _I, _P, ctypes.c_int, _P],
    **{f"hdk_{name}": [_P, _P, _I, _I, _I, _P, ctypes.c_int, _P]
       for name in ("groupby_sums2_u8", "seg_sums_exact_i8",
                    "seg_sums_exact_i16", "seg_sums_exact_i32",
                    "seg_sums_exact_i64")},
    **{f"hdk_groupby_sums_cols_{sfx}":
       [_P, ctypes.POINTER(_P), _I, _I, _I, _P, ctypes.c_int, _P]
       for sfx in ("f32", "f64")},
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"hdk_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; returns its
    path.  Raises ``subprocess.CalledProcessError`` with nvcc's output on
    a failed build."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               *[str(SRC_DIR / s) for s in SOURCES]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(
                proc.returncode, cmd, proc.stdout, proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def library() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes set on every
    entry point (ctypes would otherwise pass pointers as 32-bit ints)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def report(pattern: str = "") -> str:
    """ptxas's resource lines and the SASS atomics of every kernel whose
    mangled name contains ``pattern``; builds into a temporary file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, "report.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
               *[str(SRC_DIR / s) for s in SOURCES]]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
        lines = []
        current = None
        for line in proc.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = m.group(1)
            if current and pattern in current and (
                    "registers" in line or "spill" in line
                    or "Compiling entry" in line):
                lines.append(line.strip())
        cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                              text=True, check=True).stdout
    func = None
    counts: dict = {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            continue
        if func is None or pattern not in func:
            continue
        for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG)\.[A-Z0-9.]+)",
                             line):
            key = (func, op)
            counts[key] = counts.get(key, 0) + 1
    lines.append("SASS atomics (function, opcode, count):")
    lines += [f"  {f} {op} {n}" for (f, op), n in sorted(counts.items())]
    return "\n".join(lines)


if __name__ == "__main__":
    import sys

    print(report(sys.argv[1] if len(sys.argv) > 1 else ""))
