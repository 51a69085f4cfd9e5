"""Build and load the hand-written CUDA kernels of ``hdk_tpu_torch/csrc``.

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds).  The library lands in ``hdk_tpu_torch/_build/``, named by a hash
of the sources and flags, so an edited source rebuilds at first use and an
unchanged one loads from disk.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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
# n_entries, out, use_shared, stream) -> cudaError_t
_SIGNATURES = {
    "hdk_count_hist": [_P, _I, _I, _P, ctypes.c_int, _P],
    **{f"hdk_{name}": [_P, _P, _I, _I, _I, _P, ctypes.c_int, _P]
       for name in ("groupby_sums2_u8", "seg_sums_exact_i8",
                    "seg_sums_exact_i16", "seg_sums_exact_i32",
                    "seg_sums_exact_i64", "groupby_sums_f32",
                    "groupby_sums_f64")},
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
