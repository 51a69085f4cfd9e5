"""Build and load the hand-written CUDA kernels of ``hdk_tpu_torch/csrc``.

Each source compiles once for each part of its entry points (``nvcc
-DHDK_PART=k``: a part instantiates only its own kernels), every part
with its own ``nvcc``, all started together, and the objects link into
one shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers: a build takes seconds).  The library lands
in ``hdk_tpu_torch/_build/``, named by a hash of the sources and flags, so
an edited source rebuilds at first use and an unchanged one loads from
disk.  Nothing is built at import time.

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
# each source and the number of parts its entry points are split into:
# hist.cu f32 | f64; int_hist.cu counts | bool | int8 | int16 | int32 |
# int64 (a part of 48 kernels builds in about a fifth of the time of all);
# pair_sort.cu one part (three kernels)
SOURCES = {"hist.cu": 2, "int_hist.cu": 6, "pair_sort.cu": 1}
HEADERS = ("dense_gid.cuh",)  # included by the sources
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int64
_COLS = ctypes.POINTER(_P)  # a host array of column pointers
_KEYS_MAX = 4


class DenseKeysC(ctypes.Structure):
    """``csrc/dense_gid.cuh::DenseKeys``, field for field (all 8 bytes, so
    neither side pads): the raw key columns a launch derives its group
    ids from, in place of a gid array."""

    _fields_ = [("key", _P * _KEYS_MAX), ("valid", _P * _KEYS_MAX),
                ("row_mask", _P), ("width", _I * _KEYS_MAX),
                ("min", _I * _KEYS_MAX), ("size", _I * _KEYS_MAX),
                ("stride", _I * _KEYS_MAX), ("n_keys", _I),
                ("n_entries", _I)]


_KEYS = ctypes.POINTER(DenseKeysC)  # null: the ids come from gid
# C entry points -> cudaError_t.  csrc/hist.cu (K1): (gid, column pointers,
# n_rows, n_slots, n_entries, out, mode, keys, stream); csrc/int_hist.cu
# (K2-K4): (gid, [column pointers,] n_rows, [n_slots,] e_lo, n_entries,
# [out_stride,] out, mode, keys, stream) over the entries e_lo .. e_lo +
# n_entries of gid; csrc/pair_sort.cu: (vals, gid, valid, n_rows, n_groups,
# max_count, starts, counts, cursor, work, out, stream)
_INT_COLS = [_P, _COLS, _I, _I, _I, _I, _I, _P, ctypes.c_int, _KEYS, _P]
_SIGNATURES = {
    **{f"hdk_groupby_sums_cols_{sfx}":
       [_P, _COLS, _I, _I, _I, _P, ctypes.c_int, _KEYS, _P]
       for sfx in ("f32", "f64")},
    "hdk_count_hist": [_P, _I, _I, _I, _P, ctypes.c_int, _KEYS, _P],
    **{f"hdk_seg_sums_exact_{sfx}": _INT_COLS
       for sfx in ("i8", "i16", "i32", "i64")},
    "hdk_groupby_sums2_b8": _INT_COLS,
    "hdk_pair_sort": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
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
    for name in (*SOURCES, *HEADERS):
        h.update((SRC_DIR / name).read_bytes())
    h.update(repr(SOURCES).encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"hdk_kernels_{h.hexdigest()[:16]}.so"


class BuildError(subprocess.CalledProcessError):
    """A failed nvcc or link step; its message carries the tool's output."""

    def __str__(self) -> str:
        return f"{super().__str__()}\n{self.stdout or ''}{self.stderr or ''}"


def _run(cmd) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise BuildError(proc.returncode, cmd, proc.stdout, proc.stderr)
    return proc


def _compile(out_dir: str, extra=()) -> list:
    """One ``nvcc -c`` a part of a source, all at once; returns (object
    path, nvcc's stderr) per part in SOURCES order."""
    procs = []
    for name, part in [(n, k) for n, parts in SOURCES.items()
                       for k in range(parts)]:
        obj = os.path.join(out_dir, f"{name}.{part}.o")
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, f"-DHDK_PART={part}", "-c",
               "-o", obj, str(SRC_DIR / name)]
        procs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    done = []
    for obj, cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            for _, _, other in procs:
                other.kill()
                other.wait()
            raise BuildError(proc.returncode, cmd, out, err)
        done.append((obj, err))
    return done


def build() -> Path:
    """Compile the sources unless a library for them exists; returns its
    path.  Raises ``BuildError`` (a ``subprocess.CalledProcessError``)
    with nvcc's output on a failed build."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [obj for obj, _ in _compile(tmp)]
        out = os.path.join(tmp, "lib.so")
        _run([nvcc_path(), "-shared", "-o", out, *objs])
        os.replace(out, so)
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
    lines = []
    sass = ""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
        for obj, err in _compile(tmp, ("-Xptxas", "-v")):
            current = None
            for line in err.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    current = m.group(1)
                if current and pattern in current and (
                        "registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    lines.append(line.strip())
            sass += _run([cuobjdump, "-sass", obj]).stdout
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
