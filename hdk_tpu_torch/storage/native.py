"""Loader for the native (C++) core module.

Builds ``native/strdict.cpp`` at the repository root (outside both
packages, the same source ``hdk_tpu`` builds) into an importable
extension on first use
(g++ directly — no pybind11 dependency; see native/strdict.cpp for the
API).  Falls back silently: callers must treat ``load_native() is None``
as "pure-Python mode".
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from typing import Optional

_lock = threading.Lock()
_cached = None
_tried = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "strdict.cpp")


def _build_dir() -> str:
    return os.path.join(os.path.dirname(_SRC), "_build")


def load_native():
    """The hdk_tpu_native module, building it if necessary; None if the
    toolchain or source is unavailable."""
    global _cached, _tried
    with _lock:
        if _tried:
            return _cached
        _tried = True
        try:
            _cached = _load_or_build()
        except Exception:
            _cached = None
        return _cached


def _load_or_build():
    if not os.path.exists(_SRC):
        return None
    so_path = os.path.join(
        _build_dir(), "hdk_tpu_native" + (sysconfig.get_config_var("EXT_SUFFIX")
                                          or ".so"))
    if not (os.path.exists(so_path)
            and os.path.getmtime(so_path) >= os.path.getmtime(_SRC)):
        os.makedirs(_build_dir(), exist_ok=True)
        include = sysconfig.get_paths()["include"]
        cmd = [
            "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
            f"-I{include}", _SRC, "-o", so_path,
        ]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    spec = importlib.util.spec_from_file_location("hdk_tpu_native", so_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # type: ignore[union-attr]
    return mod
