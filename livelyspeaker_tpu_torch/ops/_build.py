"""Build the package's CUDA sources with nvcc at first use; load with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``csrc/_build/lib<name>-<hash>.so``, where the hash covers the source
and the flags, so an edited source is rebuilt and a built one is reused.
Nothing here runs at import: the CPU tests import every module on machines
with no nvcc.
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
from typing import Dict

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "load_library", "build_log"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _paths(name: str):
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    stem = BUILD_DIR / f"lib{name}-{digest}"
    return src, stem.with_suffix(".so"), stem.with_suffix(".log")


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if missing."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src, so, log = _paths(name)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                    capture_output=True, text=True,
                )
                log.write_text(proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}"
                    )
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        _libs[name] = ctypes.CDLL(str(so))
        return _libs[name]


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` (ptxas register and
    shared-memory report), or '' when it was not built here."""
    _, _, log = _paths(name)
    return log.read_text() if log.exists() else ""
