"""Build the package's CUDA sources with nvcc at first use; load with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``csrc/_build/lib<name>-<hash>.so``, where the hash covers the source,
every ``csrc/*.cuh`` it includes (``#include "..."``, followed through
headers) and the flags, so an edited source or header is rebuilt and a
built one is reused.
Nothing here runs at import: the CPU tests import every module on machines
with no nvcc.
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
from typing import Dict, Iterable, List

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "load_library", "load_libraries",
           "build_log"]

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(src: Path) -> List[Path]:
    """``src`` and the local headers it includes, each once, in the order
    they are first reached."""
    seen: List[Path] = []
    todo = [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / inc.decode()).resolve()
            if not dep.exists():
                raise RuntimeError(f"{path.name} includes {inc.decode()}, which is missing")
            todo.append(dep)
    return seen


def _paths(name: str):
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256()
    for path in _sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    stem = BUILD_DIR / f"lib{name}-{digest}"
    return src, stem.with_suffix(".so"), stem.with_suffix(".log")


def load_libraries(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """The loaded shared libraries of ``csrc/<name>.cu`` for each name;
    those not built yet are compiled by one nvcc each, all started together."""
    names = list(names)
    with _lock:
        pending = []
        try:
            for name in names:
                if name in _libs:
                    continue
                src, so, log = _paths(name)
                if so.exists():
                    _libs[name] = ctypes.CDLL(str(so))
                    continue
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                with open(log, "w") as out:
                    proc = subprocess.Popen(
                        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                        stdout=out, stderr=subprocess.STDOUT,
                    )
                pending.append((name, src, so, log, tmp, proc))
            for name, src, so, log, tmp, proc in pending:
                if proc.wait() != 0:
                    raise RuntimeError(f"nvcc failed on {src.name}:\n{log.read_text()}")
                os.replace(tmp, so)
                _libs[name] = ctypes.CDLL(str(so))
        finally:
            for *_, tmp, proc in pending:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return {name: _libs[name] for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if missing."""
    return load_libraries([name])[name]


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` (ptxas register and
    shared-memory report), or '' when it was not built here."""
    _, _, log = _paths(name)
    return log.read_text() if log.exists() else ""
