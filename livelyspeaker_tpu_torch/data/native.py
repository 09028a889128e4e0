"""ctypes bindings for the native record gather.

Port of ``livelyspeaker_tpu/data/native.py`` over the port's own copy of the
source, ``livelyspeaker_tpu_torch/native/record_gather.cc``: a batch's rows
are copied out of the memory-mapped shard arrays by ``memcpy`` (optionally
over threads), with the window crop and the [T, C] -> [C, T] motion
transpose fused into the same pass.

The library is built at first use with ``g++ -O3 -shared -fPIC -std=c++17
-pthread`` into ``livelyspeaker_tpu_torch/csrc/_build/`` (gitignored) as
``librecord_gather-<hash>.so``, the hash covering the source and the flags,
so that an edited source is rebuilt and a built one is reused; a failed
build leaves the compiler's output beside it (``librecord_gather-<hash>.log``,
:func:`build_log`).

The numpy fallback (the JAX package's own) gives the same bytes and runs

- for every call, when the library is not loaded: ``g++`` is missing, or
  the build or the load failed (:func:`available` is then False; a caller
  that must not take the fallback checks it and refuses);
- for one call, when its source array is not C-contiguous (the C loops
  read rows at ``index * row_bytes``).

Every function writes into a fresh numpy buffer, never into one the caller
passes, so a pinned host slot that a copy may still be reading is never a
destination.
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

import numpy as np

__all__ = ["SOURCE", "GXX_FLAGS", "get_lib", "available", "build_log", "gather_rows",
           "gather_rows_prefix", "gather_rows_transpose", "gather_rows_transpose_crop"]

SOURCE = Path(__file__).resolve().parent.parent / "native" / "record_gather.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "csrc" / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _paths():
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    stem = BUILD_DIR / f"librecord_gather-{h.hexdigest()[:16]}"
    return stem.with_suffix(".so"), stem.with_suffix(".log")


def _build(so: Path, log: Path) -> bool:
    """Compile the source into ``so`` (through a temporary file, so that a
    half-written library is never loaded); False, with the compiler's
    output in ``log``, where g++ is missing or fails."""
    gxx = shutil.which("g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if gxx is None:
        log.write_text("g++ not found on PATH\n")
        return False
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        with open(log, "w") as out:
            rc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", tmp], stdout=out,
                                stderr=subprocess.STDOUT, timeout=120).returncode
        if rc == 0:
            os.replace(tmp, so)
        return rc == 0
    except (OSError, subprocess.SubprocessError) as e:
        with open(log, "a") as out:
            out.write(f"{type(e).__name__}: {e}\n")
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None where it cannot be
    built or loaded (then every function takes its numpy fallback)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so, log = _paths()
        if not so.exists() and not _build(so, log):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        for name, args in (("gather_rows_bytes", [ptr, ptr, i64, i64, ptr, ctypes.c_int]),
                           ("gather_rows_transpose_f32", [ptr, ptr, i64, i64, i64, ptr]),
                           ("gather_rows_prefix_bytes", [ptr, ptr, i64, i64, i64, ptr,
                                                         ctypes.c_int]),
                           ("gather_rows_transpose_crop_f32", [ptr, ptr, i64, i64, i64, i64,
                                                               ptr])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is loaded (built here if need be)."""
    return get_lib() is not None


def build_log() -> str:
    """g++'s output for the current source's build, or '' when it was not
    built here."""
    _, log = _paths()
    return log.read_text() if log.exists() else ""


def _rows(src: np.ndarray, indices, n_first: Optional[int] = None) -> np.ndarray:
    """``indices`` as contiguous int64, each a row of ``src`` (the C loops
    read ``src`` at ``index * row_bytes`` unchecked), and ``n_first`` within
    a row: IndexError or ValueError otherwise, on either path."""
    idx = np.ascontiguousarray(indices, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"indices must be 1-D, got shape {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(f"row indices must lie in [0, {len(src)}), got "
                         f"[{idx.min()}, {idx.max()}]")
    if n_first is not None and not 0 <= n_first <= src.shape[1]:
        raise ValueError(f"a prefix of {n_first} of rows of {src.shape[1]}")
    return idx


def _native(src: np.ndarray) -> Optional[ctypes.CDLL]:
    """The library for a gather from ``src``, or None for the fallback."""
    lib = get_lib()
    return lib if lib is not None and src.flags["C_CONTIGUOUS"] else None


def gather_rows(src: np.ndarray, indices: np.ndarray, n_threads: int = 1) -> np.ndarray:
    """src[indices] as one contiguous batch buffer."""
    indices = _rows(src, indices)
    lib = _native(src)
    if lib is None:
        return np.ascontiguousarray(src[indices])
    row_shape = src.shape[1:]
    out = np.empty((len(indices),) + row_shape, dtype=src.dtype)
    row_bytes = int(np.prod(row_shape, dtype=np.int64)) * src.dtype.itemsize
    lib.gather_rows_bytes(src.ctypes.data, indices.ctypes.data, len(indices), row_bytes,
                          out.ctypes.data, n_threads)
    return out


def _check_f32_rows(src: np.ndarray, what: str) -> None:
    if src.ndim != 3 or src.dtype != np.float32:
        raise ValueError(f"{what} needs f32 [N, T, C] rows, not {src.dtype} {src.shape}")


def gather_rows_transpose(src: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """src[indices] with each [T, C] row transposed to [C, T]."""
    _check_f32_rows(src, "gather_rows_transpose")
    indices = _rows(src, indices)
    lib = _native(src)
    if lib is None:
        return np.ascontiguousarray(src[indices].transpose(0, 2, 1))
    n, t, c = len(indices), src.shape[1], src.shape[2]
    out = np.empty((n, c, t), np.float32)
    lib.gather_rows_transpose_f32(src.ctypes.data, indices.ctypes.data, n, t, c,
                                  out.ctypes.data)
    return out


def gather_rows_prefix(src: np.ndarray, indices: np.ndarray, n_first: int,
                       n_threads: int = 1) -> np.ndarray:
    """src[indices, :n_first] as one contiguous buffer: the window or audio
    crop fused into the gather (one memcpy a row)."""
    indices = _rows(src, indices, n_first)
    lib = _native(src)
    if lib is None:
        return np.ascontiguousarray(src[indices, :n_first])
    tail = src.shape[2:]
    out = np.empty((len(indices), n_first) + tail, dtype=src.dtype)
    tail_elems = int(np.prod(tail, dtype=np.int64)) if tail else 1
    item = src.dtype.itemsize
    lib.gather_rows_prefix_bytes(src.ctypes.data, indices.ctypes.data, len(indices),
                                 src.shape[1] * tail_elems * item,
                                 n_first * tail_elems * item, out.ctypes.data, n_threads)
    return out


def gather_rows_transpose_crop(src: np.ndarray, indices: np.ndarray, t_out: int) -> np.ndarray:
    """src[indices, :t_out] with each [T, C] row transposed to [C, t_out]:
    gather, frame crop and the channels-major transpose in one pass (the
    motion layout the denoiser consumes)."""
    _check_f32_rows(src, "transpose_crop")
    indices = _rows(src, indices, t_out)
    lib = _native(src)
    if lib is None:
        return np.ascontiguousarray(src[indices, :t_out].transpose(0, 2, 1))
    n, t, c = len(indices), src.shape[1], src.shape[2]
    out = np.empty((n, c, t_out), np.float32)
    lib.gather_rows_transpose_crop_f32(src.ctypes.data, indices.ctypes.data, n, t, t_out, c,
                                       out.ctypes.data)
    return out
