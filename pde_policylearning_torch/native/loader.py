"""ctypes wrapper for the parallel .npy batch loader (fastloader.c).

Compiles the shared library on first use (cached next to this file, rebuilt
if the source is newer); falls back to a numpy loop if the toolchain or a
header mismatch makes the native path unusable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastloader.c")
_LIB = os.path.join(_HERE, "libfastloader.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _ensure_built() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if (not os.path.exists(_LIB)
                    or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
                subprocess.run(
                    ["cc", "-O2", "-shared", "-fPIC", "-pthread", _SRC,
                     "-o", _LIB],
                    check=True, capture_output=True)
            lib = ctypes.CDLL(_LIB)
            lib.load_npy_batch.restype = ctypes.c_int64
            lib.load_npy_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
                ctypes.c_int]
            _lib = lib
        except Exception:
            _build_failed = True
    return _lib


def native_available() -> bool:
    return _ensure_built() is not None


def _npy_header(path: str):
    """Parse a v1/v2 .npy header; returns (dtype, shape, data_offset)."""
    with open(path, "rb") as f:
        magic = f.read(6)
        if magic != b"\x93NUMPY":
            raise ValueError(f"{path} is not a .npy file")
        major, _minor = f.read(1)[0], f.read(1)[0]
        if major == 1:
            hlen = int.from_bytes(f.read(2), "little")
            offset = 10 + hlen
        else:
            hlen = int.from_bytes(f.read(4), "little")
            offset = 12 + hlen
        header = eval(f.read(hlen).decode("latin1"),
                      {"__builtins__": {}}, {"False": False, "True": True})
    if header.get("fortran_order"):
        raise ValueError("fortran_order .npy not supported by fast loader")
    return np.dtype(header["descr"]), tuple(header["shape"]), offset


def load_npy_batch(paths: Sequence[str], n_threads: int = 16) -> np.ndarray:
    """Load N homogeneous .npy files into one (N, *shape) array, reading
    payloads in parallel with the native loader when available."""
    paths = list(paths)
    if not paths:
        return np.zeros((0,))
    dtype, shape, offset = _npy_header(paths[0])
    nbytes = int(np.prod(shape)) * dtype.itemsize
    lib = _ensure_built()
    if lib is None:
        return np.stack([np.load(p) for p in paths])
    # homogeneity check on a second file (cheap; full safety net below)
    if len(paths) > 1:
        d2, s2, o2 = _npy_header(paths[-1])
        if (d2, s2, o2) != (dtype, shape, offset):
            return np.stack([np.load(p) for p in paths])
    out = np.empty((len(paths), *shape), dtype)
    arr = (ctypes.c_char_p * len(paths))(
        *[p.encode() for p in paths])
    errors = lib.load_npy_batch(
        arr, len(paths), offset, nbytes,
        out.ctypes.data_as(ctypes.c_char_p), int(n_threads))
    if errors:
        return np.stack([np.load(p) for p in paths])
    return out
