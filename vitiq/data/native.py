"""Native (C) ingestion kernels: build-on-demand ctypes bindings.

The reference has no native tier at all (SURVEY.md §2: 100% Python); the
hot host path — gathering frame rows out of packed mmap shards — is pure
memcpy, where numpy's fancy-index iterator leaves a few per cent on the
table. The kernel is compiled once with the
system gcc into <repo>/build/native and loaded via ctypes (no pybind11 in
this image); ANY failure — no compiler, read-only cache, exotic platform —
degrades silently to the numpy path, so the framework never *requires* the
toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).parent / "_native" / "gather.c"
_DEFAULT_CACHE = Path(__file__).resolve().parents[2] / "build" / "native"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("VITIQ_NO_NATIVE") == "1":
        return None
    try:
        src = _SRC.read_text()
        tag = hashlib.sha256(src.encode()).hexdigest()[:16]
        cache = Path(os.environ.get("VITIQ_NATIVE_CACHE", _DEFAULT_CACHE))
        cache.mkdir(parents=True, exist_ok=True)
        so = cache / f"gather-{tag}.so"
        if not so.exists():
            tmp = so.with_suffix(".so.tmp")
            subprocess.run(
                ["gcc", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                check=True, capture_output=True, timeout=60)
            tmp.replace(so)  # atomic: concurrent builders race benignly
        lib = ctypes.CDLL(str(so))
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gather_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, i64p,
            ctypes.c_int64, ctypes.c_int64]
        lib.gather_scatter_rows.argtypes = [
            ctypes.c_char_p, i64p, ctypes.c_char_p, i64p,
            ctypes.c_int64, ctypes.c_int64]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_char_p)


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def gather_rows(dst: np.ndarray, src: np.ndarray, rows: np.ndarray) -> bool:
    """dst[:len(rows)] = src[rows] via the native kernel.

    Requires C-contiguous dst/src with identical row shape/dtype. Returns
    False (no copy performed) when the native path is unavailable or the
    layout doesn't qualify — caller must fall back to numpy."""
    lib = _load()
    if (lib is None or not dst.flags.c_contiguous
            or not src.flags.c_contiguous
            or dst.dtype != src.dtype or dst.shape[1:] != src.shape[1:]):
        return False
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    row_bytes = int(np.prod(src.shape[1:])) * src.dtype.itemsize
    lib.gather_rows(_ptr(dst), _ptr(src), _i64(rows),
                    len(rows), row_bytes)
    return True


def gather_scatter_rows(dst: np.ndarray, dst_rows: np.ndarray,
                        src: np.ndarray, src_rows: np.ndarray) -> bool:
    """dst[dst_rows] = src[src_rows] via the native kernel (scattered
    destination rows — the multi-shard read_rows fill). Returns False when
    unavailable; caller falls back to numpy."""
    lib = _load()
    if (lib is None or not dst.flags.c_contiguous
            or not src.flags.c_contiguous
            or dst.dtype != src.dtype or dst.shape[1:] != src.shape[1:]):
        return False
    dst_rows = np.ascontiguousarray(dst_rows, dtype=np.int64)
    src_rows = np.ascontiguousarray(src_rows, dtype=np.int64)
    row_bytes = int(np.prod(src.shape[1:])) * src.dtype.itemsize
    lib.gather_scatter_rows(_ptr(dst), _i64(dst_rows), _ptr(src),
                            _i64(src_rows), len(dst_rows), row_bytes)
    return True
