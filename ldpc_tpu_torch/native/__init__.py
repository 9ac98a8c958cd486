"""Native host engine: the C++ min-sum decoder (``minsum.cpp``), bound with
ctypes.

The port's own copy of ``ldpc_tpu.native``.  The source is compiled with
``g++`` at first use into ``ldpc_tpu_torch/_build/libldpc_native-<hash>.so``
(the hash covers the source and the flags, so an edited source is always
rebuilt and an unchanged one never), never next to the sources.
``available()`` reports whether it builds and loads (False without ``g++``)
instead of raising, so callers and tests can skip it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

__all__ = ["available", "native_min_sum_decode", "build"]

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "minsum.cpp"
_BUILD_DIR = _DIR.parent / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_LIB = None
_BUILD_ERROR: str | None = None


def build() -> pathlib.Path:
    """Compile minsum.cpp into the build directory (cached by hash)."""
    digest = hashlib.sha256(_SRC.read_bytes() +
                            " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"libldpc_native-{digest}.so"
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run([gxx, *_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, so)       # atomic: a concurrent build never sees half
    return so


def _lib():
    global _LIB, _BUILD_ERROR
    if _LIB is not None:
        return _LIB
    if _BUILD_ERROR is not None:
        raise RuntimeError(f"native build failed earlier: {_BUILD_ERROR}")
    try:
        lib = ctypes.CDLL(str(build()))
    except Exception as e:  # toolchain missing / compile error
        _BUILD_ERROR = str(e)
        raise RuntimeError(f"cannot build native library: {e}") from e
    lib.ldpc_min_sum_decode_batch.restype = None
    lib.ldpc_min_sum_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    _LIB = lib
    return lib


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        _lib()
        return True
    except Exception:  # noqa: BLE001 — any failure means "not available"
        return False


def _csr(h: np.ndarray):
    m, _ = h.shape
    row_ptr = np.zeros(m + 1, np.int32)
    cols = []
    for r in range(m):
        idx = np.flatnonzero(h[r])
        cols.append(idx.astype(np.int32))
        row_ptr[r + 1] = row_ptr[r] + idx.size
    return row_ptr, np.concatenate(cols) if cols else np.zeros(0, np.int32)


def native_min_sum_decode(h: np.ndarray, channel: np.ndarray,
                          max_iters: int = 50):
    """Batch decode with the native engine.

    Same contract as ``ops.oracle.dense_min_sum_decode`` but batched:
    channel [B, n] (or [n]); returns (hard [B, n] int64, soft [B, n]
    float64, iterations [B] int32, success [B] bool).
    """
    lib = _lib()
    h = np.ascontiguousarray(h)
    channel = np.atleast_2d(np.ascontiguousarray(channel, np.float64))
    b, n = channel.shape
    m = h.shape[0]
    row_ptr, col_idx = _csr(h)
    hard = np.zeros((b, n), np.int64)
    soft = np.zeros((b, n), np.float64)
    iters = np.zeros(b, np.int32)
    ok = np.zeros(b, np.int32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.ldpc_min_sum_decode_batch(
        p(channel, ctypes.c_double), b, n, m, p(row_ptr, ctypes.c_int32),
        p(col_idx, ctypes.c_int32), max_iters, p(hard, ctypes.c_int64),
        p(soft, ctypes.c_double), p(iters, ctypes.c_int32),
        p(ok, ctypes.c_int32))
    return hard, soft, iters, ok.astype(bool)
