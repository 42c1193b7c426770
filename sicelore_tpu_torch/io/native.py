"""ctypes bindings for the native C++ runtime components (native/).

Auto-builds native/build/libbgzf.so with `make -C native` on first use when
a toolchain is available; all callers gracefully fall back to the pure-
Python paths when the library is missing (pybind11 is not available in this
image — ctypes over a C ABI instead).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libbgzf.so"
_lib = None
_tried = False


def _build() -> bool:
    try:
        r = subprocess.run(["make", "-C", str(_NATIVE_DIR)],
                           capture_output=True, timeout=120)
        return r.returncode == 0 and _LIB_PATH.exists()
    except Exception:
        return False


_HOSTENC_PATH = _NATIVE_DIR / "build" / "sicelore_hostenc.so"
_hostenc = None
_hostenc_tried = False


def get_hostenc():
    """The native host-encode extension module (native/hostenc) or None.

    A CPython extension (not ctypes): it receives the fastq chunk's
    list[bytes] directly and fills the fixed-shape composite/code matrices
    with multithreaded memcpy — the per-read Python slicing it replaces was
    the largest host term of the scan budget."""
    global _hostenc, _hostenc_tried
    if _hostenc is not None or _hostenc_tried:
        return _hostenc
    _hostenc_tried = True
    if not _HOSTENC_PATH.exists() and not _build():
        return None
    try:
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "sicelore_hostenc", str(_HOSTENC_PATH))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _hostenc = mod
    except Exception:
        return None
    return _hostenc


def get_lib():
    """The loaded library or None (after one build attempt)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.bgzf_max_compressed_size.restype = ctypes.c_int64
    lib.bgzf_max_compressed_size.argtypes = [ctypes.c_int64]
    lib.bgzf_compress.restype = ctypes.c_int64
    lib.bgzf_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
    lib.bgzf_decompress.restype = ctypes.c_int64
    lib.bgzf_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p]
    _lib = lib
    return _lib


def default_threads() -> int:
    return min(os.cpu_count() or 1, 16)


def bgzf_compress(data: bytes, level: int = 6, nthreads: int | None = None,
                  add_eof: bool = False) -> bytes | None:
    """Parallel BGZF-compress `data`; None if the native lib is missing."""
    lib = get_lib()
    if lib is None:
        return None
    nthreads = nthreads or default_threads()
    cap = lib.bgzf_max_compressed_size(len(data))
    out = np.empty(cap, dtype=np.uint8)
    n = lib.bgzf_compress(data, len(data), level, nthreads,
                          1 if add_eof else 0,
                          out.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def bgzf_decompress(data: bytes, nthreads: int | None = None,
                    want_offsets: bool = False):
    """Parallel BGZF-decompress a full stream.

    Returns bytes, or (bytes, coffsets, uoffsets) with want_offsets;
    None if the native lib is missing or the stream is invalid."""
    lib = get_lib()
    if lib is None:
        return None
    nthreads = nthreads or default_threads()
    # worst case: 65280 payload per 28-byte (empty) block is unknowable
    # upfront; start at 8x and grow on -2
    cap = max(len(data) * 8, 1 << 20)
    max_blocks = len(data) // 28 + 2
    coff = np.empty(max_blocks, dtype=np.int64)
    uoff = np.empty(max_blocks, dtype=np.int64)
    nblk = ctypes.c_int64(0)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.bgzf_decompress(
            data, len(data), nthreads,
            out.ctypes.data_as(ctypes.c_void_p), cap,
            coff.ctypes.data_as(ctypes.c_void_p),
            uoff.ctypes.data_as(ctypes.c_void_p), max_blocks,
            ctypes.byref(nblk))
        if n == -2:
            cap *= 4
            continue
        if n < 0:
            return None
        payload = out[:n].tobytes()
        if want_offsets:
            k = nblk.value
            return payload, coff[:k].copy(), uoff[:k].copy()
        return payload
