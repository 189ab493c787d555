"""Native host runtime (C++ via ctypes).

Builds lazily with g++ on first import; callers fall back to the pure-
Python paths when the toolchain is unavailable (`lib()` returns None).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "msann_native.cpp")
_SO = os.path.join(_HERE, "libmsann_native.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    # compile to a unique temp path + atomic rename: concurrent
    # processes on a fresh checkout must never dlopen a half-written .so
    tmp = f"{_SO}.tmp{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-pthread", "-shared", "-fPIC",
             _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def lib():
    """Return the loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # the .so is a build product (never committed): build it on
        # first use, and again whenever the source is newer
        if not os.path.exists(_SO) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            L = ctypes.CDLL(_SO)
        except OSError:
            return None
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        L.msann_read_header.argtypes = [ctypes.c_char_p, u32p, u32p]
        L.msann_save_projection.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, i32p,
            ctypes.c_uint32]
        L.msann_scan_projection.argtypes = [
            ctypes.c_char_p, u32p, u32p, u32p, i64p]
        L.msann_load_projection.argtypes = [
            ctypes.c_char_p, i32p, ctypes.c_uint32, ctypes.c_uint32]
        L.msann_save_bipartite.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, i32p, ctypes.c_uint32]
        L.msann_scan_bipartite.argtypes = [ctypes.c_char_p, u32p, u32p]
        L.msann_load_bipartite.argtypes = [
            ctypes.c_char_p, i32p, ctypes.c_uint32, ctypes.c_uint32]
        L.msann_stream_open.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32]
        L.msann_stream_open.restype = ctypes.c_void_p
        L.msann_stream_meta.argtypes = [ctypes.c_void_p, u32p, u32p]
        L.msann_stream_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        L.msann_stream_next.restype = ctypes.c_int64
        L.msann_stream_close.argtypes = [ctypes.c_void_p]
        L.msann_stream_close.restype = None
        for fn in ("msann_read_header", "msann_save_projection",
                   "msann_scan_projection", "msann_load_projection",
                   "msann_save_bipartite", "msann_scan_bipartite",
                   "msann_load_bipartite", "msann_stream_meta"):
            getattr(L, fn).restype = ctypes.c_int
        _lib = L
        return _lib
