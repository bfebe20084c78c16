"""Native (C++) runtime components, loaded via ctypes.

The shared library is JIT-compiled from ring.cc with g++ on first use and
cached by source hash (no pybind11 in the target image; the C ABI +
ctypes keeps the binding layer dependency-free). Everything using this
module must degrade gracefully when `get_lib()` returns None (no
toolchain, exotic platform): the pure-Python paths stay correct, just
slower.

Counterpart: ray_tpu/_native/__init__.py (copied).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import sys
import tempfile
import threading

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_lib = None
_tried = False
_build_started = False

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ring.cc")


def _build_dir() -> str:
    d = os.environ.get("RT_NATIVE_BUILD_DIR") or os.path.join(
        tempfile.gettempdir(), f"rt_native_{os.geteuid()}")
    os.makedirs(d, exist_ok=True)
    return d


def _compile() -> str | None:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = os.path.join(_build_dir(), f"librt_native_{tag}.so")
    if os.path.exists(out):
        return out
    tmp = out + f".{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: concurrent builders converge
        return out
    except Exception as e:
        logger.warning("native build failed (%r); using pure-Python paths", e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("RT_DISABLE_NATIVE"):
            return None
        path = _compile()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            logger.warning("native load failed (%r)", e)
            return None
        lib.rt_ring_write.restype = ctypes.c_int
        lib.rt_ring_write.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_int64]
        lib.rt_ring_read.restype = ctypes.c_int64
        lib.rt_ring_read.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
            ctypes.c_uint64, ctypes.c_int64]
        lib.rt_ring_wait.restype = ctypes.c_int64
        lib.rt_ring_wait.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64]
        lib.rt_ring_ack.restype = None
        lib.rt_ring_ack.argtypes = [ctypes.c_void_p]
        lib.rt_parallel_memcpy.restype = None
        lib.rt_parallel_memcpy.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
        _lib = lib
        return _lib


def _buffer_address(mv: memoryview) -> int:
    """Address of a contiguous buffer, writable or readonly (numpy views a
    readonly buffer without copying)."""
    try:
        return ctypes.addressof((ctypes.c_char * len(mv)).from_buffer(mv))
    except TypeError:  # readonly
        import numpy as np

        return np.frombuffer(mv, dtype=np.uint8).ctypes.data


def get_lib_nowait():
    """Like get_lib() but NEVER blocks on a compile: returns the lib only if
    already built, kicking off a background build otherwise. Hot paths that
    merely prefer native (e.g. the object store's copy under its lock) use
    this so the first big put never stalls the whole object plane behind a
    g++ invocation."""
    global _build_started
    if _lib is not None or _tried:
        return _lib
    if not _lock.acquire(blocking=False):
        return None  # a build is in progress on another thread
    try:
        if _lib is not None or _tried or _build_started:
            return _lib
        # Flag under the lock BEFORE spawning: _tried only flips once the
        # build thread itself re-acquires the lock, so without this every
        # caller winning the non-blocking acquire first would spawn another
        # duplicate g++ build.
        _build_started = True
        threading.Thread(target=get_lib, daemon=True,
                         name="rt-native-build").start()
        return None
    finally:
        _lock.release()


def parallel_memcpy(dst_mv: memoryview, src, nthreads: int | None = None) -> bool:
    """Copy `src` (bytes-like) into `dst_mv` with the native threaded copy.
    Returns False (caller should fall back) when the lib is unavailable."""
    lib = get_lib_nowait()
    if lib is None:
        return False
    if nthreads is None:
        nthreads = min(8, os.cpu_count() or 1)
    src_mv = memoryview(src).cast("B")
    n = len(src_mv)
    if len(dst_mv) < n:
        raise ValueError("destination smaller than source")
    lib.rt_parallel_memcpy(_buffer_address(memoryview(dst_mv).cast("B")),
                           _buffer_address(src_mv), n, nthreads)
    return True
