"""ctypes bindings to the native host runtime (``native/build/libpt_native.so``).

The C++ runtime provides the host-side components the reference implements
in C (SURVEY.md SS2): a race-free thread pool (C5/C6) and a parallel,
byte-identical BMP encoder (C7), plus an async frame writer used by the
animation driver to overlap device renders with host IO. Everything here
degrades gracefully: if the library is absent, callers fall back to the
pure-Python implementations (utils/bitmap.py), and ``build()`` compiles
it from ``native/src`` with g++ (``native/build.sh``).
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["available", "build", "write_bitmap", "bitmap_bytes", "AsyncBitmapWriter", "ThreadPool"]

_NATIVE = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE / "build" / "libpt_native.so"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.pt_bmp_size.restype = ctypes.c_uint64
    lib.pt_bmp_size.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.pt_bmp_encode.restype = ctypes.c_uint64
    lib.pt_bmp_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.pt_bmp_write.restype = ctypes.c_int
    lib.pt_bmp_write.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_int,
    ]
    lib.pt_bmp_write_async.restype = ctypes.c_int
    lib.pt_bmp_write_async.argtypes = lib.pt_bmp_write.argtypes
    lib.pt_pool_create.restype = ctypes.c_void_p
    lib.pt_pool_create.argtypes = [ctypes.c_int]
    lib.pt_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.pt_pool_size.restype = ctypes.c_int
    lib.pt_pool_size.argtypes = [ctypes.c_void_p]
    lib.pt_pool_wait.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def build() -> bool:
    """Compile the library with g++ (native/build.sh); returns success."""
    script = _NATIVE / "build.sh"
    if not script.exists():
        return False
    try:
        subprocess.run([str(script)], check=True, capture_output=True)
    except (subprocess.CalledProcessError, OSError):
        return False
    global _lib
    _lib = None
    return available()


def _check_img(pixels):
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    if pixels.ndim != 3 or pixels.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {pixels.shape}")
    return pixels


def bitmap_bytes(pixels, y_inverted: bool = True) -> bytes:
    lib = _load()
    pixels = _check_img(pixels)
    h, w, _ = pixels.shape
    size = lib.pt_bmp_size(w, h)
    out = (ctypes.c_uint8 * size)()
    n = lib.pt_bmp_encode(
        pixels.ctypes.data, w, h, int(y_inverted), ctypes.addressof(out)
    )
    return bytes(out[:n])


def write_bitmap(path: str, pixels, y_inverted: bool = True) -> None:
    lib = _load()
    pixels = _check_img(pixels)
    h, w, _ = pixels.shape
    rc = lib.pt_bmp_write(
        str(path).encode(), pixels.ctypes.data, w, h, int(y_inverted)
    )
    if rc != 0:
        raise OSError(f"pt_bmp_write({path}) failed: {rc}")


class AsyncBitmapWriter:
    """Pipelined frame output: submit() returns immediately, the native
    pool encodes and writes in the background; drain() joins."""

    def __init__(self):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")

    def submit(self, path: str, pixels, y_inverted: bool = True) -> None:
        pixels = _check_img(pixels)
        h, w, _ = pixels.shape
        rc = self._lib.pt_bmp_write_async(
            str(path).encode(), pixels.ctypes.data, w, h, int(y_inverted)
        )
        if rc != 0:
            raise OSError(f"pt_bmp_write_async({path}) failed: {rc}")

    def drain(self) -> None:
        self._lib.pt_drain()


class ThreadPool:
    """Thin handle over the native pool (C5 replacement) for host tasks."""

    def __init__(self, n_threads: int = 0):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._pool = self._lib.pt_pool_create(n_threads)

    @property
    def size(self) -> int:
        return self._lib.pt_pool_size(self._pool)

    def wait(self) -> None:
        self._lib.pt_pool_wait(self._pool)

    def close(self) -> None:
        if self._pool:
            self._lib.pt_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
