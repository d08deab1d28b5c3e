"""ctypes bindings to the native host runtime, built from its C++ source.

The runtime (``native/src/pt_native.cpp``) is the host side of the
reference's C components: a thread pool, a parallel BMP encoder whose bytes
equal ``utils/bitmap.bitmap_bytes``'s, and an asynchronous frame writer
that copies a frame when it is submitted and encodes and writes it on the
pool, so that a camera sweep renders frame ``f + 1`` on the device while
the host writes frame ``f``.

At first use the source is compiled with ``g++ -O3 -std=c++17 -fPIC
-shared -pthread`` into ``build/native/libpt_native.so`` at the
repository's root (a directory git ignores), with the source's hash beside
it; a changed source is rebuilt. The tracked ``native/`` directory is only
read: its build script and its prebuilt library are never used. Where
``g++`` is missing or the build fails, ``available()`` is False and the
callers write with ``utils/bitmap.py``. A build is the span
``pt.build.native``, counted in ``build.native`` (``utils/tracing.py``).
Encoding a whole image into Python bytes stays with numpy
(``utils/bitmap.bitmap_bytes``), which is faster at that than a copy out
of the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .tracing import count, span

__all__ = ["available", "build", "library_path", "write_bitmap", "AsyncBitmapWriter",
           "ThreadPool"]

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "src" / "pt_native.cpp"
_LIB = _ROOT / "build" / "native" / "libpt_native.so"
_STAMP = _LIB.with_name(_LIB.name + ".sha256")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
_lib = None  # the loaded library, one per process


def library_path() -> Path:
    """Where the library is built."""
    return _LIB


def _digest() -> str:
    return hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()


def _write_atomic(path: Path, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build() -> bool:
    """Compile the library from its source with g++; True on success. The
    library replaces an older one atomically, then its hash is written."""
    global _lib
    gxx = shutil.which("g++")
    if gxx is None or not _SRC.exists():
        return False
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_LIB.parent, suffix=".so.tmp")
    os.close(fd)
    count("build.native")
    try:
        with span("pt.build.native"):
            subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(_SRC)], check=True,
                           capture_output=True, timeout=600)
        os.replace(tmp, _LIB)
        _write_atomic(_STAMP, _digest().encode())
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _lib = None
    return True


def _fresh() -> bool:
    try:
        return _LIB.exists() and _STAMP.read_text() == _digest()
    except OSError:
        return False


def _load():
    """The library, built first where it is missing or stale; None where
    it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    if not _fresh() and not build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB))
    except OSError:
        return None
    p, u32, i32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
    lib.pt_bmp_size.restype, lib.pt_bmp_size.argtypes = ctypes.c_uint64, [u32, u32]
    lib.pt_bmp_write.restype = ctypes.c_int
    lib.pt_bmp_write.argtypes = [ctypes.c_char_p, p, u32, u32, i32]
    lib.pt_bmp_write_async.restype = ctypes.c_int
    lib.pt_bmp_write_async.argtypes = lib.pt_bmp_write.argtypes
    lib.pt_drain.restype, lib.pt_drain.argtypes = None, []
    lib.pt_pool_create.restype, lib.pt_pool_create.argtypes = p, [i32]
    lib.pt_pool_destroy.restype, lib.pt_pool_destroy.argtypes = None, [p]
    lib.pt_pool_size.restype, lib.pt_pool_size.argtypes = ctypes.c_int, [p]
    lib.pt_pool_wait.restype, lib.pt_pool_wait.argtypes = None, [p]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library is built (building it if needed) and loads."""
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native library could not be built from {_SRC} (g++?)")
    return lib


def _check_img(pixels) -> np.ndarray:
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    if pixels.ndim != 3 or pixels.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {pixels.shape}")
    return pixels


def write_bitmap(path, pixels, y_inverted: bool = True) -> None:
    """Encode an (H, W, 3) uint8 RGB image on the pool and write it as a
    24-bit BMP, the bytes of ``utils/bitmap.bitmap_bytes``."""
    lib = _require()
    pixels = _check_img(pixels)
    h, w, _ = pixels.shape
    rc = lib.pt_bmp_write(str(path).encode(), pixels.ctypes.data, w, h, int(y_inverted))
    if rc != 0:
        raise OSError(f"pt_bmp_write({path}) failed: {rc}")


class AsyncBitmapWriter:
    """Frames written in the background: ``submit`` copies the frame and
    returns, the library's pool encodes and writes it; ``drain`` waits for
    every submitted frame, then checks that each file exists at its BMP's
    size and raises ``OSError`` for those that do not (the library drops a
    frame whose file it cannot open without a word)."""

    def __init__(self):
        self._lib = _require()
        self._pending: list[tuple[Path, int]] = []

    def submit(self, path, pixels, y_inverted: bool = True) -> None:
        pixels = _check_img(pixels)
        h, w, _ = pixels.shape
        path = Path(path)
        path.unlink(missing_ok=True)  # an old file must not pass for this frame
        rc = self._lib.pt_bmp_write_async(str(path).encode(), pixels.ctypes.data, w, h,
                                          int(y_inverted))
        if rc != 0:
            raise OSError(f"pt_bmp_write_async({path}) failed: {rc}")
        self._pending.append((path, int(self._lib.pt_bmp_size(w, h))))

    def drain(self) -> None:
        self._lib.pt_drain()
        pending, self._pending = self._pending, []
        missing = [str(p) for p, size in pending
                   if not (p.exists() and p.stat().st_size == size)]
        if missing:
            raise OSError(f"the async writer did not write {len(missing)} of {len(pending)} "
                          f"frame(s): {missing[:4]}")


class ThreadPool:
    """A pool of native worker threads (``n_threads <= 0``: one a core);
    ``close`` (or leaving a ``with`` block) joins them."""

    def __init__(self, n_threads: int = 0):
        self._lib = _require()
        self._pool = self._lib.pt_pool_create(n_threads)

    @property
    def size(self) -> int:
        return self._lib.pt_pool_size(self._pool)

    def wait(self) -> None:
        """Block until every submitted task has finished."""
        self._lib.pt_pool_wait(self._pool)

    def close(self) -> None:
        if self._pool:
            self._lib.pt_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
