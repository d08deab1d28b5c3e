"""Build the package's CUDA sources with nvcc and load them with ctypes.

On first use the sources under ``csrc/`` are compiled for Hopper (sm_90a)
into a shared library with a plain C interface, in ``build/kernels/``
beside the package. The library's name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is loaded as
it is. Nothing is prebuilt or downloaded. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "find_nvcc", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
# -fmad=false: no contraction of a*b+c into FMA, so each float operation
# rounds as the plain PyTorch twin's does and the kernel matches the twin
# bit for bit on the card. It costs some speed; see PERF.md.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
# C signatures of the entry points, by name (see csrc/*.cu).
_SIGNATURES = {
    "render_fwd": (
        [_P, _P, _I,  # spheres, sphere materials, count
         _P, _P, _I,  # triangles, triangle materials, count
         _P, _I,  # materials, count
         _P,  # camera and sky params
         _P,  # out
         _I, _I, _I, _I,  # height, width, spp, max_bounces
         _U, _I, _I,  # seed, sample_offset, jitter
         _I, _P],  # device index, stream
        ctypes.c_int,
    ),
}


def build_dir() -> Path:
    """``build/kernels`` next to the package directory (gitignored)."""
    return _PKG.parent / "build" / "kernels"


def find_nvcc() -> str:
    """nvcc from PATH, else from ``$CUDA_HOME/bin`` (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    home_nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if nvcc is None and home_nvcc.exists():
        nvcc = str(home_nvcc)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` if needed, load the library, declare its
    entry points' argument types. Raises if nvcc fails."""
    sources = _sources()
    out_dir = build_dir()
    lib_path = out_dir / f"libpt_kernels_{_digest(sources)}.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # Build under a temporary name, then rename: a concurrent process
        # never loads a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                    f"{res.stdout}{res.stderr}"
                )
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
