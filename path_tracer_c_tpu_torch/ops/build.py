"""Build the package's CUDA sources with nvcc and load them with ctypes.

On first use the sources under ``csrc/`` are compiled for Hopper (sm_90a)
into a shared library with a plain C interface, in ``build/kernels/``
beside the package. The library's name carries a hash of the sources,
headers and flags, so an edited file is rebuilt and an unchanged one is
loaded as it is. ptxas's account of every kernel (registers, spills, local
memory) is kept beside the library; ``resource_usage`` reads it. Nothing
is prebuilt or downloaded. Nothing here runs at import.
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

__all__ = ["NVCC_FLAGS", "build_dir", "find_nvcc", "load_library", "resource_usage"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
# -fmad=false: no contraction of a*b+c into FMA, so each float operation
# rounds as the plain PyTorch twin's does and the kernel matches the twin
# bit for bit on the card. It costs some speed; see PERF.md.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    "--threads", "0",  # the sources compile side by side
)

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
# C signatures of the entry points, by name (see csrc/*.cu).
_SCENE = [_P, _P, _I,  # spheres, sphere materials, count
          _P, _P, _I,  # triangles, triangle materials, count
          _P, _I,  # materials, count
          _P]  # camera and sky params
_RUN = [_I, _I, _I, _I,  # height, width, spp, max_bounces
        _U, _I, _I,  # seed, sample_offset, jitter
        _I, _P]  # device index, stream
_SIGNATURES = {
    # out, round counter (or null)
    "render_fwd": (_SCENE + [_P, _P] + _RUN, ctypes.c_int),
    # image, Jacobian planes, round counter (or null)
    "render_fused": (_SCENE + [_P, _P, _P] + _RUN, ctypes.c_int),
    "render_fused_max_bounces": ([], ctypes.c_int),
    # the scene tables, 7 emitter tables (see csrc/render_phys.cu), camera
    # and sky params, out, round counter (or null), nee, tri_nee
    "render_phys": (_SCENE[:-1] + [_P] * 7 + [_P, _P, _P, _I, _I] + _RUN, ctypes.c_int),
    # as render_phys up to the params; image, material and sky planes, sphere
    # planes (or null), triangle planes (or null), round counter (or null),
    # nee, tri_nee, rough_grad, n_em_cap, tri_em_cap (csrc/render_phys_fused.cu)
    "render_phys_fused": (_SCENE[:-1] + [_P] * 7 + [_P] * 6 + [_I] * 5 + _RUN, ctypes.c_int),
    "render_phys_grad_max_bounces": ([], ctypes.c_int),
    # the scene tables, the 6 emitter tables, raw emission colours, counts,
    # params, the image's cotangent, the two outputs, nee, tri_nee, n_em_cap
    # (csrc/render_phys_bwd.cu)
    "render_phys_bwd": (_SCENE[:-1] + [_P] * 8 + [_P] * 4 + [_I] * 3 + _RUN, ctypes.c_int),
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
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(_CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _library_path() -> Path:
    return build_dir() / f"libpt_kernels_{_digest(_sources())}.so"


def resource_usage() -> str:
    """What ptxas said of each kernel when the loaded library was built
    (``-Xptxas -v``): registers, stack frame, spill stores and loads."""
    load_library()
    return _library_path().with_suffix(".ptxas.txt").read_text()


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` if needed, load the library, declare its
    entry points' argument types. Raises if nvcc fails."""
    sources = _sources()
    out_dir = build_dir()
    lib_path = _library_path()
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
            lib_path.with_suffix(".ptxas.txt").write_text(res.stderr)
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
