"""Build the package's CUDA sources with nvcc and load them with ctypes.

On first use the sources under ``csrc/`` are compiled for Hopper (sm_90a),
one nvcc process a source, all started together, and linked into a shared
library with a plain C interface, in ``build/kernels/`` beside the
package. The library's name carries a hash of the sources,
headers and flags, so an edited file is rebuilt and an unchanged one is
loaded as it is. ptxas's account of every kernel (registers, spills, local
memory) is kept beside the library; ``resource_usage`` reads it and
``ptxas_entries`` parses it, ``sass_opcodes`` counts instructions in a
built library's SASS and ``demangle`` names its kernels. Nothing is
prebuilt or downloaded. Nothing here runs at import. A build is the span
``pt.build.kernels`` (``pt.build.sweep``), counted in ``build.kernels``
(``build.sweep``; ``utils/tracing.py``).

That timed library holds every render kernel at its default launch shape
(``csrc/pt_sched.cuh`` ``DefaultTile``). The other shapes form the sweep
library (``load_sweep_library``): a render kernel's source compiled again
with ``-DPT_TILE_POINT=k`` is one translation unit holding only the entry
``<name>_tiled_<k>`` (its timed entry's arguments at point ``k``), built on
the first call that asks for one, with the same flags, one nvcc a unit, all
started together, into the same directory.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "find_nvcc", "library_path", "load_library",
           "resource_usage", "sweep_library_path", "load_sweep_library", "TILED_ENTRIES",
           "ptxas_entries", "sass_opcodes", "demangle"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
# -fmad=false: no contraction of a*b+c into FMA, so each float operation
# rounds as the plain PyTorch twin's does and the kernel matches the twin
# bit for bit on the card. It costs some speed; see PERF.md.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
# C signatures of the entry points, by name (see csrc/*.cu).
_SCENE = [_P, _P, _I,  # spheres, sphere materials, count
          _P, _P, _I,  # triangles, triangle materials, count
          _P, _I,  # materials, count
          _P]  # camera and sky params
_RUN = [_I, _I,  # height, width
        _I, _I,  # row_start, rows: the block of rows the launch renders
        _I, _I,  # spp, max_bounces
        _U, _I, _I,  # seed, sample_offset, jitter
        _I, _P]  # device index, stream
_SIGNATURES = {
    # out, round counter (or null)
    "render_fwd": (_SCENE + [_P, _P] + _RUN, ctypes.c_int),
    # variant, then render_fwd's arguments (csrc/pt_sched.cuh `FwdVariant`)
    "render_fwd_variant": ([_I] + _SCENE + [_P, _P] + _RUN, ctypes.c_int),
    # sphere, triangle and material rows, physical: the bytes a block stages
    "render_table_bytes": ([_I, _I, _I, _I], ctypes.c_int),
    "render_table_budget": ([], ctypes.c_int),
    # image, Jacobian planes, round counter (or null)
    "render_fused": (_SCENE + [_P, _P, _P] + _RUN, ctypes.c_int),
    "render_fused_max_bounces": ([], ctypes.c_int),
    # variant, then render_fused's arguments without the counter
    "render_fused_variant": ([_I] + _SCENE + [_P, _P] + _RUN, ctypes.c_int),
    # the scene tables, 7 emitter tables (see csrc/render_phys.cu), camera
    # and sky params, out, round counter (or null), nee, tri_nee
    "render_phys": (_SCENE[:-1] + [_P] * 7 + [_P, _P, _P, _I, _I] + _RUN, ctypes.c_int),
    # variant, then render_phys's arguments
    "render_phys_variant": ([_I] + _SCENE[:-1] + [_P] * 7 + [_P, _P, _P, _I, _I] + _RUN,
                            ctypes.c_int),
    # as render_phys up to the params; image, material and sky planes, sphere
    # planes (or null), triangle planes (or null), counters (or null), nee,
    # tri_nee, rough_grad, n_em_cap, tri_em_cap (csrc/render_phys_fused.cu)
    "render_phys_fused": (_SCENE[:-1] + [_P] * 7 + [_P] * 6 + [_I] * 5 + _RUN, ctypes.c_int),
    "render_phys_grad_max_bounces": ([], ctypes.c_int),
    # variant, then render_phys_fused's arguments without the counters and
    # rough_grad, then the sphere ordinals, triangle ordinals and emitter
    # materials in slots
    "render_phys_fused_variant": ([_I] + _SCENE[:-1] + [_P] * 7 + [_P] * 5 + [_I] * 7 + _RUN,
                                  ctypes.c_int),
    # the scene tables, the 6 emitter tables, raw emission colours, counts,
    # params, the image's cotangent, the two outputs, the partial sums, the
    # counters (or null), nee, tri_nee, n_em_cap (csrc/render_phys_bwd.cu)
    "render_phys_bwd": (_SCENE[:-1] + [_P] * 8 + [_P] * 6 + [_I] * 3 + _RUN, ctypes.c_int),
    "render_phys_bwd_counters": ([], ctypes.c_int),
    # variant, then render_phys_bwd's arguments without the counters and
    # tri_nee
    "render_phys_bwd_variant": ([_I] + _SCENE[:-1] + [_P] * 8 + [_P] * 5 + [_I] * 2 + _RUN,
                                ctypes.c_int),
    # x, out, n, kind, reps, device index, stream (csrc/calib.cu)
    "calib": ([_P, _P, _I, _I, _I, _I, _P], ctypes.c_int),
    # the scene tables and params as render_fwd takes them, out, height,
    # width, device index, stream (csrc/sol_probes.cu)
    "sol_null": (_SCENE + [_P, _I, _I, _I, _P], ctypes.c_int),
    # table, seed, out, height, width, objects, reps, hoisted, device index,
    # stream
    "sol_micro": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
}


# The sweep library's entries by source: ``<source>_tiled_<k>`` takes the
# timed entry's arguments (B5's without its counter).
TILED_ENTRIES = {
    "render_fwd": _SIGNATURES["render_fwd"],
    "render_phys": _SIGNATURES["render_phys"],
    "render_fused": _SIGNATURES["render_fused"],
    "render_phys_fused": _SIGNATURES["render_phys_fused"],
    "render_phys_bwd": (_SCENE[:-1] + [_P] * 8 + [_P] * 5 + [_I] * 3 + _RUN, ctypes.c_int),
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


def library_path() -> Path:
    """The library built from the current sources and flags."""
    return build_dir() / f"libpt_kernels_{_digest(_sources())}.so"


def sweep_library_path(units) -> Path:
    """The sweep library of ``units`` ((source stem, point) pairs) built
    from the current sources and flags."""
    tag = hashlib.sha256(repr(sorted(units)).encode()).hexdigest()[:8]
    return build_dir() / f"libpt_sweep_{_digest(_sources())}_{tag}.so"


def resource_usage(units=None) -> str:
    """What ptxas said of each kernel when the loaded library was built
    (``-Xptxas -v``): registers, stack frame, spill stores and loads. With
    ``units``, of the sweep library of those units instead, each unit's
    lines after a ``== <source> point <k>`` line."""
    if units is None:
        load_library()
        return library_path().with_suffix(".ptxas.txt").read_text()
    load_sweep_library(tuple(units))
    return sweep_library_path(units).with_suffix(".ptxas.txt").read_text()


_PTXAS_KEYS = (("registers", r"Used (\d+) registers"), ("stack", r"(\d+) bytes stack frame"),
               ("spill_stores", r"(\d+) bytes spill stores"),
               ("spill_loads", r"(\d+) bytes spill loads"))


def ptxas_entries(text: str) -> dict:
    """ptxas's registers, stack frame and spill bytes by mangled entry name,
    from ``resource_usage``'s text; an entry of the sweep library keeps the
    unit whose lines it follows (``== <unit>``) under ``unit``."""
    found, current, unit = {}, None, None
    for line in text.splitlines():
        if line.startswith("== "):
            unit = line[3:].strip()
        elif "Compiling entry function" in line and "'" in line:
            current = line.split("'")[1]
            found[current] = {"unit": unit} if unit else {}
        elif current is not None:
            for key, pattern in _PTXAS_KEYS:
                m = re.search(pattern, line)
                if m:
                    found[current][key] = int(m.group(1))
    return found


def sass_opcodes(opcode: str, lib_path=None) -> dict:
    """By mangled kernel name, in the SASS of the library at ``lib_path``
    (default the timed library; ``cuobjdump`` beside nvcc): the
    instructions whose opcode the regular expression ``opcode`` matches, by
    the opcode it matched, and all instructions under ``"instructions"``."""
    tool = Path(find_nvcc()).parent / "cuobjdump"
    lib_path = library_path() if lib_path is None else lib_path
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    op = re.compile(rf"\b({opcode})(?=[.\s;])")
    found, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = found.setdefault(line.split("Function :")[1].strip(), {"instructions": 0})
        elif current is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            current["instructions"] += 1
            m = op.search(line)
            if m:
                current[m.group(1)] = current.get(m.group(1), 0) + 1
    return found


def demangle(names) -> dict:
    """Demangled names (cu++filt beside nvcc, else c++filt) by mangled name,
    written alike whichever tool: no spaces, no ``(int)`` casts, ``(bool)0``
    and ``(bool)1`` as ``false`` and ``true``."""
    names = list(names)
    tool = Path(find_nvcc()).parent / "cu++filt"
    cmd = [str(tool)] if tool.exists() else ["c++filt"]
    out = subprocess.run(cmd, input="\n".join(names), capture_output=True, text=True,
                         check=True, timeout=120).stdout.splitlines()
    return {n: d.replace(" ", "").replace("(int)", "").replace("(bool)0", "false")
            .replace("(bool)1", "true") for n, d in zip(names, out)}


def _wait(proc):
    """(return code, stdout, stderr) of a started process, once it ends."""
    out, err = proc.communicate()
    return proc.returncode, out, err


def _check(cmd, rc, out, err):
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}{err}")


def _build(lib_path: Path, units) -> None:
    """Compile ``units`` ((source, extra nvcc flags, label) triples), one
    nvcc process a unit, all started together, and link them into
    ``lib_path``, with ptxas's lines beside it, each unit's after its label
    where it has one. Raises if nvcc fails."""
    out_dir = lib_path.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    # Build under a temporary name, then rename: a concurrent process
    # never loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        with tempfile.TemporaryDirectory(dir=out_dir) as obj_dir:
            nvcc = find_nvcc()
            objs = [Path(obj_dir) / f"{i}_{src.stem}.o" for i, (src, _, _) in enumerate(units)]
            jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True))
                    for cmd in ([nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)]
                                for (src, flags, _), obj in zip(units, objs))]
            logs = [(cmd, *_wait(proc)) for cmd, proc in jobs]
            for log in logs:
                _check(*log)
            link = [nvcc, "-shared", "-o", tmp, *map(str, objs)]
            res = subprocess.run(link, capture_output=True, text=True)
            _check(link, res.returncode, res.stdout, res.stderr)
        lib_path.with_suffix(".ptxas.txt").write_text(
            "".join((f"== {label}\n" if label else "") + err
                    for (_, _, label), (*_, err) in zip(units, logs)))
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _build_counted(library: str, lib_path: Path, units) -> None:
    """``_build`` as the span ``pt.build.<library>``, counted in
    ``build.<library>`` (``utils/tracing.py``). Imported here, not at the
    top: ``utils/tile_sweep.py`` and ``scripts/torch_fused_times.py`` load
    this file by its path, outside the package, for its parsers."""
    from ..utils.tracing import count, span

    count(f"build.{library}")
    with span(f"pt.build.{library}"):
        _build(lib_path, units)


def _declare(lib: ctypes.CDLL, signatures: dict) -> ctypes.CDLL:
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` if needed, load the library, declare its
    entry points' argument types. Raises if nvcc fails."""
    lib_path = library_path()
    if not lib_path.exists():
        _build_counted("kernels", lib_path, [(src, (), None) for src in _sources()])
    return _declare(ctypes.CDLL(str(lib_path)), _SIGNATURES)


@functools.cache
def load_sweep_library(units: tuple) -> ctypes.CDLL:
    """Compile the sweep library of ``units`` ((source stem, point) pairs,
    the stems of ``TILED_ENTRIES``, the points of ``csrc/pt_sched.cuh``
    ``TileAt`` other than 0) if needed, load it and declare its entries
    ``<stem>_tiled_<point>``. Raises if nvcc fails."""
    lib_path = sweep_library_path(units)
    if not lib_path.exists():
        _build_counted("sweep", lib_path, [(_CSRC / f"{stem}.cu", (f"-DPT_TILE_POINT={k}",),
                                            f"{stem} point {k}") for stem, k in units])
    return _declare(ctypes.CDLL(str(lib_path)),
                    {f"{stem}_tiled_{k}": TILED_ENTRIES[stem] for stem, k in units})
