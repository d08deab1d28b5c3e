"""The forward render kernel: hand-written CUDA, and its plain PyTorch twin.

``render_kernel`` is the main path's renderer. On CUDA tensors it launches
``csrc/render_fwd.cu``, which replaces the Pallas TPU kernel ``_kernel``
of ``path_tracer_c_tpu/ops/pallas_kernels.py``; on CPU tensors it runs
``render_kernel_reference``, the plain PyTorch transcription of the same
math, which the tests hold against the JAX package.

The estimator is the reference tier's (see ``models/integrator.py``);
what differs from the eager integrator is only the arithmetic's shape,
chosen as the TPU kernel chose it: the half-b sphere quadratic, sphere
normals normalized once after the closest-hit selection, triangle face
normals precomputed, and termination as zero throughput (no alive mask).
The twin works on (H*W,) planes, one per ray component.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import pack_cache as _pc
from . import rng as _rng
from .camera import Camera, check_rows, pixel_indices
from .rng import _f32, sqrt_rn
from ..scene.scene import Scene
from ..utils.tracing import count, span, wait

__all__ = ["render_kernel", "render_kernel_reference", "render_kernel_round_counts",
           "render_kernel_round_counts_reference", "render_kernel_variant", "packed_launcher",
           "reference_pixel_rounds", "warp_lane_rounds", "round_groupings", "warp_map",
           "table_bytes", "tables_in_shared", "policy", "VARIANTS", "KERNEL_POLICY",
           "SHARED_TABLE_BUDGET", "SOURCE", "REPLACES", "Tile", "TILES", "DEFAULT_TILE",
           "KIND_TILES", "KIND_DEFAULTS", "SMEM_OPTIN", "tile_point", "fit_tile", "block_smem",
           "tile_pixels"]

SOURCE = "path_tracer_c_tpu_torch/csrc/render_fwd.cu"
REPLACES = "path_tracer_c_tpu/ops/pallas_kernels.py:453"

_INF = float("inf")
_TRI_EPS = _f32(1e-6)
_EPS_OFFSET = _f32(1e-4)
_EPS_SCALE = _f32(4e-6)
_K_FLOOR = _f32(1e-12)
_N_FLOOR = _f32(1e-20)

# The policies of the timed forward kernels (csrc/render_fwd.cu,
# csrc/render_phys.cu `KernelPolicy`; csrc/pt_sched.cuh): path regeneration
# (a lane starts its next sample as soon as its path ends), and the scene
# tables staged into shared memory by each block, read from device memory
# where they exceed SHARED_TABLE_BUDGET bytes.
KERNEL_POLICY = {"schedule": "regen", "tables": "shared"}
# Their measurement instantiations (csrc/pt_sched.cuh `FwdVariant`), each the
# timed kernel under one other policy: the per-sample schedule (a warp runs
# each sample for as many rounds as its longest lane); the tables read from
# device memory.
VARIANTS = {"per_sample": 0, "global_tables": 1}
_POLICIES = {None: KERNEL_POLICY,
             "per_sample": {**KERNEL_POLICY, "schedule": "per_sample"},
             "global_tables": {**KERNEL_POLICY, "tables": "global"}}
# The most bytes of tables a block stages (csrc/pt_sched.cuh kSharedTableBudget).
SHARED_TABLE_BUDGET = 48 * 1024


# -- launch shapes ---------------------------------------------------------


class Tile(NamedTuple):
    """A launch shape (``csrc/pt_sched.cuh`` ``Tile``): a block renders
    ``th x tw`` pixels, one thread a pixel, as the JAX package's ``tile`` is
    the pixels one program renders; its warps are ``wh x ww`` footprints
    (``wh * ww = 32``) laid over the block row-major."""

    th: int
    tw: int
    wh: int
    ww: int

    @property
    def name(self) -> str:
        return f"{self.th}x{self.tw}/{self.wh}x{self.ww}"

    @property
    def threads(self) -> int:
        return self.th * self.tw

    @property
    def footprint(self) -> tuple:
        return (self.wh, self.ww)


# The points the render kernels are built at, in the order of
# csrc/pt_sched.cuh ``TileAt`` (a point's position is its number there): the
# timed library holds each kernel at its default point (``KIND_DEFAULTS``),
# the sweep library at the others.
TILES = {t.name: t for t in (Tile(8, 32, 1, 32), Tile(4, 32, 1, 32), Tile(16, 32, 1, 32),
                             Tile(16, 16, 2, 16), Tile(16, 16, 4, 8), Tile(8, 32, 4, 8),
                             Tile(8, 16, 4, 8))}
# B1's tile (the JAX package's name): 8 x 16 pixels, warps of 4 x 8
# (csrc/pt_sched.cuh ``FwdTile``). It beat 8 x 32 with warps of one row of 32
# by 2-3% alone at both shapes B1 was compared at on an H100, glossy
# 1024^2/64 spp/8 bounces and 1024 spheres at 512^2/16/4, and as called
# (PERF.md, tile sweep): a 4 x 8 warp straddles fewer silhouettes.
DEFAULT_TILE = (8, 16)
# The render kernels by the sweep's names, and their sources' stems.
KINDS = {"fwd": "render_fwd", "fused": "render_fused", "phys": "render_phys",
         "phys_fused": "render_phys_fused", "phys_bwd": "render_phys_bwd"}
# Each kernel's default point, the one the timed library holds. B2-B5 keep 8
# x 32 with warps of one row of 32, which no point beat at every shape (the
# JAX package's ``render_physical_pallas`` takes ``DEFAULT_TILE``; B3 does
# not follow B1: at 1024 spheres its 41 KB tables cost 128-thread tiles
# 3-7%). ``ops/render_grad.py`` and ``ops/render_physical_grad.py`` name
# theirs as the JAX package does.
KIND_DEFAULTS = {"fwd": DEFAULT_TILE, "fused": (8, 32), "phys": (8, 32),
                 "phys_fused": (8, 32), "phys_bwd": (8, 32)}
# The points of each kernel. Every point keeps a multiprocessor's threads
# (csrc/pt_sched.cuh ``min_blocks``): 1024 for B1-B4, 768 for B5, which no
# block of 512 threads divides.
KIND_TILES = {kind: tuple(n for n, t in TILES.items()
                          if (768 if kind == "phys_bwd" else 1024) % t.threads == 0)
              for kind in KINDS}
# The most shared memory a block may opt into on an H100 (227 KB).
SMEM_OPTIN = 232448
# Bytes of one round of B2's per-bounce records (csrc/render_fused.cu
# SharedRecords).
_FUSED_ROUND_BYTES = 15


def tile_point(tile=None, kind: str | None = None) -> Tile:
    """The point of ``TILES`` that ``tile`` names: ``None`` (``kind``'s
    default, ``KIND_DEFAULTS``; without ``kind``, B1's ``DEFAULT_TILE``), a
    ``Tile``, a name ``"THxTW/WHxWW"``, or ``"THxTW"`` and ``(th, tw)`` for
    the first point of that tile (its widest footprint), or ``(th, tw, wh,
    ww)``. With ``kind``, one of that kernel's points (``KIND_TILES``).
    Raises ``ValueError`` naming the points otherwise."""
    points = KIND_TILES[kind] if kind is not None else tuple(TILES)
    spec = (KIND_DEFAULTS[kind] if kind is not None else DEFAULT_TILE) if tile is None else tile
    name = None
    if isinstance(spec, str):
        name = spec if "/" in spec else next(
            (n for n in TILES if n.split("/")[0] == spec), spec)
    elif isinstance(spec, (tuple, list)) and len(spec) in (2, 4) and all(
            isinstance(v, int) for v in spec):
        name = (Tile(*spec).name if len(spec) == 4 else next(
            (n for n, t in TILES.items() if (t.th, t.tw) == tuple(spec)), None))
    if name not in points:
        of = f" of {KINDS[kind]}" if kind is not None else ""
        raise ValueError(f"tile {tile!r} is no point{of}; one of {', '.join(points)}")
    return TILES[name]


def tile_pixels(tile, rows: int, width: int, device=None):
    """The twin of ``csrc/pt_sched.cuh`` ``Tile::pixel``: a launch at point
    ``tile`` over ``rows`` rows of ``width`` pixels, every thread's row and
    column as two (blocks, threads) int64 tensors (the blocks row-major over
    the grid, a block's threads by their flat index: lane ``tid % 32`` of
    warp ``tid // 32``), and whether it lies inside the image."""
    t = tile_point(tile)
    grid_y, grid_x = -(-rows // t.th), -(-width // t.tw)
    tid = torch.arange(t.threads, device=device)
    lane, warp = tid % 32, tid // 32
    across = t.tw // t.ww
    row_in = (warp // across) * t.wh + lane // t.ww
    col_in = (warp % across) * t.ww + lane % t.ww
    by = torch.arange(grid_y, device=device).repeat_interleave(grid_x)
    bx = torch.arange(grid_x, device=device).repeat(grid_y)
    row = by[:, None] * t.th + row_in[None, :]
    col = bx[:, None] * t.tw + col_in[None, :]
    return row, col, (row < rows) & (col < width)


def block_smem(kind: str, tile, scene: Scene, max_bounces: int, n_em_cap: int = 0) -> int:
    """Bytes of shared memory a block of B2 (``kind`` "fused") or B5
    ("phys_bwd") takes at ``tile``: B2's records, ``(max_bounces + 1) *
    threads * 15``; B5's tables, one a warp of ``8 (M + 1) + 4
    max(n_em_cap, 1)`` floats. The other kernels' blocks do not grow with
    the tile: B1's and B3's staged tables are the same at every tile and
    capped at ``SHARED_TABLE_BUDGET``, and B4 keeps its records in local
    memory and its planes in device memory."""
    t = tile_point(tile, kind)
    if kind == "fused":
        return (max_bounces + 1) * t.threads * _FUSED_ROUND_BYTES
    if kind != "phys_bwd":
        raise ValueError(f"block_smem sizes B2 and B5 only, not {kind!r}")
    n_acc = 8 * (scene.num_materials + 1) + 4 * max(n_em_cap, 1)
    return -(-4 * (t.threads // 32) * n_acc // 16) * 16


def fit_tile(kind: str, scene: Scene, rows: int, width: int, max_bounces: int, tile=None,
             n_em_cap: int = 0) -> Tile:
    """The point (``TILES``) a launch of ``kind``'s kernel (``KINDS``) uses:
    the one ``tile`` names (``tile_point``), the default where it is None.
    Where a block of B2 or B5 at that point would take more shared memory
    than a block may (``block_smem`` against ``SMEM_OPTIN``) it takes the
    next smaller point of the same warp footprint, as the JAX package's
    ``_fit_tile`` shrinks its tile to the VMEM budget; raises
    ``ValueError`` where none fits. B1's, B3's and B4's blocks fit at every
    point (``block_smem``). The one sizing call of the wrappers, the
    counting twins (their warp footprint) and ``utils/flops.sol_report``.
    The kernels mask a ragged edge, so ``rows`` and ``width`` ask nothing of
    the tile (the JAX tile divides them)."""
    del rows, width  # see above
    t = tile_point(tile, kind)
    if kind not in ("fused", "phys_bwd"):
        return t
    while block_smem(kind, t, scene, max_bounces, n_em_cap) > SMEM_OPTIN:
        smaller = [TILES[n] for n in KIND_TILES[kind]
                   if TILES[n].footprint == t.footprint and TILES[n].threads < t.threads]
        if not smaller:
            raise ValueError(f"{KINDS[kind]}: no point of footprint {t.wh}x{t.ww} keeps a "
                             f"block within {SMEM_OPTIN} bytes of shared memory")
        t = max(smaller, key=lambda p: p.threads)
    return t


def _sweep_units() -> tuple:
    """The sweep library's (source stem, point) pairs: every kernel at each
    of its points but its default."""
    return tuple((stem, list(TILES).index(n)) for kind, stem in KINDS.items()
                 for n in KIND_TILES[kind] if n != tile_point(None, kind).name)


def _at_default(stem: str, t: Tile) -> bool:
    """Whether ``t`` is the timed kernel ``stem``'s default point."""
    return t == tile_point(None, next(k for k, v in KINDS.items() if v == stem))


def _library(stem: str, t: Tile):
    """The library that holds the timed kernel ``stem``'s entry at point
    ``t``: the timed library at the kernel's default point, else the sweep
    library; each built on its first use (``ops/build.py``). A wrapper loads
    it while it packs, so that a build never runs inside a launch's span."""
    from .build import load_library, load_sweep_library

    return load_library() if _at_default(stem, t) else load_sweep_library(_sweep_units())


def _entry(stem: str, t: Tile):
    """The C entry of the timed kernel ``stem`` at point ``t``, in
    ``_library``'s library."""
    name = stem if _at_default(stem, t) else f"{stem}_tiled_{list(TILES).index(t.name)}"
    return getattr(_library(stem, t), name)


def policy(variant: str | None = None) -> dict:
    """The schedule and table placement of the timed kernel (``None``) or of
    one of its measurement instantiations."""
    if variant not in _POLICIES:
        raise ValueError(f"unknown variant {variant!r}; one of {', '.join(VARIANTS)}")
    return _POLICIES[variant]


def _warp_key(variant: str | None = None) -> str:
    """The key of ``round_groupings`` that an instantiation's warp
    lane-rounds count: its schedule's."""
    regen = policy(variant)["schedule"] == "regen"
    return "warp_lane_rounds_regen" if regen else "warp_lane_rounds"


_FLOAT_FIELDS = {
    "materials": ("albedo", "roughness", "metallicity", "emission_color",
                  "emission_strength", "transparency", "refractive_index"),
    "spheres": ("center", "radius"),
    "triangles": ("v0", "v1", "v2"),
}
# Every field of the scene's tables, (table, name, dtype): the float fields,
# then each object table's material index and mask. The kernels' tables are
# packed from these (``_scene_operands``, ``render_physical._phys_operands``).
_TABLE_FIELDS = (tuple((table, name, torch.float32)
                       for table, names in _FLOAT_FIELDS.items() for name in names)
                 + tuple((table, name, dtype) for table in ("spheres", "triangles")
                         for name, dtype in (("material", torch.int32), ("active", torch.bool))))
_CAMERA_FIELDS = ("origin", "right", "up", "forward", "fov")


def _check_inputs(scene: Scene, camera: Camera, height, width, spp,
                  max_bounces, seed, sample_offset, row_start=0, rows=None) -> int:
    """Raise on what the kernels do not take; returns the row count of the
    block of ``rows`` rows (None: the whole image) from ``row_start``."""
    device = scene.device
    tensors = [("sky_color", scene.sky_color, torch.float32)]
    tensors += [(f"{table}.{name}", getattr(getattr(scene, table), name), dtype)
                for table, name, dtype in _TABLE_FIELDS]
    tensors += [(f"camera.{name}", getattr(camera, name), torch.float32)
                for name in _CAMERA_FIELDS]
    for name, t, dtype in tensors:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the scene on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not (height >= 1 and width >= 1 and height * width < 2**31):
        raise ValueError(f"image {height}x{width} out of range")
    if spp < 1 or max_bounces < 0:
        raise ValueError(f"spp {spp} < 1 or max_bounces {max_bounces} < 0")
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed {seed} is not a uint32")
    if not 0 <= int(sample_offset) < 2**31 - spp:
        raise ValueError(f"sample_offset {sample_offset} out of range")
    return check_rows(height, row_start, rows)


def _face_normals(v0, v1, v2):
    """Unit face normals of cross(v0 - v1, v0 - v2), with the TPU
    wrapper's 1e-20 floor."""
    e1 = v0 - v1
    e2 = v0 - v2
    n = torch.stack(
        [e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
         e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
         e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]],
        dim=-1,
    )
    return n * torch.rsqrt(torch.clamp_min(torch.sum(n * n, -1, keepdim=True), _N_FLOOR))


def _scene_operands(scene: Scene):
    """Pack the scene into the kernel's row-major tables.

    spheres (S, 5): center, radius, active; triangles (T, 13): v0, v1, v2,
    unit face normal, active; materials (M, 9): albedo, emission colour x
    strength, roughness, transparency, ior; plus the int32 material index
    of every sphere and triangle. An empty object table becomes one
    inactive row.
    """
    sp, tr, m = scene.spheres, scene.triangles, scene.materials
    sph = torch.cat(
        [sp.center, sp.radius[:, None], sp.active.to(torch.float32)[:, None]], 1
    )
    tri = torch.cat(
        [tr.v0, tr.v1, tr.v2, _face_normals(tr.v0, tr.v1, tr.v2),
         tr.active.to(torch.float32)[:, None]], 1,
    )
    mat = torch.cat(
        [m.albedo, m.emission_color * m.emission_strength[:, None],
         m.roughness[:, None], m.transparency[:, None],
         m.refractive_index[:, None]], 1,
    )
    sph_m, tri_m = sp.material, tr.material
    if sph.shape[0] == 0:
        sph, sph_m = sph.new_zeros(1, 5), sph_m.new_zeros(1)
    if tri.shape[0] == 0:
        tri, tri_m = tri.new_zeros(1, 13), tri_m.new_zeros(1)
    return (
        sph.contiguous(), sph_m.contiguous(),
        tri.contiguous(), tri_m.contiguous(),
        mat.contiguous(),
    )


def _seg_words(n: int) -> int:
    return (n + 3) & ~3


def table_bytes(scene: Scene, physical: bool = False) -> int:
    """Bytes of shared memory a block of B1 (``physical``: of B3, with the
    emitter tables) stages the scene's tables into: each table rounded up to
    16 bytes, an empty object table as one row (csrc/pt_sched.cuh
    ``table_words``)."""
    n_sph, n_tri = max(scene.num_spheres, 1), max(scene.num_triangles, 1)
    n_mat = scene.num_materials
    words = (_seg_words(5 * n_sph) + _seg_words(n_sph) + _seg_words(13 * n_tri)
             + _seg_words(n_tri) + _seg_words(9 * n_mat))
    if physical:
        words += (_seg_words(n_sph) + _seg_words(3 * n_sph) + _seg_words(n_tri)
                  + _seg_words(3 * n_tri) + _seg_words(n_tri) + _seg_words(n_mat))
    return 4 * words


def tables_in_shared(scene: Scene, physical: bool = False, variant: str | None = None) -> bool:
    """Whether the timed B1 (``physical``: B3), or its measurement
    instantiation ``variant``, reads the scene's tables from shared memory:
    it stages them, and they fit the budget."""
    return (policy(variant)["tables"] == "shared"
            and table_bytes(scene, physical) <= SHARED_TABLE_BUDGET)


def _check_variant(scene: Scene, variant: str, physical: bool = False):
    """A measurement instantiation that exists and, where it stages the
    tables, whose tables fit the budget (it has no fallback)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {', '.join(VARIANTS)}")
    if policy(variant)["tables"] == "shared" and table_bytes(scene, physical) > SHARED_TABLE_BUDGET:
        raise ValueError(f"variant {variant}: the tables take {table_bytes(scene, physical)} "
                         f"bytes, above the shared budget of {SHARED_TABLE_BUDGET}")


def _variant_or_tile(variant, tile):
    """The measurement instantiations are built at the default point only,
    so a call names a ``variant`` or a ``tile``, not both."""
    if variant is not None and tile is not None:
        raise ValueError(f"variant {variant} is built at the default tile; it takes no tile")


def _cuda_only(scene: Scene, name: str):
    """A measurement instantiation has no twin: it runs on CUDA tensors only."""
    if scene.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors only, not {scene.device}")


def _camera_params(camera: Camera, scene: Scene, height: int, width: int):
    """(17,) float32: tan(fov/2), aspect, sky rgb, camera origin, right,
    up, forward, on the scene's device. The aspect is copied from the
    host's pageable memory, which waits for the device's stream: a launch
    takes it under ``wait("camera_params")``."""
    device = scene.device
    tan2 = torch.tan(camera.fov * 0.5).reshape(1)
    aspect = torch.tensor([_f32(width / height)], dtype=torch.float32, device=device)
    return torch.cat(
        [tan2, aspect, scene.sky_color, camera.origin, camera.right,
         camera.up, camera.forward]
    ).contiguous()


def _table_key(scene: Scene):
    """The ``pack_cache.Key`` of the scene's tables: every field of
    ``_TABLE_FIELDS``."""
    return _pc.key([getattr(getattr(scene, table), name) for table, name, _ in _TABLE_FIELDS])


def _camera_key(camera: Camera, scene: Scene, height: int, width: int):
    """The ``pack_cache.Key`` of ``_camera_params``: the camera's fields and
    the sky's colour, at ``height`` x ``width``."""
    return _pc.key([*(getattr(camera, name) for name in _CAMERA_FIELDS), scene.sky_color],
                   height, width)


def _pack(kind: str, tile, scene: Scene, camera: Camera, height: int, width: int, pack, stream):
    """A launch's pack phase for the kernel ``kind`` (``KINDS``) at the point
    ``tile`` names: returns the point, its library (``_library``), the
    scene's tables as ``pack(scene)`` packs them and the camera's parameters
    (``_camera_params``). Tables and parameters are reused from the last
    launch that packed them on the same ``stream`` (the tables: of the same
    kernel) while their source tensors are unchanged (``pack_cache``): no
    copy, no kernel and no wait then. A
    ``pt.pack.<stem>`` span holds the library's load and both lookups; the
    tables count in ``pack.hit.<stem>`` or ``pack.miss.<stem>``; the
    parameters are packed anew under ``wait("camera_params")``."""
    stem = KINDS[kind]
    with span("pt.pack." + stem):
        t = tile_point(tile, kind)
        lib = _library(stem, t)
        tables_key = _table_key(scene)
        tables = _pc.TABLES.get((stem, stream), tables_key)
        count(("pack.miss." if tables is None else "pack.hit.") + stem)
        if tables is None:
            tables = _pc.TABLES.put((stem, stream), tables_key, pack(scene))
        camera_key = _camera_key(camera, scene, height, width)
        par = _pc.CAMERAS.get(stream, camera_key)
    if par is None:
        with wait("camera_params"):
            par = _pc.CAMERAS.put(stream, camera_key,
                                  _camera_params(camera, scene, height, width))
    return t, lib, tables, par


def _ptr(t):
    """A tensor's device pointer for ctypes; None passes as null."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _table_args(operands):
    """The scene tables of ``_scene_operands`` as the kernels' leading
    arguments: spheres, triangles and materials, each with its row count."""
    sph, sph_m, tri, tri_m, mat = operands
    return (_ptr(sph), _ptr(sph_m), sph.shape[0],
            _ptr(tri), _ptr(tri_m), tri.shape[0],
            _ptr(mat), mat.shape[0])


def _run_args(height, width, spp, max_bounces, seed, sample_offset, jitter, device,
              row_start=0, rows=None):
    """The kernels' trailing arguments: sizes, the block of ``rows`` rows
    (None: all) from ``row_start``, stream seeds, the device and PyTorch's
    current stream on it."""
    stream = torch.cuda.current_stream(device).cuda_stream
    return (height, width, int(row_start), height if rows is None else int(rows),
            spp, max_bounces, int(seed), int(sample_offset), int(bool(jitter)),
            device.index, ctypes.c_void_p(stream))


def render_kernel(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    sample_offset: int = 0,
    jitter: bool = False,
    count_rounds: bool = False,
    row_start: int = 0,
    rows: int | None = None,
    tile=None,
):
    """Radiance image (rows, W, 3) float32, on the scene's device: the
    block of ``rows`` rows (default: all ``height``) from ``row_start``, the
    same rows of the whole image bit for bit (RNG streams and camera rays
    key on global rows). Raises unless ``0 <= row_start``, ``rows >= 1``
    and ``row_start + rows <= height``.

    CUDA tensors go to the hand kernel, built on first use (``ops.build``);
    the counter ``launch.render_fwd`` (``utils/tracing.py``) counts its
    launches. CPU tensors go to ``render_kernel_reference``. Any other
    device raises.

    ``count_rounds=True`` returns ``(image, executed_rounds)``: the bounce
    rounds that ran, summed over threads (one per pixel) and samples, as a
    Python int. A thread stops at a miss or at zero throughput, so this is
    less than the nominal ``H * W * spp * (max_bounces + 1)``. The count
    is per thread; the JAX package counts whole tile rounds, so the two
    are not comparable. Counting is a second instantiation of the kernel
    and waits for the device; timed renders leave it off.

    ``tile``: the launch shape, a point of ``TILES`` (``tile_point``;
    default ``DEFAULT_TILE``), as ``fit_tile`` fits it; a tile that is no
    point raises ``ValueError`` on every device. The image and the
    thread-rounds do not depend on it; the twin takes none.
    """
    with span("pt.check.render_fwd"):
        rows = _check_inputs(scene, camera, height, width, spp, max_bounces, seed,
                             sample_offset, row_start, rows)
        t = fit_tile("fwd", scene, rows, width, max_bounces, tile)
    device = scene.device
    if device.type == "cpu":
        return render_kernel_reference(
            scene, camera, height, width, spp, max_bounces, seed,
            sample_offset=sample_offset, jitter=jitter, count_rounds=count_rounds,
            row_start=row_start, rows=rows,
        )
    out, counter = _launch(scene, camera, height, width, spp, max_bounces, seed,
                           sample_offset, jitter, count_rounds, row_start=row_start, rows=rows,
                           tile=t)
    if not count_rounds:
        return out
    with wait("count_rounds"):
        return out, int(counter[0])


def _launch(scene, camera, height, width, spp, max_bounces, seed, sample_offset, jitter,
            count_on, variant=None, row_start=0, rows=None, tile=None):
    """Launch B1 on the scene's CUDA device over the block of ``rows`` rows
    (None: all) from ``row_start``: the timed kernel at point ``tile``
    (None: the default), or with ``variant`` an instantiation of
    ``VARIANTS``; with ``count_on``, its counting instantiation, whose two
    counters (thread-rounds, warp lane-rounds of its schedule) come back
    beside the image. The operands are ``_pack``'s, reused while the scene
    and the camera are unchanged."""
    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"render_kernel runs on CUDA or CPU tensors, not {device}")
    t, lib, operands, par = _pack("fwd", tile, scene, camera, height, width, _scene_operands,
                                  torch.cuda.current_stream(device).cuda_stream)
    with span("pt.launch.render_fwd"):
        rows = height if rows is None else rows
        out = torch.empty((rows, width, 3), dtype=torch.float32, device=device)
        counter = torch.zeros(2, dtype=torch.int64, device=device) if count_on else None
        args = (*_table_args(operands), _ptr(par), _ptr(out), _ptr(counter),
                *_run_args(height, width, spp, max_bounces, seed, sample_offset, jitter, device,
                           row_start, rows))
        if variant is None:
            err, name = _entry("render_fwd", t)(*args), f"render_fwd at {t.name}"
        else:
            err, name = lib.render_fwd_variant(VARIANTS[variant], *args), f"render_fwd {variant}"
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
        count("launch.render_fwd" if variant is None else "launch.render_fwd.variant")
    return out, counter


def render_kernel_variant(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    variant: str,
    sample_offset: int = 0,
    jitter: bool = False,
    row_start: int = 0,
    rows: int | None = None,
):
    """The image of an instantiation of B1 (``VARIANTS``), on CUDA tensors
    only: what the decomposition of B1's time
    (``utils/sol_decompose.sol_decompose``) times beside the kernel. No
    user path runs it; its image equals ``render_kernel``'s, row blocks
    included. One that stages its tables (``policy``) raises where they
    exceed ``SHARED_TABLE_BUDGET``. Counts its launches in
    ``launch.render_fwd.variant``."""
    with span("pt.check.render_fwd"):
        rows = _check_inputs(scene, camera, height, width, spp, max_bounces, seed,
                             sample_offset, row_start, rows)
        _check_variant(scene, variant)
        _cuda_only(scene, "render_kernel_variant")
    return _launch(scene, camera, height, width, spp, max_bounces, seed, sample_offset, jitter,
                   False, variant, row_start, rows)[0]


def packed_launcher(scene: Scene, camera: Camera, height: int, width: int, spp: int,
                    max_bounces: int, variant: str | None = None, jitter: bool = False,
                    tile=None):
    """B1 at point ``tile`` (``fit_tile``), or its instantiation ``variant``
    (built at the default point: it takes no ``tile``), on operands packed
    once, on CUDA tensors only: ``launch(seed)`` runs it into one image,
    which it returns (the same tensor each call), without the checks, the
    cache's lookups and the allocation that ``render_kernel`` makes on every
    call. What the measurement scripts time as the kernel alone; no user
    path runs it, and its launches count nowhere. Each launch is a
    ``pt.launch.render_fwd`` span."""
    _variant_or_tile(variant, tile)
    t = fit_tile("fwd", scene, height, width, max_bounces, tile)
    _cuda_only(scene, "packed_launcher")
    if variant is not None:
        _check_variant(scene, variant)
    from .build import load_library

    lib = load_library()
    device = scene.device
    operands = _scene_operands(scene)
    par = _camera_params(camera, scene, height, width)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    head = (*_table_args(operands), _ptr(par), _ptr(out), None)
    if variant is None:
        entry, name = _entry("render_fwd", t), f"render_fwd at {t.name}"
    else:
        entry, name = lib.render_fwd_variant, f"render_fwd {variant}"
        head = (VARIANTS[variant], *head)

    def launch(seed):
        with span("pt.launch.render_fwd"):
            err = entry(*head, *_run_args(height, width, spp, max_bounces, seed, 0, jitter,
                                          device))
            if err != 0:
                raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
        return out

    launch.keep = (operands, par)  # the pointers' tensors, kept alive
    return launch


def render_kernel_round_counts(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    sample_offset: int = 0,
    jitter: bool = False,
    variant: str | None = None,
    row_start: int = 0,
    rows: int | None = None,
    tile=None,
) -> dict:
    """The rounds B1 runs for one render: ``thread_rounds`` (as
    ``count_rounds``) and the rounds its warps run times their lanes in the
    image, summed over warps: ``warp_lane_rounds`` where the kernel runs
    each sample for as many rounds as the sample's longest lane,
    ``warp_lane_rounds_regen`` where it regenerates paths (each warp as many
    rounds as its busiest lane's total over all samples). Their difference
    from the thread-rounds is the lane slots lost to divergence. A warp is
    the footprint of the launch's point ``tile`` (``fit_tile``; by default
    ``DEFAULT_TILE``'s, 4 x 8 pixels). CUDA tensors
    run the counting instantiation of the timed kernel (a launch: it counts
    in ``launch.render_fwd``), or of ``variant`` (in
    ``launch.render_fwd.variant``), which gives the key of its own
    schedule; CPU tensors the plain twin, which gives both
    (``render_kernel_round_counts_reference``). ``row_start`` and ``rows``:
    a row block, as in ``render_kernel``; the blocks' counts sum to the
    whole image's."""
    with span("pt.check.render_fwd"):
        _variant_or_tile(variant, tile)
        rows = _check_inputs(scene, camera, height, width, spp, max_bounces, seed,
                             sample_offset, row_start, rows)
        t = fit_tile("fwd", scene, rows, width, max_bounces, tile)
        if variant is not None and scene.device.type != "cpu":
            _check_variant(scene, variant)
    if scene.device.type == "cpu":
        return render_kernel_round_counts_reference(
            scene, camera, height, width, spp, max_bounces, seed, sample_offset, jitter,
            row_start, rows, tile=t)
    _, counter = _launch(scene, camera, height, width, spp, max_bounces, seed, sample_offset,
                         jitter, True, variant, row_start, rows, tile=t)
    with wait("count_rounds"):
        thread_rounds, warp_rounds = counter.tolist()
    return {"thread_rounds": thread_rounds, _warp_key(variant): warp_rounds}


def render_kernel_round_counts_reference(scene, camera, height, width, spp, max_bounces, seed,
                                         sample_offset=0, jitter=False, row_start=0,
                                         rows=None, tile=None) -> dict:
    """Plain twin of ``render_kernel_round_counts``, on the scene's device:
    the twin's rounds of every (sample, pixel), grouped by warp under both
    schedules (``round_groupings``), a warp the footprint of the point
    ``fit_tile`` gives ``tile``."""
    rows = _check_inputs(scene, camera, height, width, spp, max_bounces, seed, sample_offset,
                         row_start, rows)
    t = fit_tile("fwd", scene, rows, width, max_bounces, tile)
    return round_groupings(reference_pixel_rounds(scene, camera, height, width, spp,
                                                  max_bounces, seed, sample_offset, jitter,
                                                  row_start, rows), t.footprint)


def warp_map(height: int, width: int, footprint=(1, 32), device=None):
    """The warps of a launch over ``height`` rows of ``width`` pixels whose
    warps are ``footprint`` = (wh, ww) pixels (``Tile.footprint``): the
    footprints lie on a grid from the block of rows' first pixel (every
    tile is a whole number of them), the ragged edge's cut. Returns each
    pixel's warp, row-major (H*W,) int64, the number of warps and each
    warp's lanes inside the image."""
    wh, ww = footprint
    across = -(-width // ww)
    r = torch.arange(height, device=device) // wh
    c = torch.arange(width, device=device) // ww
    warp = (r[:, None] * across + c[None, :]).reshape(-1)
    n_warps = -(-height // wh) * across
    return warp, n_warps, torch.bincount(warp, minlength=n_warps)


def warp_lane_rounds(rounds: torch.Tensor, footprint=(1, 32)) -> int:
    """Warp lane-rounds of per-(sample, pixel) round counts ``rounds``
    (spp, H, W): each warp (``footprint``, ``warp_map``; by default 32
    columns of a row from a multiple of 32) runs, in each sample, as many
    rounds as its longest lane, for each of its lanes inside the image."""
    spp, height, width = rounds.shape
    warp, n_warps, lanes = warp_map(height, width, footprint, rounds.device)
    widest = torch.zeros((spp, n_warps), dtype=rounds.dtype, device=rounds.device)
    widest.scatter_reduce_(1, warp.expand(spp, -1), rounds.reshape(spp, -1), "amax")
    return int((widest * lanes).sum())


def round_groupings(rounds: torch.Tensor, footprint=(1, 32)) -> dict:
    """The rounds of per-(sample, pixel) round counts ``rounds`` (spp, H,
    W) under two schedules, a warp ``footprint`` (``warp_map``):
    ``thread_rounds``;
    ``warp_lane_rounds``, each warp running each sample for as many rounds
    as that sample's longest lane (every lane waits at the end of a sample:
    the per-sample schedule); ``warp_lane_rounds_regen``, each warp running
    for as many rounds as its busiest lane's total over all samples (path
    regeneration: a lane starts its next sample at once)."""
    return {"thread_rounds": int(rounds.sum()),
            "warp_lane_rounds": warp_lane_rounds(rounds, footprint),
            "warp_lane_rounds_regen": warp_lane_rounds(rounds.sum(0)[None], footprint)}


def reference_pixel_rounds(scene, camera, height, width, spp, max_bounces, seed,
                           sample_offset=0, jitter=False, row_start=0, rows=None) -> torch.Tensor:
    """The plain twin's rounds of every (sample, pixel) of the row block,
    (spp, rows, W) int64: those that begin with nonzero throughput, the
    rounds a thread of the kernel runs."""
    per_sample = []
    _reference(scene, camera, height, width, spp, max_bounces, seed, sample_offset, jitter,
               on_sample=per_sample.append, row_start=row_start, rows=rows)
    return torch.stack(per_sample)


# -- the plain twin --------------------------------------------------------


def _camera_dir(par, px, py, fw, fh):
    # fw, fh are tensors on the device: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which rounds differently.
    x = px / fw * 2.0 - 1.0
    y = -(py / fh * 2.0 - 1.0)
    cx = x * par[0]
    cy = y * par[0] / par[1]
    dx = cx * par[8] + cy * par[11] + par[14]
    dy = cx * par[9] + cy * par[12] + par[15]
    dz = cx * par[10] + cy * par[13] + par[16]
    n = torch.rsqrt(dx * dx + dy * dy + dz * dz)
    return dx * n, dy * n, dz * n


def _sphere_ts(sph, o, d):
    """Distance of every ray to every sphere, (N, S), +inf where it misses:
    the half-b quadratic. ``o`` and ``d`` are 3-tuples of (N,) planes."""
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    dd = dx * dx + dy * dy + dz * dz
    invdd = 1.0 / dd
    cx, cy, cz, r, act = sph.unbind(1)
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    h = ocx * dx + ocy * dy + ocz * dz
    cq = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    det = h * h - dd * cq
    sq = sqrt_rn(torch.clamp_min(det, 0.0))
    t1 = (-h - sq) * invdd
    t2 = (-h + sq) * invdd
    t = torch.where(t1 >= 0.0, t1, torch.where(t2 >= 0.0, t2, _INF))
    return torch.where((det >= 0.0) & (act > 0.0), t, _INF)


def _triangle_ts(tri, o, d):
    """Distance of every ray to every triangle, (N, T), +inf where it
    misses: Moller-Trumbore."""
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    v0x, v0y, v0z = tri[:, 0], tri[:, 1], tri[:, 2]
    e1x, e1y, e1z = tri[:, 3] - v0x, tri[:, 4] - v0y, tri[:, 5] - v0z
    e2x, e2y, e2z = tri[:, 6] - v0x, tri[:, 7] - v0y, tri[:, 8] - v0z
    rcx = dy * e2z - dz * e2y
    rcy = dz * e2x - dx * e2z
    rcz = dx * e2y - dy * e2x
    tdet = e1x * rcx + e1y * rcy + e1z * rcz
    nonpar = torch.abs(tdet) >= _TRI_EPS
    inv = 1.0 / torch.where(nonpar, tdet, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = inv * (sx * rcx + sy * rcy + sz * rcz)
    scx = sy * e1z - sz * e1y
    scy = sz * e1x - sx * e1z
    scz = sx * e1y - sy * e1x
    v = inv * (dx * scx + dy * scy + dz * scz)
    tt = inv * (e2x * scx + e2y * scy + e2z * scz)
    ok = (nonpar & (u >= _TRI_EPS) & (u <= 1.0) & (v >= _TRI_EPS)
          & (u + v <= 1.0) & (tt >= _TRI_EPS) & (tri[:, 12] > 0.0))
    return torch.where(ok, tt, _INF)


def _closest_hit(sph, sph_m, tri, tri_m, o, d):
    """Closest hit over all spheres, then all triangles; on a tie the first
    object wins (the kernel's sequential strict-< scan). Returns (t, normal,
    material index, whether a sphere won); t is +inf on a miss."""
    best, si = torch.min(_sphere_ts(sph, o, d), dim=1)  # first minimum
    hit = best < _INF
    # Select, then normalize: the winning sphere's normal, computed once.
    # Without a sphere hit the kernel keeps a zero centre and material 0.
    cx, cy, cz = sph[:, 0], sph[:, 1], sph[:, 2]
    ts = torch.where(hit, best, 0.0)
    nx = o[0] + ts * d[0] - torch.where(hit, cx[si], 0.0)
    ny = o[1] + ts * d[1] - torch.where(hit, cy[si], 0.0)
    nz = o[2] + ts * d[2] - torch.where(hit, cz[si], 0.0)
    hn = torch.rsqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, _N_FLOOR))
    nx, ny, nz = nx * hn, ny * hn, nz * hn
    mat = torch.where(hit, sph_m[si], 0)

    tbest, ti = torch.min(_triangle_ts(tri, o, d), dim=1)
    upd = tbest < best  # strict: a sphere wins a tie
    fnx, fny, fnz = tri[ti, 9], tri[ti, 10], tri[ti, 11]
    # Face normal flipped to oppose the ray.
    sgn = torch.where(fnx * d[0] + fny * d[1] + fnz * d[2] < 0.0, 1.0, -1.0)
    best = torch.where(upd, tbest, best)
    nx = torch.where(upd, sgn * fnx, nx)
    ny = torch.where(upd, sgn * fny, ny)
    nz = torch.where(upd, sgn * fnz, nz)
    mat = torch.where(upd, tri_m[ti], mat)
    return best, (nx, ny, nz), mat, hit & ~upd


def _closest_t(sph, tri, o, d):
    """Distance to the closest object, +inf on a miss: the shadow query,
    with the per-object tests of ``_closest_hit`` and no normals."""
    return torch.minimum(_sphere_ts(sph, o, d).min(dim=1).values,
                         _triangle_ts(tri, o, d).min(dim=1).values)


def _fetch_materials(mat_tab, m):
    """Material rows by index; an index outside the table reads as zeros
    with ior 1."""
    n_mat = mat_tab.shape[0]
    valid = (m >= 0) & (m < n_mat)
    rows = mat_tab[m.clamp(0, n_mat - 1).long()]
    default = torch.zeros(9, dtype=rows.dtype, device=rows.device)
    default[8] = 1.0
    return torch.where(valid[:, None], rows, default).unbind(1)


def _shade(hit, mats, o, d, thr, rad, st, sky):
    """One bounce: sky on a miss, emission, albedo, the 3 draws, perturbed
    normal, reflect or refract, offset origin. Dead rays (zero
    throughput) are updated like live ones; all they add is exact zeros.
    Returns the new origin, direction, throughput, radiance and RNG state,
    and the round's events ``(hit, refracted, died)`` as bool masks."""
    best, (nx, ny, nz) = hit[:2]
    dx, dy, dz = d
    tr, tg, tb = thr
    ar, ag, ab = rad
    hitmask = best < _INF
    ar = ar + torch.where(hitmask, 0.0, tr * sky[0])
    ag = ag + torch.where(hitmask, 0.0, tg * sky[1])
    ab = ab + torch.where(hitmask, 0.0, tb * sky[2])
    ts = torch.where(hitmask, best, 0.0)
    px = o[0] + ts * dx
    py = o[1] + ts * dy
    pz = o[2] + ts * dz

    alb_r, alb_g, alb_b, em_r, em_g, em_b, rgh, trn, ior = mats
    ar = ar + torch.where(hitmask, tr * em_r, 0.0)
    ag = ag + torch.where(hitmask, tg * em_g, 0.0)
    ab = ab + torch.where(hitmask, tb * em_b, 0.0)
    tr = torch.where(hitmask, tr * alb_r, 0.0)
    tg = torch.where(hitmask, tg * alb_g, 0.0)
    tb = torch.where(hitmask, tb * alb_b, 0.0)

    st, sph = _rng.unit_sphere(st)
    st, u_branch = _rng.uniform(st)
    sx, sy, sz = sph.unbind(-1)

    wnx = nx + rgh * sx
    wny = ny + rgh * sy
    wnz = nz + rgh * sz
    wn = torch.rsqrt(torch.clamp_min(wnx * wnx + wny * wny + wnz * wnz, _N_FLOOR))
    wnx, wny, wnz = wnx * wn, wny * wn, wnz * wn

    ndot = dx * wnx + dy * wny + dz * wnz
    rfx = dx - 2.0 * ndot * wnx
    rfy = dy - 2.0 * ndot * wny
    rfz = dz - 2.0 * ndot * wnz
    entering = ndot < 0.0
    eta = torch.where(entering, 1.0 / ior, ior)
    rnx = torch.where(entering, wnx, -wnx)
    rny = torch.where(entering, wny, -wny)
    rnz = torch.where(entering, wnz, -wnz)
    ni = rnx * dx + rny * dy + rnz * dz
    k = 1.0 - eta * eta * (1.0 - ni * ni)
    tirm = k < 0.0
    coef = eta * ni + sqrt_rn(torch.where(tirm, 1.0, torch.clamp_min(k, _K_FLOOR)))
    txx = torch.where(tirm, 0.0, eta * dx - coef * rnx)
    txy = torch.where(tirm, 0.0, eta * dy - coef * rny)
    txz = torch.where(tirm, 0.0, eta * dz - coef * rnz)

    choose_refr = u_branch < trn
    ndx = torch.where(choose_refr, txx, rfx)
    ndy = torch.where(choose_refr, txy, rfy)
    ndz = torch.where(choose_refr, txz, rfz)
    # TIR on the refracted branch: the path dies and keeps its direction.
    died = choose_refr & tirm
    tr = torch.where(died, 0.0, tr)
    tg = torch.where(died, 0.0, tg)
    tb = torch.where(died, 0.0, tb)
    ndx = torch.where(died, dx, ndx)
    ndy = torch.where(died, dy, ndy)
    ndz = torch.where(died, dz, ndz)

    offs = _EPS_OFFSET + _EPS_SCALE * sqrt_rn(px * px + py * py + pz * pz)
    side = torch.where(ndx * nx + ndy * ny + ndz * nz >= 0.0, 1.0, -1.0)
    o = (px + offs * side * nx, py + offs * side * ny, pz + offs * side * nz)
    return o, (ndx, ndy, ndz), (tr, tg, tb), (ar, ag, ab), st, (hitmask, choose_refr, died)


def render_kernel_reference(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    sample_offset: int = 0,
    jitter: bool = False,
    count_rounds: bool = False,
    row_start: int = 0,
    rows: int | None = None,
):
    """Plain PyTorch twin of the hand kernel, on the scene's device: the
    same math on (rows*W,) planes, every round run (no early exit), over
    the row block of ``render_kernel``. With ``count_rounds`` it also counts
    the rounds the kernel's threads run: those a path begins with nonzero
    throughput."""
    rows = _check_inputs(scene, camera, height, width, spp, max_bounces, seed, sample_offset,
                         row_start, rows)
    rounds = []
    img = _reference(scene, camera, height, width, spp, max_bounces, seed, sample_offset,
                     jitter, on_sample=(lambda r: rounds.append(r.sum())) if count_rounds else None,
                     row_start=row_start, rows=rows)
    return (img, int(sum(rounds))) if count_rounds else img


def _pixel_grid(height, width, row_start, rows, device):
    """The row block's global pixel indices, int64 (rows*W,), and their
    global rows and columns as float32: what the kernels key the streams
    and the camera rays on."""
    pix = pixel_indices(height, width, device, row_start, rows)
    prow = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    return pix, prow, (pix % width).to(torch.float32)


def _reference(scene, camera, height, width, spp, max_bounces, seed, sample_offset, jitter,
               on_sample=None, row_start=0, rows=None):
    """The twin's image of the row block; ``on_sample``, where given,
    receives each sample's (rows, W) int64 rounds of every pixel."""
    device = scene.device
    rows = height if rows is None else rows
    sph, sph_m, tri, tri_m, mat_tab = _scene_operands(scene)
    par = _camera_params(camera, scene, height, width)
    sky = (par[2], par[3], par[4])
    n = rows * width
    pix, prow, cols = _pixel_grid(height, width, row_start, rows, device)
    fw, fh = (torch.tensor(float(v), device=device) for v in (width, height))
    pd = _camera_dir(par, cols + 0.5, prow + 0.5, fw, fh)
    origin = tuple(par[i].expand(n) for i in (5, 6, 7))
    zero = torch.zeros(n, dtype=torch.float32, device=device)
    one = torch.ones(n, dtype=torch.float32, device=device)

    acc = (zero, zero, zero)
    for s in range(spp):
        st = _rng.seed_state(pix, s + sample_offset, seed)
        d = pd
        if jitter:
            st, jx = _rng.uniform(st)
            st, jy = _rng.uniform(st)
            d = _camera_dir(par, cols + jx, prow + jy, fw, fh)
        o, thr, rad = origin, (one, one, one), (zero, zero, zero)
        pixel_rounds = torch.zeros(n, dtype=torch.int64, device=device)
        for _ in range(max_bounces + 1):
            if on_sample is not None:
                # A miss and a death by total internal reflection zero the
                # throughput too, so this is the kernel's one exit test.
                pixel_rounds = pixel_rounds + ((thr[0] != 0.0) | (thr[1] != 0.0)
                                               | (thr[2] != 0.0))
            hit = _closest_hit(sph, sph_m, tri, tri_m, o, d)
            mats = _fetch_materials(mat_tab, hit[2])
            o, d, thr, rad, st, _ = _shade(hit, mats, o, d, thr, rad, st, sky)
        acc = tuple(a + (r + t * k) for a, r, t, k in zip(acc, rad, thr, sky))
        if on_sample is not None:
            on_sample(pixel_rounds.reshape(rows, width))
    inv = _f32(1.0 / spp)
    return torch.stack([a * inv for a in acc], dim=-1).reshape(rows, width, 3)
