"""The capacity sweep: B1's and B3's throughput against scene size, across
the shared-table budget.

Counterpart of the JAX package's ``scripts/capacity_sweep.py``: the forward
kernel (B1, ``ops/render_kernel.render_kernel``) and the physical kernel
(B3, ``ops/render_physical.render_physical_kernel``), each as a user calls
it, against sphere count with four materials and against material count
with sixteen spheres, so that the intersection scan (O(spheres)) and the
material table (O(materials)) are each measured alone. Besides the JAX
script's points the sweep takes 1024, 1536 and 2048, which straddle the
shared-table budget (``render_kernel.SHARED_TABLE_BUDGET``, 48 KB): below it
a block stages the scene's tables into shared memory, above it the kernels
read them from device memory. Where the tables fit, each kernel is timed
beside its ``global_tables`` measurement instantiation (the same body,
tables in device memory): the difference is what the shared placement buys
at that size. Each kernel is also timed alone, launched on operands packed
once (``packed_launcher``), so that the share of the operand packing shows.

``scripts/torch_capacity_sweep.py`` prints ``sweep``'s lines.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import render_kernel as rk
from ..ops import render_physical as rp
from ..ops.camera import Camera
from ..scene.scene import Scene, SceneBuilder
from .metrics import rays_per_render, shape_name
from .profiling import card_line, time_fn

__all__ = ["build_scene", "sweep_scene", "measure_point", "sweep", "POINTS",
           "SWEEPS", "SHAPE", "SMALL_SHAPE"]

# The JAX script's points (scripts/capacity_sweep.py:103), then three that
# straddle the shared-table budget.
POINTS = (5, 15, 64, 200, 1024, 1536, 2048)
SWEEPS = ("spheres", "materials")
# (height, width, spp, bounces): the JAX script's TPU shape (:82-85) and its
# shape elsewhere (:86-88), which runs one repetition.
SHAPE = (512, 512, 16, 4)
SMALL_SHAPE = (64, 64, 1, 2)


def build_scene(n_sph: int, n_mat: int, device, seed: int = 0) -> Scene:
    """``n_sph`` spheres (a large emissive one and a grid) and two ground
    triangles, cycling over ``n_mat`` materials plus the ground's: a copy of
    the JAX script's ``build_scene`` (``scripts/capacity_sweep.py:27-61``),
    the same draws in the same order. Every material slot costs table work
    whether a sphere uses it or not."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(sky_color=(0.5, 0.6, 0.8))
    mats = []
    for i in range(n_mat):
        emissive = i == 0
        mats.append(b.add_material(
            albedo=tuple(rng.uniform(0.2, 0.9, size=3)),
            roughness=float(i % 4) / 4.0,
            emission_color=(1.0, 0.95, 0.8) if emissive else (0, 0, 0),
            emission_strength=20.0 if emissive else 0.0,
        ))
    ground = b.add_material(albedo=(0.4, 0.4, 0.42), roughness=0.9)
    b.add_triangle(v0=(-200, -1, -200), v1=(200, -1, -200), v2=(200, -1, 200), material=ground)
    b.add_triangle(v0=(-200, -1, -200), v1=(-200, -1, 200), v2=(200, -1, 200), material=ground)
    b.add_sphere(center=(60.0, 80.0, 40.0), radius=30.0, material=mats[0])
    grid = int(np.ceil(np.sqrt(max(n_sph - 1, 1))))
    for i in range(n_sph - 1):
        x = (i % grid - (grid - 1) / 2) * 2.2
        z = 5.0 + (i // grid) * 2.5
        b.add_sphere(center=(x, 0.0, z), radius=0.9,
                     material=mats[1 + i % max(n_mat - 1, 1)] if n_mat > 1 else mats[0])
    return b.build(device)


def sweep_scene(sweep_name: str, n: int, device) -> Scene:
    """The scene of point ``n`` of a sweep: ``n`` spheres and four materials,
    or sixteen spheres and ``n`` materials."""
    if sweep_name == "spheres":
        return build_scene(n, 4, device)
    if sweep_name == "materials":
        return build_scene(16, n, device)
    raise ValueError(f"unknown sweep {sweep_name!r}; one of {', '.join(SWEEPS)}")


def measure_point(sweep_name: str, n: int, device, shape=SHAPE, reps: int = 3,
                  card: str | None = None) -> dict:
    """One point of a sweep: the JAX script's line (``sweep``, ``n``, the
    scene's counts, each kernel's median seconds as called and nominal
    rays/s, ``shape``), then each kernel's table bytes and placement
    (``shared`` or ``global``, ``render_kernel.tables_in_shared``), its
    seconds alone on operands packed once (``packed_launcher``), where the
    tables fit the seconds of its ``global_tables`` instantiation as called,
    and the device and card. The instantiations and the packed launches
    exist on the card only: on the CPU those fields are ``None``."""
    device = torch.device(device)
    scene = sweep_scene(sweep_name, n, device)
    cam = Camera.reference(device)
    h, w, spp, bounces = shape
    seeds = tuple(range(1, reps + 1))
    rays = rays_per_render(h, w, spp, bounces)
    fwd = lambda s: rk.render_kernel(scene, cam, h, w, spp, bounces, s)
    phys = lambda s: rp.render_physical_kernel(scene, cam, h, w, spp, bounces, s)
    timed = lambda fn: time_fn(fn, iters=reps, seeds=(99, *seeds), device=device)
    fwd_s, phys_s = timed(fwd), timed(phys)
    line = {
        "sweep": sweep_name, "n": n,
        "n_spheres": scene.num_spheres, "n_materials": scene.num_materials,
        "fwd_seconds": fwd_s, "fwd_rays_per_sec": rays / fwd_s,
        "physical_seconds": phys_s, "physical_rays_per_sec": rays / phys_s,
        "shape": shape_name(shape),
        "shared_table_budget": rk.SHARED_TABLE_BUDGET,
    }
    on_card = device.type == "cuda"
    for key, physical, mod, variant in (
            ("fwd", False, rk, rk.render_kernel_variant),
            ("physical", True, rp, rp.render_physical_kernel_variant)):
        shared = rk.tables_in_shared(scene, physical)
        alone_s = global_s = None
        if on_card:
            alone_s = timed(mod.packed_launcher(scene, cam, h, w, spp, bounces))
            if shared:
                global_s = timed(
                    lambda s: variant(scene, cam, h, w, spp, bounces, s, "global_tables"))
        line.update({
            f"{key}_table_bytes": rk.table_bytes(scene, physical),
            f"{key}_tables": "shared" if shared else "global",
            f"{key}_alone_seconds": alone_s,
            f"{key}_global_tables_seconds": global_s,
        })
    line.update(device=str(device), card=card if card is not None else card_line(device))
    return line


def sweep(device, shape=SHAPE, reps: int = 3, points=POINTS, sweeps=SWEEPS):
    """``measure_point``'s line for every point of every sweep, in the JAX
    script's order (spheres, then materials)."""
    card = card_line(device)
    for sweep_name in sweeps:
        for n in points:
            yield measure_point(sweep_name, n, device, shape, reps, card)
