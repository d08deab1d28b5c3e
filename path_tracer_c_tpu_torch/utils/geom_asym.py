"""The geometry gradient's cost, fused against eager, at one shape on one
scene.

Counterpart of the JAX package's ``scripts/geom_asym_bench.py``. Both sides
take the gradient of one pixel loss (the mean squared error against a
physical-kernel render, B3) with respect to every floating-point leaf of
the scene, as ``jax.grad(..., allow_int=True)`` does:

- fused: through ``ops/render_physical_grad.render_physical_kernel_vjp``
  with the emitter-geometry planes on (``geom=True``, the cap at the live
  emitter count): kernel B4 and its planes' contraction;
- eager: through ``models/physical.render_physical(..., remat=True)`` under
  autograd, each sample recomputed in backward.

Jitter is at both functions' defaults, as the JAX script leaves it. The
leaves the fused side leaves at zero by contract (camera, IOR,
metallicity, geometry that is no emitter) make the two gradients differ,
so they are not compared, as the JAX script does not compare them.

``geom_asym`` measures the JAX script's shape on glossy, its triangle-lit
scene's fused gradient with ``tri_nee`` at the headline shape, and both
sides at the headline shape with each side's peak device memory.
``scripts/torch_geom_asym_bench.py`` prints its line.
"""

from __future__ import annotations

import dataclasses

import torch

from ..grad.diff import _float_leaves, mse_loss
from ..models.physical import render_physical
from ..ops.camera import Camera
from ..ops.render_grad import replace_leaves
from ..ops.render_physical import (
    live_emitter_count, live_tri_emitter_count, render_physical_kernel,
)
from ..ops.render_physical_grad import render_physical_kernel_vjp
from ..scene import demo
from ..scene.scene import Scene
from .metrics import rays_per_render, shape_name
from .profiling import card_line, time_fn

__all__ = ["tri_lit_scene", "fused_grad", "eager_grad", "geom_asym", "SHAPE", "HEADLINE",
           "SMALL_HEADLINE"]

# (height, width, spp, bounces): the JAX script's shape for both sides
# (scripts/geom_asym_bench.py:51-52), its triangle-lit headline (:111-112)
# and that headline's stand-in off the TPU (:113-115).
SHAPE = (256, 256, 16, 4)
HEADLINE = (1024, 1024, 64, 8)
SMALL_HEADLINE = (256, 256, 8, 4)


def tri_lit_scene(device) -> Scene:
    """Glossy with a ceiling quad lamp: one lamp material appended (a copy
    of the last material with albedo 0, emission (1, 0.9, 0.7) x 18,
    transparency 0, roughness 1) and two triangles on it, as the JAX script
    builds it (``scripts/geom_asym_bench.py:119-152``)."""
    scene = demo.glossy_scene(device)
    mats, tri = scene.materials, scene.triangles
    lamp = scene.num_materials
    grow = {f.name: torch.cat([getattr(mats, f.name), getattr(mats, f.name)[-1:]])
            for f in dataclasses.fields(mats)}
    grow["albedo"][lamp] = 0.0
    grow["emission_color"][lamp] = torch.tensor([1.0, 0.9, 0.7], device=device)
    grow["emission_strength"][lamp] = 18.0
    grow["transparency"][lamp] = 0.0
    grow["roughness"][lamp] = 1.0
    verts = lambda rows: torch.tensor(rows, dtype=torch.float32, device=device)
    triangles = dataclasses.replace(
        tri,
        v0=torch.cat([tri.v0, verts([[-1.5, 4.0, 5.0], [-1.5, 4.0, 7.0]])]),
        v1=torch.cat([tri.v1, verts([[1.5, 4.0, 5.0], [1.5, 4.0, 7.0]])]),
        v2=torch.cat([tri.v2, verts([[1.5, 4.0, 7.0], [-1.5, 4.0, 5.0]])]),
        material=torch.cat([tri.material, torch.full((2,), lamp, dtype=torch.int32,
                                                     device=device)]),
        active=torch.cat([tri.active, torch.ones(2, dtype=torch.bool, device=device)]),
    )
    return dataclasses.replace(scene, materials=dataclasses.replace(mats, **grow),
                               triangles=triangles)


def _grad_fn(render, scene: Scene, target):
    """``fn(seed)``: the gradient of ``mse_loss(render(live, seed), target)``
    with respect to every floating-point leaf of ``scene`` (``None`` where
    the loss does not reach a leaf)."""
    names = _float_leaves(scene)

    def fn(seed):
        leaves = [t.detach().requires_grad_() for _, _, t in names]
        live = replace_leaves(scene, [(tb, nm, t) for (tb, nm, _), t in zip(names, leaves)])
        return list(torch.autograd.grad(mse_loss(render(live, seed), target), leaves,
                                        allow_unused=True))

    return fn


def fused_grad(scene: Scene, camera: Camera, shape, target, tri_nee: bool = False):
    """The fused side: ``fn(seed)`` of the gradient through B4 with its
    geometry planes, the caps at the live emitter counts (read once here:
    each count waits for the device)."""
    kw = dict(geom=True, n_em_cap=live_emitter_count(scene))
    if tri_nee:
        kw.update(tri_nee=True, tri_em_cap=live_tri_emitter_count(scene))
    return _grad_fn(lambda live, seed: render_physical_kernel_vjp(
        live, camera, *shape, seed, **kw), scene, target)


def eager_grad(scene: Scene, camera: Camera, shape, target):
    """The eager side: ``fn(seed)`` of the gradient through the eager
    physical tier, each sample recomputed in backward."""
    return _grad_fn(lambda live, seed: render_physical(live, camera, *shape, seed, remat=True),
                    scene, target)


def _side(fn, device, seeds, warm=(100,)) -> dict:
    """The median seconds of a side over ``seeds`` after a warm-up call at
    each seed of ``warm``, and its peak device memory in bytes (from a
    reset before the warm-up calls to after the timed calls; ``None`` on
    the CPU)."""
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    seconds = time_fn(fn, warmup=len(warm), iters=len(seeds), seeds=(*warm, *seeds),
                      device=device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    return {"seconds": seconds, "peak_bytes": peak}


def _finite(grads) -> bool:
    return all(bool(torch.isfinite(g).all()) for g in grads if g is not None)


def geom_asym(device, shape=SHAPE, tri_shape=HEADLINE, pair_shape=HEADLINE,
              reps: int = 3, pair_eager_reps: int | None = None, log=lambda msg: None) -> dict:
    """The JAX script's line, then the pair at ``pair_shape``:

    - ``shape`` on glossy: the fused and the eager side (target: B3 at seed
      99), their ratio, each side's peak device memory;
    - ``tri_shape`` on ``tri_lit_scene``: the fused side with ``tri_nee``
      and both caps at the live counts (target: B3 with ``tri_nee`` at seed
      77);
    - ``pair_shape`` on glossy: both sides again, each with its peak device
      memory. Where the eager side runs out of device memory there, the
      line records that outcome with the allocator's message (the bytes it
      asked for), and no time.

    Each time is the median of ``reps`` calls after a warm-up call (seeds
    as the JAX script's: warm-up 100, then 1.. or, triangle-lit, 31..);
    ``pair_eager_reps`` (default ``reps``), where it is given, sets the
    eager side's calls at ``pair_shape``, and 1 takes one call, at seed 1,
    with no warm-up (that side builds no kernel).
    ``fused_grads_finite``: every leaf of each fused gradient is finite.
    ``log(msg)`` hears each side's time as it is taken.
    """
    device = torch.device(device)
    cam = Camera.reference(device)
    glossy = demo.glossy_scene(device)
    seeds = tuple(range(1, reps + 1))

    def target(scene, shp, seed, **kw):
        return render_physical_kernel(scene, cam, *shp, seed, **kw)

    finite = True

    def fused(scene, shp, tgt, seeds, **kw):
        nonlocal finite
        fn = fused_grad(scene, cam, shp, tgt, **kw)
        side = _side(fn, device, seeds)
        finite = finite and _finite(fn(seeds[0]))
        return side

    t = target(glossy, shape, 99)
    f1 = fused(glossy, shape, t, seeds)
    log(f"fused {shape_name(shape)}: {f1['seconds']:.4f} s")
    e1 = _side(eager_grad(glossy, cam, shape, t), device, seeds)
    log(f"eager {shape_name(shape)}: {e1['seconds']:.4f} s")
    rays = rays_per_render(*shape)

    tri = tri_lit_scene(device)
    n_em_s, n_em_t = live_emitter_count(tri), live_tri_emitter_count(tri)
    t = target(tri, tri_shape, 77, tri_nee=True)
    f2 = fused(tri, tri_shape, t, tuple(range(31, 31 + reps)), tri_nee=True)
    log(f"fused triangle-lit {shape_name(tri_shape)}: {f2['seconds']:.4f} s")
    rays_t = rays_per_render(*tri_shape)

    t = target(glossy, pair_shape, 99)
    f3 = fused(glossy, pair_shape, t, seeds)
    log(f"fused {shape_name(pair_shape)}: {f3['seconds']:.4f} s")
    rays_p = rays_per_render(*pair_shape)
    e_reps = reps if pair_eager_reps is None else pair_eager_reps
    try:
        e3 = _side(eager_grad(glossy, cam, pair_shape, t), device,
                   tuple(range(1, e_reps + 1)), warm=(100,) if e_reps > 1 else ())
        e3["outcome"], e3["oom_message"] = "ok", None
    except torch.cuda.OutOfMemoryError as err:
        e3 = {"seconds": None, "peak_bytes": torch.cuda.max_memory_allocated(device),
              "outcome": "out_of_memory", "oom_message": str(err)}
    log(f"eager {shape_name(pair_shape)}: {e3['outcome']}, {e3['seconds']} s")

    n_em = live_emitter_count(glossy)
    per_sec = lambda r, side: None if side["seconds"] is None else r / side["seconds"]
    return {
        "workload": f"{shape_name(shape)} glossy ({n_em} emitter)",
        "fused_geom_seconds": f1["seconds"],
        "fused_geom_rays_per_sec": per_sec(rays, f1),
        "core_ad_seconds": e1["seconds"],
        "core_ad_rays_per_sec": per_sec(rays, e1),
        "ratio": e1["seconds"] / f1["seconds"],
        "rays_nominal": rays,
        "tri_workload": f"{shape_name(tri_shape)} glossy+quad-lamp "
                        f"({n_em_s} sph + {n_em_t} tri emitters)",
        "tri_geom_fused_seconds": f2["seconds"],
        "tri_geom_fused_rays_per_sec": per_sec(rays_t, f2),
        "backend": device.type,
        "fused_geom_peak_bytes": f1["peak_bytes"],
        "core_ad_peak_bytes": e1["peak_bytes"],
        "tri_geom_fused_peak_bytes": f2["peak_bytes"],
        "pair_workload": f"{shape_name(pair_shape)} glossy ({n_em} emitter)",
        "pair_rays_nominal": rays_p,
        "pair_fused_geom_seconds": f3["seconds"],
        "pair_fused_geom_rays_per_sec": per_sec(rays_p, f3),
        "pair_fused_geom_peak_bytes": f3["peak_bytes"],
        "pair_core_ad_outcome": e3["outcome"],
        "pair_core_ad_seconds": e3["seconds"],
        "pair_core_ad_rays_per_sec": per_sec(rays_p, e3),
        "pair_core_ad_peak_bytes": e3["peak_bytes"],
        "pair_core_ad_oom_message": e3["oom_message"],
        "pair_ratio": None if e3["seconds"] is None else e3["seconds"] / f3["seconds"],
        "fused_grads_finite": finite,
        "reps": reps,
        "pair_core_ad_reps": e_reps,
        "device": str(device),
        "card": card_line(device),
    }
