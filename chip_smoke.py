#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), and PyTorch's name
   for it. No CUDA device is a failure.
2. build: compile the CUDA sources of ``path_tracer_c_tpu_torch/csrc`` with
   nvcc (``ops/build.py``); print the build time and what ptxas says of
   every kernel (registers, stack frame, spills).
3. forward kernel against its plain twin: ``render_kernel`` on the card
   against ``render_kernel_reference`` on the card, for three scenes at a
   size with a ragged edge, with jitter off and on and a nonzero sample
   offset, at the main path's shape, and once against the twin on the CPU.
4. the forward main path: the CLI ``render`` at 1024x1024, 64 spp, 8
   bounces on the glossy scene. The kernel's launch count must grow; the
   BMP is decoded and checked.
5. fused kernel against its plain twin: ``render_fused``'s image must equal
   ``render_kernel``'s bit for bit and its Jacobian must equal
   ``render_fused_reference``'s, value for value, on the three scenes, a
   mixed scene (emission, glass, diffuse) and a scene whose only material
   is exactly black, and at the shapes of both gradient main paths (glossy
   at 1024x1024; the 33 materials of the fit's configuration at its own
   size). ``count_rounds`` of both kernels must equal their twins'.
6. the gradient against autograd: ``render_kernel_vjp`` + ``backward`` on
   the card against ``torch.autograd`` through the eager integrator.
7. the gradient main path: ``loss_and_grad(engine="cuda")`` on the glossy
   scene at 1024x1024, 64 spp, 8 bounces, then the CLI ``fit`` on
   ``configs/config4_inverse_spheres32.json``; every step must go through
   the fused kernel and the loss must fall.
8. physical kernel against its plain twin: ``render_physical_kernel`` on
   the card against ``render_physical_kernel_reference`` on the card at a
   ragged size on cornell, glossy, a scene with no emitter and a scene lit
   by triangles and a sphere with ``tri_nee`` on, with next-event
   estimation off, jitter off and a nonzero sample offset, and at the main
   shape; the counted events (rounds, diffuse vertices, light samples,
   shadow scans) must equal the twin's; once against the twin on the CPU.
   The twin runs every round of every path, so agreement shows that what
   the kernel skips adds exact zeros.
9. the physical main path: the CLI ``render --config
   configs/config3_glossy_1024.json`` (glossy, 1024x1024, 64 spp, 8
   bounces, engine "physical"). The kernel's launch count must grow; the
   BMP is decoded and checked.
10. fused physical kernel against its plain twin: ``render_physical_fused``'s
   image must equal ``render_physical_kernel``'s and its twin's bit for bit,
   and every plane of its three families (materials and sky, sphere-emitter
   geometry, triangle-emitter vertices) its twin's value for value, on
   cornell, glossy, the mixed and black scenes and the triangle-and-sphere-lit
   scene, with next-event estimation off, jitter on and off, a sample offset,
   ``rough_grad``, caps below, at and above the live emitter counts; the
   counted rounds and valid light samples must equal the twin's.
11. two-pass kernel against its plain twin and against the fused kernel's
   contraction, at the tolerance stated at ``BWD_RTOL``; then
   ``render_physical_kernel_vjp`` + ``backward`` against ``torch.autograd``
   through the eager physical tier.
12. the physical gradient's main path at full width (glossy, 1024x1024, 64
   spp, 8 bounces): ``loss_and_grad(engine="physical_pallas")`` (no geometry
   planes), ``render_physical_kernel_vjp`` with jitter on and the emitter cap
   at the scene's live emitter count plus ``backward``, and
   ``render_physical_bwd`` once; both kernels against their twins at that
   shape; then the CLI ``fit --mode geometry``, ``fit --mode roughness`` and
   ``fit``, each with ``--engine physical_pallas``, on a small scene and
   configs the script writes: every step must go through the fused kernel,
   the loss must fall, and the printed error of the geometry and roughness
   fits must end below the start's.
13. times: the five kernels, the contractions, the twins and one fit step,
   with CUDA events, and each kernel's bound from this run's executed
   rounds and events.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Statistical tolerance of the JAX suite's kernel-against-core check
# (tests/test_pallas.py). On the card the kernel is built to round as its
# twin does and the two agree bit for bit (the "exact" share printed), but
# the pass criterion is this tolerance: the twin on the CPU rounds rsqrt
# differently, and a float32 difference can now and then flip a chaotic
# path at a silhouette.
Q999_TOL = 1e-4
MEAN_TOL = 1e-5
# The fused kernel's image and Jacobian against its twin's: tolerance 0.
# Both call one definition of the arithmetic, are built without FMA
# contraction and add in the same order (samples ascending, the path's end
# first, bounces descending), so every value of every plane must be equal.
# The gradient against autograd through the eager integrator: the JAX
# suite's tolerance for the same comparison (tests/test_pallas_grad.py).
# The eager integrator takes other roots and normalisations than the
# kernel, so a grazing path may flip.
GRAD_RTOL, GRAD_ATOL = 5e-3, 2e-5
# The physical kernel against its twin: the JAX suite's criterion for its
# physical kernel against the core path (tests/test_pallas_physical.py): the
# 0.99-quantile of |delta| below 1e-4, the share of |delta| > 1e-3 below 1%,
# the image means within 2e-3. On the card the two agree bit for bit (the
# "exact" share printed); the CPU twin rounds rsqrt differently, and a
# shadow ray at a cone's rim can then flip.
PHYS_Q99_TOL, PHYS_FLIP_SHARE, PHYS_MEAN_TOL = 1e-4, 0.01, 2e-3
PHYS_CONFIG = "configs/config3_glossy_1024.json"
# The main paths' shape: the glossy scene at 1024^2, 64 spp, 8 bounces.
H = W = 1024
SPP, BOUNCES = 64, 8
FIT_CONFIG = "configs/config4_inverse_spheres32.json"

# Published peaks of one H100 SXM (NVIDIA's data sheet): 67 TFLOP/s float32
# outside the tensor cores, counting a fused multiply-add as two, and
# 3.35 TB/s of device memory. The kernels are built with -fmad=false, so a
# multiply and an add issue separately and half that rate is their ceiling;
# the bound below is still stated against the published figure.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Float32 operations counted from csrc/pt_common.cuh and
# csrc/render_fused.cu, each add, multiply, compare, max, divide, root as
# one (integer RNG work is left out): one sphere test, one triangle test,
# the rest of closest_hit, one call of shade(), one swept hit.
OPS_SPHERE, OPS_TRIANGLE, OPS_HIT_REST, OPS_SHADE, OPS_SWEEP = 29, 61, 25, 138, 24
# The physical kernel (csrc/render_phys.cu), counted the same way: what
# every hit round does (Le, the 7 draws' conversions, the hit point, the
# offset, albedo, the next origin, the exit test); the new direction of a
# diffuse vertex (cosine-weighted: two roots, sincos_2pi, the basis) and of
# any other (the mirror, the cheapest: a refraction costs more); one light
# sample of a sphere up to its tests (cone, basis, the full-b distance);
# and what a shadow scan adds to the per-object tests (the ray's d.d, one
# min per object, the visibility compare).
OPS_PHYS_HIT, OPS_PHYS_DIFFUSE, OPS_PHYS_MIRROR, OPS_PHYS_LIGHT, OPS_PHYS_SHADOW_REST = (
    54, 65, 9, 139, 10)
# The physical gradient kernels (csrc/render_phys_fused.cu,
# csrc/render_phys_bwd.cu, csrc/pt_phys.cuh), counted the same way. The fused
# kernel: one swept hit (the suffix, the albedo, emission and transparency
# planes' weights and adds, the carry), what a valid light sample adds to it
# (nee and emw and the emitter's three adds), what rough_grad adds (drg, three
# products, three adds); the cone chain's adjoint (69 forward, 111 back; the
# triangle chain's is 72 and 111) and the 12 products and adds into the
# planes with the closure's 9. The two-pass kernel: one swept hit with its
# cotangent terms, what a valid light sample adds, and the geometry term
# beside the adjoint.
OPS_PF_SWEEP, OPS_PF_SWEEP_VALID, OPS_PF_SWEEP_ROUGH = 27, 18, 9
OPS_CONE_ADJOINT, OPS_PF_GEO_PLANES = 180, 33
OPS_PB_SWEEP, OPS_PB_SWEEP_VALID, OPS_PB_GEO = 43, 27, 20
# The two-pass kernel reduces with float atomics in an order that changes
# from run to run; its twin reduces in float64. Both, and the fused kernel's
# contraction (float32 matrix-vector products), are held together at the JAX
# suite's gate between its two schemes: rtol 2e-4, with an absolute floor of
# 1e-6 of the leaf's largest entry.
BWD_RTOL, BWD_ATOL_SCALE = 2e-4, 1e-6
# The physical gradient against autograd through the eager physical tier:
# the JAX suite's gates for the same comparison (rtol 5e-3, atol 3e-5; the
# black light's geometry rtol 5e-3 with a floor of 1e-4 of its largest entry).
PHYS_GRAD_RTOL, PHYS_GRAD_ATOL = 5e-3, 3e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def compare(a, b, what: str) -> dict:
    """|a - b| statistics; raises unless within Q999_TOL and MEAN_TOL."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"{what}: shapes {a.shape}/{b.shape}")
    err = (a.detach().double() - b.detach().double()).abs().flatten()
    if not torch.isfinite(err).all():
        raise AssertionError(f"{what}: non-finite values")
    # torch.quantile takes at most 2^24 values: the 0.999-quantile by rank.
    k = max(int(0.999 * (err.numel() - 1)), 0)
    stats = {
        "q999": float(torch.kthvalue(err, k + 1).values),
        "mean": float(err.mean()),
        "max": float(err.max()),
        "exact": float((err == 0).double().mean()),
    }
    log(f"  {what}: q999 {stats['q999']:.3g} mean {stats['mean']:.3g} "
        f"max {stats['max']:.3g} exact {stats['exact']:.6f}")
    if not (stats["q999"] < Q999_TOL and stats["mean"] < MEAN_TOL):
        raise AssertionError(
            f"{what}: outside tolerance (q999 < {Q999_TOL}, mean < {MEAN_TOL})"
        )
    return stats


def compare_exact(a, b, what: str) -> float:
    """The largest |a - b|, logged with the share of equal values; raises
    unless every value is equal."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"{what}: shapes {a.shape}/{b.shape}")
    err = (a - b).abs()
    worst, exact = float(err.max()), float((err == 0).double().mean())
    log(f"  {what}: max |delta| {worst:.3g} exact {exact:.6f}")
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: differs from the plain twin's")
    return worst


def compare_physical(a, b, what: str) -> dict:
    """|a - b| statistics; raises unless within the physical tolerance."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"{what}: shapes {a.shape}/{b.shape}")
    err = (a.double() - b.double()).abs().flatten()
    if not torch.isfinite(err).all():
        raise AssertionError(f"{what}: non-finite values")
    k = max(int(0.99 * (err.numel() - 1)), 0)
    stats = {
        "q99": float(torch.kthvalue(err, k + 1).values),
        "flips": float((err > 1e-3).double().mean()),
        "dmean": abs(float(a.double().mean()) - float(b.double().mean())),
        "max": float(err.max()),
        "exact": float((err == 0).double().mean()),
    }
    log(f"  {what}: q99 {stats['q99']:.3g} share>1e-3 {stats['flips']:.3g} "
        f"max {stats['max']:.3g} exact {stats['exact']:.6f}")
    if not (stats["q99"] < PHYS_Q99_TOL and stats["flips"] < PHYS_FLIP_SHARE
            and stats["dmean"] < PHYS_MEAN_TOL):
        raise AssertionError(f"{what}: outside the physical tolerance")
    return stats


def time_cuda(fn, seeds) -> list[float]:
    """Milliseconds of each call, by CUDA events, one call per seed."""
    import torch

    times = []
    for seed in seeds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(seed)
        end.record()
        torch.cuda.synchronize()
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            raise AssertionError("non-finite values in a timed run")
        del out, outs
        times.append(start.elapsed_time(end))
    return times


def median_ms(fn, warm=(100,), seeds=(1, 2, 3)) -> float:
    time_cuda(fn, warm)
    return statistics.median(time_cuda(fn, seeds))


def test_scenes(pt, dev):
    """The mixed scene (emission, partial transparency with total internal
    reflection, diffuse bounces, sky misses) and the scene whose camera
    sits inside an exactly black sphere."""
    b = pt.SceneBuilder(sky_color=(0.2, 0.3, 0.5))
    b.add_material(albedo=(0.9, 0.8, 0.7), roughness=0.4,
                   emission_color=(1.0, 0.8, 0.6), emission_strength=3.0)
    glassy = b.add_material(albedo=(0.9, 0.95, 1.0), roughness=0.1,
                            transparency=0.5, refractive_index=1.4)
    diffuse = b.add_material(albedo=(0.6, 0.3, 0.2), roughness=1.0)
    b.add_sphere(center=(0, 2.5, 6), radius=1.5, material=0)
    b.add_sphere(center=(0.5, -0.2, 4), radius=1.0, material=glassy)
    b.add_triangle(v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50), material=diffuse)
    b.add_triangle(v0=(-50, -1, -50), v1=(-50, -1, 50), v2=(50, -1, 50), material=diffuse)
    mixed = b.build(dev)
    b = pt.SceneBuilder(sky_color=(0.8, 0.6, 0.4))
    black = b.add_material(albedo=(0.0, 0.0, 0.0), roughness=0.7,
                           emission_color=(1.0, 0.9, 0.8), emission_strength=0.5)
    b.add_sphere(center=(0.0, 0.0, 0.0), radius=5.0, material=black)
    return {"mixed_scene": mixed, "black_albedo_scene": b.build(dev)}


def tri_light_scene(pt, dev):
    """A triangle ceiling light, a sphere light and diffuse content: the
    mixed emitter pool of tests/test_pallas_physical.py."""
    b = pt.SceneBuilder(sky_color=(0.01, 0.01, 0.02))
    ground = b.add_material(albedo=(0.6, 0.55, 0.5), roughness=1.0)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.9, 0.7),
                          emission_strength=20.0)
    slamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(0.8, 0.9, 1.0),
                           emission_strength=8.0)
    ball = b.add_material(albedo=(0.7, 0.3, 0.3), roughness=1.0)
    b.add_triangle(v0=(-40, -1, -40), v1=(40, -1, -40), v2=(40, -1, 40), material=ground)
    b.add_triangle(v0=(-40, -1, -40), v1=(-40, -1, 40), v2=(40, -1, 40), material=ground)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(1.0, 3.0, 4.0), v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(-1.0, 3.0, 6.0), v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_sphere(center=(0.0, -0.3, 5.0), radius=0.7, material=ball)
    b.add_sphere(center=(2.0, 2.0, 3.5), radius=0.4, material=slamp)
    return b.build(dev)


def check_bmp(data: bytes, width: int, height: int) -> None:
    """Decode a 24-bit BMP's header and look at its pixels."""
    if data[:2] != b"BM" or len(data) != 54 + 3 * width * height:
        raise AssertionError(f"BMP: bad magic or size {len(data)}")
    size, _, offset = struct.unpack("<III", data[2:14])
    bw, bh, _, bpp = struct.unpack("<iiHH", data[18:30])
    if (size, offset, bw, bh, bpp) != (len(data), 54, width, height, 24):
        raise AssertionError(f"BMP header {(size, offset, bw, bh, bpp)}")
    pixels = data[54:]
    if len(set(pixels)) < 2 or not any(pixels):
        raise AssertionError("BMP pixels are all equal or all zero")


def bound_ms(scene, height, width, spp, rounds, fused: bool):
    """The least time the card could take: the larger of bytes over the
    memory rate (inputs read once, outputs written once) and float32
    operations over the peak rate, for the rounds this run executed. Every
    sample has at most one miss round, so at least ``rounds - H W spp``
    rounds shade (and, in the fused kernel, are swept as hits)."""
    hit_rounds = max(rounds - height * width * spp, 0)
    ops = rounds * (scene.num_spheres * OPS_SPHERE + scene.num_triangles * OPS_TRIANGLE
                    + OPS_HIT_REST) + hit_rounds * OPS_SHADE
    tables = 4 * (6 * scene.num_spheres + 14 * scene.num_triangles
                  + 9 * scene.num_materials + 17)
    nbytes = tables + 12 * height * width
    if fused:
        ops += hit_rounds * OPS_SWEEP
        nbytes += 4 * (9 * scene.num_materials + 3) * height * width
    return bound_of(ops, nbytes)


def physical_ops(scene, height, width, spp, events) -> float:
    """Float32 operations of the physical kernel's forward rounds: every
    round scans the scene once, at least ``rounds - H W spp`` rounds hit and
    shade, a diffuse vertex takes the cosine-weighted direction and any other
    at least the mirror's, and the light samples and shadow scans are those
    this run's data asked for (``count_events``)."""
    scan = scene.num_spheres * OPS_SPHERE + scene.num_triangles * OPS_TRIANGLE
    hit_rounds = max(events["rounds"] - height * width * spp, 0)
    diffuse = events["diffuse_vertices"]
    return (events["rounds"] * (scan + OPS_HIT_REST) + hit_rounds * OPS_PHYS_HIT
            + diffuse * OPS_PHYS_DIFFUSE + max(hit_rounds - diffuse, 0) * OPS_PHYS_MIRROR
            + events["light_samples"] * OPS_PHYS_LIGHT
            + events["shadow_scans"] * (scan + scene.num_spheres + scene.num_triangles
                                        + OPS_PHYS_SHADOW_REST))


def bound_of(ops: float, nbytes: float):
    """``(milliseconds, "operations" or "bytes")``: the larger of the two
    times at the published peaks."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def physical_table_bytes(scene, words_per_material: int = 10) -> int:
    """The reference tier's tables and the emitter tables (5 words a sphere,
    5 a triangle, 1 a material, 2 counts)."""
    return 4 * (11 * scene.num_spheres + 19 * scene.num_triangles
                + words_per_material * scene.num_materials + 19)


def bound_physical_ms(scene, height, width, spp, events):
    """The physical kernel's bound, as ``bound_ms``, from ``physical_ops``.
    Bytes: the tables and the image."""
    return bound_of(physical_ops(scene, height, width, spp, events),
                    physical_table_bytes(scene) + 12 * height * width)


def bound_physical_fused_ms(scene, height, width, spp, events, fwd_events, n_planes,
                            geom: bool, rough: bool):
    """The fused physical kernel's bound: the forward kernel's operations for
    the rounds this kernel ran (the forward kernel's own events at the same
    seed count the diffuse vertices, light samples and shadow scans: the two
    run the same rounds wherever no albedo is exactly black), one sweep per
    hit round, the light sample's sweep terms and, with geometry planes, the
    weight chain's adjoint per valid light sample (``count_events``). Bytes:
    the forward kernel's, plus every plane once."""
    hit_rounds = max(events["rounds"] - height * width * spp, 0)
    valid = events["valid_samples"]
    ops = (physical_ops(scene, height, width, spp, {**fwd_events, "rounds": events["rounds"]})
           + hit_rounds * (OPS_PF_SWEEP + (OPS_PF_SWEEP_ROUGH if rough else 0))
           + valid * (OPS_PF_SWEEP_VALID + ((OPS_CONE_ADJOINT + OPS_PF_GEO_PLANES) if geom else 0)))
    return bound_of(ops, physical_table_bytes(scene) + (12 + 4 * n_planes) * height * width)


def bound_physical_bwd_ms(scene, height, width, spp, events, fwd_events, n_em_cap: int):
    """The two-pass kernel's bound: as the fused kernel's, with its own sweep
    terms; it runs the fused kernel's rounds. Bytes: the tables with the raw
    emission colours, the image's cotangent once, the two small outputs."""
    hit_rounds = max(events["rounds"] - height * width * spp, 0)
    valid = events["valid_samples"]
    ops = (physical_ops(scene, height, width, spp, {**fwd_events, "rounds": events["rounds"]})
           + hit_rounds * OPS_PB_SWEEP
           + valid * (OPS_PB_SWEEP_VALID + ((OPS_CONE_ADJOINT + OPS_PB_GEO) if n_em_cap else 0)))
    nbytes = (physical_table_bytes(scene, 13) + 12 * height * width
              + 4 * (8 * (scene.num_materials + 1) + 4 * max(n_em_cap, 1)))
    return bound_of(ops, nbytes)


def light_fit_scene(pt, dev):
    """A black sphere light over a mostly diffuse sphere and ground under a
    black sky: the scene of the three CLI fits (the light-recovery scene of
    tests/test_pallas_physical.py with every material's roughness set; a
    black light's geometry gradient is the light sample's chain, whole, and
    its roughness, which no path can see, is the value the fit starts
    from)."""
    b = pt.SceneBuilder(sky_color=(0.0, 0.0, 0.0))
    light = b.add_material(albedo=(0.0, 0.0, 0.0), roughness=0.5, emission_color=(1.0, 0.9, 0.8),
                           emission_strength=10.0)
    ball = b.add_material(albedo=(0.7, 0.5, 0.4), roughness=0.8)
    ground = b.add_material(albedo=(0.4, 0.35, 0.3), roughness=0.9)
    b.add_sphere(center=(1.5, 2.4, 4.0), radius=0.45, material=light)
    b.add_sphere(center=(0.0, -0.2, 5.0), radius=1.0, material=ball)
    b.add_triangle(v0=(-50, -1.2, -50), v1=(50, -1.2, -50), v2=(50, -1.2, 50), material=ground)
    b.add_triangle(v0=(-50, -1.2, -50), v1=(-50, -1.2, 50), v2=(50, -1.2, 50), material=ground)
    return b.build(dev)


def compare_cotangents(a, b, leaves, what: str) -> float:
    """The largest |a - b| over the leaves of two scene cotangents, relative
    to each leaf's largest entry; raises outside BWD_RTOL / BWD_ATOL_SCALE."""
    import torch

    worst = 0.0
    for table, name in leaves:
        x, y = (getattr(getattr(d, table) if table else d, name) for d in (a, b))
        scale = max(float(y.abs().max()), 1.0)
        worst = max(worst, float((x - y).abs().max()) / scale)
        torch.testing.assert_close(x, y, rtol=BWD_RTOL, atol=BWD_ATOL_SCALE * scale,
                                   msg=lambda m: f"{what} d_{name}: {m}")
    log(f"  {what}: largest |delta| / leaf scale {worst:.3g}")
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import path_tracer_c_tpu_torch as pt
    from path_tracer_c_tpu_torch.app.main import main as cli_main
    from path_tracer_c_tpu_torch.grad import diff
    from path_tracer_c_tpu_torch.ops import build
    from path_tracer_c_tpu_torch.ops import render_grad as rg
    from path_tracer_c_tpu_torch.ops import render_kernel as rk
    from path_tracer_c_tpu_torch.ops import render_physical as rp
    from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
    from path_tracer_c_tpu_torch.scene.io import save_scene
    from path_tracer_c_tpu_torch.utils.bitmap import bitmap_bytes
    from path_tracer_c_tpu_torch.utils.config import FitConfig, RenderConfig, load
    from path_tracer_c_tpu_torch.utils.metrics import rays_per_render

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    # -- 1. device --
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("card (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader):")
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")

    # -- 2. build --
    t0 = time.perf_counter()
    build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({build.build_dir()})")
    for line in build.resource_usage().splitlines():
        if "Compiling entry function" in line or "registers" in line or "stack frame" in line:
            log("  ptxas: " + line.split("ptxas info    :")[-1].strip())

    # -- 3. forward kernel against its plain twin --
    log("forward kernel vs plain twin (both on the card unless named):")
    cam = pt.Camera.reference(dev)
    launches0 = rk.render_kernel.launches
    max_err = 0.0
    demo_names = ("demo_scene", "glossy_scene", "cornell_spheres_scene")
    small_cases = ((False, 0, 4), (True, 3, 8))  # jitter, sample offset, bounces
    for name in demo_names:
        scene = getattr(pt.demo, name)(dev)
        for jitter, offset, bounces in small_cases:
            args = (scene, cam, 100, 160, 4, bounces, 7)
            kw = dict(sample_offset=offset, jitter=jitter)
            k = rk.render_kernel(*args, **kw)
            r = rk.render_kernel_reference(*args, **kw)
            torch.cuda.synchronize()
            s = compare(k, r, f"{name} 100x160 4spp {bounces}b jitter={jitter} offset={offset}")
            max_err = max(max_err, s["max"])
    glossy = pt.demo.glossy_scene(dev)
    k_main = rk.render_kernel(glossy, cam, H, W, SPP, BOUNCES, 1)
    r_main = rk.render_kernel_reference(glossy, cam, H, W, SPP, BOUNCES, 1)
    torch.cuda.synchronize()
    s = compare(k_main, r_main, f"glossy_scene {H}x{W} {SPP}spp {BOUNCES}b (main shape)")
    max_err = max(max_err, s["max"])
    del k_main, r_main
    cpu_scene = pt.demo.demo_scene("cpu")
    k = rk.render_kernel(pt.demo.demo_scene(dev), cam, 24, 40, 2, 4, 5, sample_offset=2, jitter=True)
    r = rk.render_kernel_reference(cpu_scene, pt.Camera.reference("cpu"), 24, 40, 2, 4, 5,
                                   sample_offset=2, jitter=True)
    s = compare(k.cpu(), r, "demo_scene 24x40 2spp 4b jitter, twin on the CPU")
    max_err = max(max_err, s["max"])
    if rk.render_kernel.launches <= launches0:
        raise AssertionError("render_kernel did not launch its kernel")

    # -- 4. the forward main path, through the CLI --
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "glossy.bmp"
        rk.render_kernel.launches = 0
        cli_main(["render", "--scene", "glossy", "--width", str(W), "--height", str(H),
                  "--spp", str(SPP), "--max-bounces", str(BOUNCES), "--out", str(out)])
        fwd_launches = rk.render_kernel.launches
        log(f"forward main path: render_kernel launched {fwd_launches} time(s)")
        if fwd_launches < 1:
            raise AssertionError("the CLI render did not go through the kernel")
        data = out.read_bytes()
    check_bmp(data, W, H)
    # The CLI's image is the kernel's (seed 0), encoded.
    rad = rk.render_kernel(glossy, cam, H, W, SPP, BOUNCES, 0)
    if bitmap_bytes(pt.render_image_u8(rad).cpu().numpy()) != data:
        raise AssertionError("CLI BMP differs from the encoded kernel image")
    log(f"forward main path: BMP {len(data)} bytes, {W}x{H}, decoded and checked")
    del rad

    # -- 5. fused kernel against its plain twin --
    log("fused kernel: image vs render_kernel and Jacobian vs plain twin (all must be equal):")
    fcfg = load(root / FIT_CONFIG, FitConfig)
    cfg = fcfg.render
    spheres = pt.demo.random_spheres_scene(dev)
    scenes = {name: getattr(pt.demo, name)(dev) for name in demo_names}
    scenes.update(test_scenes(pt, dev))
    cases = [(f"{name} 100x160 4spp {bounces}b jitter={jitter} offset={offset}",
              (scene, cam, 100, 160, 4, bounces, 7), dict(sample_offset=offset, jitter=jitter))
             for name, scene in scenes.items() for jitter, offset, bounces in small_cases]
    # The shapes the two gradient main paths give the kernel.
    cases.append((f"spheres32 {cfg.height}x{cfg.width} {cfg.spp}spp {cfg.max_bounces}b "
                  f"{spheres.num_materials} materials (the fit's shape)",
                  (spheres, cam, cfg.height, cfg.width, cfg.spp, cfg.max_bounces, 1), {}))
    cases.append((f"glossy_scene {H}x{W} {SPP}spp {BOUNCES}b (main shape)",
                  (glossy, cam, H, W, SPP, BOUNCES, 1), {}))
    jac_err = 0.0
    for what, args, kw in cases:
        img, jac = rg.render_fused(*args, **kw)
        if not torch.equal(img, rk.render_kernel(*args, **kw)):
            raise AssertionError(f"{what}: fused image differs from render_kernel's")
        r_img, r_jac = rg.render_fused_reference(*args, **kw)
        torch.cuda.synchronize()
        compare_exact(img, r_img, what + " image")
        jac_err = max(jac_err, compare_exact(jac, r_jac, what + " Jacobian"))
        del img, jac, r_img, r_jac
    for name in ("glossy_scene", "black_albedo_scene"):
        args = (scenes[name], cam, 100, 160, 4, 8, 7)
        kw = dict(sample_offset=3, jitter=True, count_rounds=True)
        n_fwd, n_fwd_twin = rk.render_kernel(*args, **kw)[-1], rk.render_kernel_reference(*args, **kw)[-1]
        n_fus, n_fus_twin = rg.render_fused(*args, **kw)[-1], rg.render_fused_reference(*args, **kw)[-1]
        log(f"  {name} 100x160 thread-rounds: forward {n_fwd} (twin {n_fwd_twin}), "
            f"fused {n_fus} (twin {n_fus_twin}), nominal {100 * 160 * 4 * 9}")
        if not (n_fwd == n_fwd_twin and n_fus == n_fus_twin and 0 < n_fwd <= n_fus):
            raise AssertionError(f"{name}: executed rounds disagree")

    # -- 6. the gradient against autograd --
    log("gradient: render_kernel_vjp + backward vs autograd through the eager integrator:")
    g = torch.randn((32, 64, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    for name in ("mixed_scene", "black_albedo_scene"):
        grads = []
        for render in (rg.render_kernel_vjp, pt.render_radiance):
            leaves = [t.clone().requires_grad_() for t in rg._grad_leaves(scenes[name])]
            out = render(rg._with_leaves(scenes[name], leaves), cam, 32, 64, 3, 4, 7)
            grads.append(torch.autograd.grad(out, leaves, g))
        for (_, leaf), a, b in zip(rg._GRAD_LEAVES, *grads):
            torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       msg=lambda m: f"{name} d_{leaf}: {m}")
        log(f"  {name} 32x64 3spp 4b: five cotangents within rtol {GRAD_RTOL}, atol {GRAD_ATOL}")

    # -- 7. the gradient main path --
    target = rk.render_kernel(glossy, cam, H, W, SPP, BOUNCES, 12345)
    rg.render_fused.launches = 0
    torch.cuda.reset_peak_memory_stats()
    loss, d_scene = diff.loss_and_grad(glossy, target, cam, H, W, SPP, BOUNCES, 1, engine="cuda")
    torch.cuda.synchronize()
    lg_launches = rg.render_fused.launches
    peak = torch.cuda.max_memory_allocated()
    dm = d_scene.materials
    log(f"gradient main path: loss_and_grad launched render_fused {lg_launches} time(s), "
        f"loss {float(loss):.4e}, |d_albedo| {float(dm.albedo.abs().sum()):.4e}, "
        f"|d_emission_strength| {float(dm.emission_strength.abs().sum()):.4e}, "
        f"|d_sky| {float(d_scene.sky_color.abs().sum()):.4e}, "
        f"peak memory {peak / 2**20:.0f} MiB")
    if lg_launches != 1:
        raise AssertionError("loss_and_grad did not go through the fused kernel once")
    for name, t in (("albedo", dm.albedo), ("emission_color", dm.emission_color),
                    ("emission_strength", dm.emission_strength),
                    ("sky_color", d_scene.sky_color)):
        if not (bool(torch.isfinite(t).all()) and bool(t.any())):
            raise AssertionError(f"d_{name} is not finite and nonzero")
    if not bool(torch.isfinite(dm.transparency).all()):
        raise AssertionError("d_transparency is not finite")
    zero_by_contract = [dm.roughness, dm.metallicity, dm.refractive_index,
                        d_scene.spheres.center, d_scene.spheres.radius,
                        d_scene.triangles.v0, d_scene.triangles.v1, d_scene.triangles.v2]
    if any(bool(t.any()) for t in zero_by_contract):
        raise AssertionError("a cotangent that is zero by contract is not zero")
    del target, d_scene, dm

    steps = fcfg.steps
    buf = io.StringIO()
    rg.render_fused.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_main(["fit", "--config", str(root / FIT_CONFIG)])
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - t0
    fit_launches = rg.render_fused.launches
    fit_line = buf.getvalue().strip().splitlines()[-1]
    log(f"gradient main path: CLI `fit --config {FIT_CONFIG}` ({steps} steps, "
        f"{fit_seconds:.1f} s): {fit_line}")
    m = re.search(r"loss ([\d.e+-]+) -> ([\d.e+-]+), max albedo err ([\d.]+)", fit_line)
    if m is None:
        raise AssertionError("the fit's line did not parse")
    first, last, albedo_err = (float(x) for x in m.groups())
    if fit_launches != steps:
        raise AssertionError(f"fit: render_fused launched {fit_launches} times in {steps} steps")
    if not (last < first and albedo_err == albedo_err and albedo_err < float("inf")):
        raise AssertionError(f"fit: loss {first} -> {last}, albedo error {albedo_err}")

    # -- 8. physical kernel against its plain twin --
    log("physical kernel vs plain twin (both on the card unless named):")
    phys_launches0 = rp.render_physical_kernel.launches
    phys_err = 0.0
    phys_scenes = {**scenes, "diffuse_sphere_scene (no emitter)": pt.demo.diffuse_sphere_scene(dev),
                   "tri_light_scene": tri_light_scene(pt, dev)}
    phys_cases = [
        ("cornell_spheres_scene", {}), ("glossy_scene", {}),
        ("diffuse_sphere_scene (no emitter)", {}),
        ("tri_light_scene", dict(tri_nee=True)), ("tri_light_scene", dict(tri_nee=True, jitter=False)),
        ("cornell_spheres_scene", dict(nee=False)), ("glossy_scene", dict(jitter=False)),
        ("glossy_scene", dict(sample_offset=3)), ("mixed_scene", dict(sample_offset=64, tri_nee=True)),
    ]
    for name, kw in phys_cases:
        args = (phys_scenes[name], cam, 100, 160, 4, 8, 7)
        k, ev = rp.render_physical_kernel(*args, count_events=True, **kw)
        r, ev_twin = rp.render_physical_kernel_reference(*args, count_events=True, **kw)
        torch.cuda.synchronize()
        s = compare_physical(k, r, f"{name} 100x160 4spp 8b {kw}")
        phys_err = max(phys_err, s["max"])
        if not torch.equal(k, rp.render_physical_kernel(*args, **kw)):
            raise AssertionError(f"{name}: the counting instantiation's image differs")
        if ev != ev_twin or ev["rounds"] != rp.render_physical_kernel(
                *args, count_rounds=True, **kw)[1]:
            raise AssertionError(f"{name}: events {ev}, twin {ev_twin}")
        log(f"    events {ev} of nominal {100 * 160 * 4 * 9} rounds, equal to the twin's")
    # The main shape, as configs/config3 renders it (jitter on), the twin's
    # one run timed.
    pcfg = load(root / PHYS_CONFIG, RenderConfig)
    if (pcfg.scene, pcfg.height, pcfg.width, pcfg.spp, pcfg.max_bounces) != (
            "glossy", H, W, SPP, BOUNCES):
        raise AssertionError(f"{PHYS_CONFIG} is not the main shape")
    phys_kw = dict(jitter=pcfg.jitter, tri_nee=pcfg.tri_nee)
    k_main, phys_events = rp.render_physical_kernel(glossy, cam, H, W, SPP, BOUNCES, 1,
                                                    count_events=True, **phys_kw)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    r_main, ev_twin = rp.render_physical_kernel_reference(
        glossy, cam, H, W, SPP, BOUNCES, 1, count_events=True, **phys_kw)
    end.record()
    torch.cuda.synchronize()
    phys_twin_ms = start.elapsed_time(end)
    s = compare_physical(k_main, r_main, f"glossy_scene {H}x{W} {SPP}spp {BOUNCES}b {phys_kw} "
                                         "(main shape)")
    phys_err = max(phys_err, s["max"])
    if phys_events != ev_twin:
        raise AssertionError(f"main shape: events {phys_events}, twin {ev_twin}")
    log(f"    events {phys_events} of nominal {rays_per_render(H, W, SPP, BOUNCES)} rounds, "
        "equal to the twin's")
    del k_main, r_main
    tri_cpu = tri_light_scene(pt, "cpu")
    k = rp.render_physical_kernel(phys_scenes["tri_light_scene"], cam, 24, 40, 2, 4, 5,
                                  sample_offset=2, tri_nee=True)
    r = rp.render_physical_kernel_reference(tri_cpu, pt.Camera.reference("cpu"), 24, 40, 2, 4, 5,
                                            sample_offset=2, tri_nee=True)
    s = compare_physical(k.cpu(), r, "tri_light_scene 24x40 2spp 4b tri_nee, twin on the CPU")
    phys_err = max(phys_err, s["max"])
    if rp.render_physical_kernel.launches <= phys_launches0:
        raise AssertionError("render_physical_kernel did not launch its kernel")

    # -- 9. the physical main path, through the CLI --
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "config3.bmp"
        rp.render_physical_kernel.launches = 0
        t0 = time.perf_counter()
        cli_main(["render", "--config", str(root / PHYS_CONFIG), "--out", str(out)])
        phys_cli_seconds = time.perf_counter() - t0
        phys_launches = rp.render_physical_kernel.launches
        log(f"physical main path: CLI `render --config {PHYS_CONFIG}` launched "
            f"render_physical_kernel {phys_launches} time(s), {phys_cli_seconds * 1e3:.1f} ms "
            f"to the written BMP [{card}]")
        if phys_launches < 1:
            raise AssertionError("the CLI render did not go through the physical kernel")
        data = out.read_bytes()
    check_bmp(data, W, H)
    rad = rp.render_physical_kernel(glossy, cam, H, W, SPP, BOUNCES, pcfg.seed, **phys_kw)
    if bitmap_bytes(pt.render_image_u8(rad).cpu().numpy()) != data:
        raise AssertionError("CLI BMP differs from the encoded physical kernel image")
    log(f"physical main path: BMP {len(data)} bytes, {W}x{H}, decoded and checked")
    del rad

    # -- 10. fused physical kernel against its plain twin --
    log("fused physical kernel: image vs render_physical_kernel, image and planes vs plain twin "
        "(all must be equal):")
    fwd_keys = ("nee", "tri_nee", "jitter", "sample_offset")
    pf_cases = [
        ("cornell_spheres_scene", {}), ("glossy_scene", dict(n_em_cap=1)),
        ("cornell_spheres_scene", dict(nee=False, n_em_cap=1)),
        ("glossy_scene", dict(jitter=False, sample_offset=3, rough_grad=True)),
        ("tri_light_scene", dict(tri_nee=True, n_em_cap=1, tri_em_cap=2, rough_grad=True)),
        ("tri_light_scene", dict(tri_nee=True, n_em_cap=3, tri_em_cap=1, jitter=False)),
        ("mixed_scene", dict(tri_nee=True, n_em_cap=1, tri_em_cap=1, sample_offset=64)),
        ("black_albedo_scene", dict(n_em_cap=1)),
    ]
    pf_err = 0.0
    for name, kw in pf_cases:
        args = (phys_scenes[name], cam, 100, 160, 4, 8, 7)
        what = f"{name} 100x160 4spp 8b {kw}"
        out = pg.render_physical_fused(*args, count_events=True, **kw)
        ref = pg.render_physical_fused_reference(*args, count_events=True, **kw)
        fwd_kw = {k: v for k, v in kw.items() if k in fwd_keys}
        b3, n_fwd = rp.render_physical_kernel(*args, count_rounds=True, **fwd_kw)
        torch.cuda.synchronize()
        if not torch.equal(out[0], b3):
            raise AssertionError(f"{what}: fused image differs from render_physical_kernel's")
        compare_exact(out[0], ref[0], what + " image")
        families = (["material and sky planes"] + ["sphere planes"] * bool(kw.get("n_em_cap"))
                    + ["vertex planes"] * bool(kw.get("tri_em_cap")))
        for family, a, b in zip(families, out[1:-1], ref[1:-1]):
            pf_err = max(pf_err, compare_exact(a, b, f"{what} {family} {tuple(a.shape)}"))
        if out[-1] != ref[-1] or out[-1]["rounds"] < n_fwd:
            raise AssertionError(f"{what}: events {out[-1]}, twin {ref[-1]}, forward rounds {n_fwd}")
        if not all(torch.equal(a, b) for a, b in zip(pg.render_physical_fused(*args, **kw), out)):
            raise AssertionError(f"{what}: the counting instantiation's outputs differ")
        log(f"    events {out[-1]} (forward kernel: {n_fwd} rounds), equal to the twin's")

    # -- 11. two-pass kernel against its twin and the fused contraction; the
    # gradient against autograd --
    log(f"two-pass kernel vs plain twin and vs the fused kernel's contraction (rtol {BWD_RTOL}, "
        f"atol {BWD_ATOL_SCALE} of the leaf's largest entry):")
    pb_leaves = [lf for lf in pg._GRAD_LEAVES if lf[0] != "triangles" and lf[1] != "roughness"]
    g_small = torch.randn((100, 160, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    pb_err = 0.0
    for name, kw in (("cornell_spheres_scene", {}), ("glossy_scene", dict(n_em_cap=1, sample_offset=3)),
                     ("cornell_spheres_scene", dict(nee=False)),
                     ("tri_light_scene", dict(tri_nee=True, n_em_cap=2, jitter=False)),
                     ("black_albedo_scene", dict(n_em_cap=1))):
        scene = phys_scenes[name]
        what = f"{name} 100x160 4spp 8b {kw}"
        d5 = pg.render_physical_bwd(scene, cam, g_small, 100, 160, 4, 8, 7, **kw)
        r5 = pg.render_physical_bwd_reference(scene, cam, g_small, 100, 160, 4, 8, 7, **kw)
        cap = kw.get("n_em_cap", min(scene.num_spheres, 8)) if kw.get("nee", True) else 0
        out = pg.render_physical_fused(scene, cam, 100, 160, 4, 8, 7, n_em_cap=cap,
                                       **{k: v for k, v in kw.items() if k != "n_em_cap"})
        d4 = pg.contract_physical_jacobian(scene, out[1], g_small, 4, jac_geo=out[2] if cap else None)
        pb_err = max(pb_err, compare_cotangents(d5, r5, pb_leaves, what + " vs twin"))
        compare_cotangents(d5, d4, pb_leaves, what + " vs fused contraction")
        if any(bool(t.any()) for t in (d5.triangles.v0, d5.triangles.v1, d5.triangles.v2,
                                       d5.materials.roughness)):
            raise AssertionError(f"{what}: a cotangent outside the two-pass contract is not zero")
    log("physical gradient: render_physical_kernel_vjp + backward vs autograd through the eager tier:")
    g = torch.randn((32, 64, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    tri_scene = phys_scenes["tri_light_scene"]
    grads = []
    for render in (pg.render_physical_kernel_vjp, pt.render_physical):
        leaves = [x.clone().requires_grad_() for x in pg._grad_leaves(tri_scene)]
        img = render(pg._with_leaves(tri_scene, leaves), cam, 32, 64, 4, 3, 7, jitter=False)
        grads.append(torch.autograd.grad(img, leaves, g, allow_unused=True))
    for (_, leaf), a, b in zip(pg._GRAD_LEAVES, *grads):
        if leaf in ("center", "radius"):  # the black sphere light is sphere 1
            torch.testing.assert_close(a[1], b[1], rtol=PHYS_GRAD_RTOL,
                                       atol=1e-4 * float(b[1].abs().max()),
                                       msg=lambda m: f"tri_light_scene d_{leaf}: {m}")
        elif leaf in ("albedo", "emission_color", "emission_strength", "transparency", "sky_color"):
            torch.testing.assert_close(a, b, rtol=PHYS_GRAD_RTOL, atol=PHYS_GRAD_ATOL,
                                       msg=lambda m: f"tri_light_scene d_{leaf}: {m}")
    log(f"  tri_light_scene 32x64 4spp 3b: materials, sky and the sphere light's centre and radius "
        f"within rtol {PHYS_GRAD_RTOL}")

    # -- 12. the physical gradient's main path --
    n_live = rp.live_emitter_count(glossy)
    phys_target = rp.render_physical_kernel(glossy, cam, H, W, SPP, BOUNCES, 12345, jitter=False)
    pg.render_physical_fused.launches = pg.render_physical_bwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    loss, d_scene = diff.loss_and_grad(glossy, phys_target, cam, H, W, SPP, BOUNCES, 1,
                                       engine="physical_pallas")
    torch.cuda.synchronize()
    plg_launches = pg.render_physical_fused.launches
    peak_lg = torch.cuda.max_memory_allocated()
    dm = d_scene.materials
    log(f"physical gradient main path: loss_and_grad(engine='physical_pallas') launched "
        f"render_physical_fused {plg_launches} time(s), loss {float(loss):.4e}, "
        f"|d_albedo| {float(dm.albedo.abs().sum()):.4e}, "
        f"|d_emission_strength| {float(dm.emission_strength.abs().sum()):.4e}, "
        f"peak memory {peak_lg / 2**20:.0f} MiB")
    if plg_launches != 1:
        raise AssertionError("loss_and_grad did not go through the fused physical kernel once")
    for name, x in (("albedo", dm.albedo), ("emission_color", dm.emission_color),
                    ("emission_strength", dm.emission_strength), ("sky_color", d_scene.sky_color)):
        if not (bool(torch.isfinite(x).all()) and bool(x.any())):
            raise AssertionError(f"physical d_{name} is not finite and nonzero")
    if any(bool(x.any()) for x in (dm.roughness, dm.metallicity, dm.refractive_index,
                                   d_scene.spheres.center, d_scene.triangles.v0)):
        raise AssertionError("a physical cotangent that is zero by contract is not zero")
    del d_scene, dm, phys_target

    # The user's call with geometry: jitter on, the cap at the live emitter count.
    g_main = torch.randn((H, W, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    leaves = [x.clone().requires_grad_() for x in pg._grad_leaves(glossy)]
    torch.cuda.reset_peak_memory_stats()
    img = pg.render_physical_kernel_vjp(pg._with_leaves(glossy, leaves), cam, H, W, SPP, BOUNCES, 1,
                                        n_em_cap=n_live)
    vjp_grads = torch.autograd.grad(img, leaves, g_main, allow_unused=True)
    torch.cuda.synchronize()
    pvjp_launches = pg.render_physical_fused.launches - plg_launches
    peak_geo = torch.cuda.max_memory_allocated()
    d_vjp = pg._with_leaves(rg.zeros_like_scene(glossy),
                            [torch.zeros_like(x) if gr is None else gr for x, gr in zip(leaves, vjp_grads)])
    log(f"physical gradient main path: render_physical_kernel_vjp(n_em_cap={n_live}) + backward "
        f"launched render_physical_fused {pvjp_launches} time(s), "
        f"|d_center| {float(d_vjp.spheres.center.abs().sum()):.4e}, "
        f"|d_radius| {float(d_vjp.spheres.radius.abs().sum()):.4e}, peak memory {peak_geo / 2**20:.0f} MiB")
    if pvjp_launches != 1 or not torch.equal(img.detach(), rp.render_physical_kernel(
            glossy, cam, H, W, SPP, BOUNCES, 1)):
        raise AssertionError("render_physical_kernel_vjp: launches or image")
    live_mask = torch.from_numpy(rp.live_emitter_mask(glossy)).to(dev)
    if not bool(d_vjp.spheres.center[live_mask].any()) or bool(d_vjp.spheres.center[~live_mask].any()):
        raise AssertionError("emitter geometry cotangents: the emitters' must be nonzero, the others' zero")
    del img, leaves, vjp_grads

    # The oracle at the same shape, against the fused path's cotangents.
    d5 = pg.render_physical_bwd(glossy, cam, g_main, H, W, SPP, BOUNCES, 1, n_em_cap=n_live)
    torch.cuda.synchronize()
    pbwd_launches = pg.render_physical_bwd.launches
    if pbwd_launches != 1:
        raise AssertionError("render_physical_bwd did not launch its kernel once")
    log(f"physical gradient main path: render_physical_bwd launched its kernel {pbwd_launches} time(s)")
    compare_cotangents(d5, d_vjp, pb_leaves, f"glossy_scene {H}x{W} {SPP}spp {BOUNCES}b two-pass vs fused path")

    # Both kernels against their twins at the main shape; the twins' one run timed.
    geo_kw = dict(n_em_cap=n_live)
    pf_main = pg.render_physical_fused(glossy, cam, H, W, SPP, BOUNCES, 1, count_events=True, **geo_kw)
    pf_events = pf_main[-1]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    pf_twin = pg.render_physical_fused_reference(glossy, cam, H, W, SPP, BOUNCES, 1,
                                                 count_events=True, **geo_kw)
    end.record()
    torch.cuda.synchronize()
    pf_twin_ms = start.elapsed_time(end)
    where_main = f"glossy_scene {H}x{W} {SPP}spp {BOUNCES}b {geo_kw} (main shape)"
    compare_exact(pf_main[0], pf_twin[0], where_main + " image")
    pf_err = max(pf_err, compare_exact(pf_main[1], pf_twin[1], where_main + " material and sky planes"))
    pf_err = max(pf_err, compare_exact(pf_main[2], pf_twin[2], where_main + " sphere planes"))
    if pf_events != pf_twin[-1]:
        raise AssertionError(f"main shape: fused events {pf_events}, twin {pf_twin[-1]}")
    log(f"    events {pf_events}, equal to the twin's; the forward kernel ran "
        f"{phys_events['rounds']} rounds")
    del pf_main, pf_twin
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    r5 = pg.render_physical_bwd_reference(glossy, cam, g_main, H, W, SPP, BOUNCES, 1, **geo_kw)
    end.record()
    torch.cuda.synchronize()
    pb_twin_ms = start.elapsed_time(end)
    pb_err = max(pb_err, compare_cotangents(d5, r5, pb_leaves, where_main + " two-pass vs twin"))
    del d5, r5, d_vjp

    # The three CLI fits on the fused physical kernel, on a scene and configs
    # written here.
    cli_fits = {}
    with tempfile.TemporaryDirectory() as tmp:
        scene_path = Path(tmp) / "light_fit_scene.json"
        fit_scene = light_fit_scene(pt, "cpu")
        save_scene(scene_path, fit_scene)
        fit_steps = 60
        cfg_path = Path(tmp) / "fit.json"
        cfg_path.write_text(json.dumps({
            "render": {"width": 128, "height": 128, "spp": 32, "max_bounces": 3,
                       "scene": str(scene_path), "engine": "physical_pallas", "seed": 0},
            "steps": fit_steps, "lr": 0.03}))
        # What each fit's printed error is at its start: the light moved by
        # 0.3 at most, every roughness set to 0.5. The material fit also sets
        # every emission strength to 0.1, which 60 steps do not undo, so its
        # albedo error is held to be finite and its loss to fall, as the
        # reference tier's CLI fit above.
        start_err = {"geometry": 0.3,
                     "roughness": float((fit_scene.materials.roughness - 0.5).abs().max()),
                     "materials": float("inf")}
        for mode in ("geometry", "roughness", "materials"):
            buf = io.StringIO()
            pg.render_physical_fused.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli_main(["fit", "--config", str(cfg_path), "--mode", mode])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            line = buf.getvalue().strip().splitlines()[-1]
            launches = pg.render_physical_fused.launches
            log(f"physical gradient main path: CLI `fit --mode {mode} --engine physical_pallas` "
                f"({fit_steps} steps, {seconds:.1f} s, render_physical_fused launched {launches} "
                f"time(s)): {line}")
            m = re.search(r"loss ([\d.e+-]+) -> ([\d.e+-]+), max [a-z -]+ err ([\d.]+)$", line)
            if m is None or "physical_pallas" not in line and mode != "materials":
                raise AssertionError(f"fit --mode {mode}: the line did not parse")
            first, last, err = (float(x) for x in m.groups())
            if launches != fit_steps:
                raise AssertionError(f"fit --mode {mode}: {launches} launches in {fit_steps} steps")
            if not (err < start_err[mode] and last < first):
                raise AssertionError(f"fit --mode {mode}: loss {first} -> {last}, error {err}, "
                                     f"at the start {start_err[mode]}")
            cli_fits[mode] = launches

    # -- 13. times and bounds --
    rays = rays_per_render(H, W, SPP, BOUNCES)
    _, fwd_rounds = rk.render_kernel(glossy, cam, H, W, SPP, BOUNCES, 1, count_rounds=True)
    _, _, fus_rounds = rg.render_fused(glossy, cam, H, W, SPP, BOUNCES, 1, count_rounds=True)
    log(f"executed thread-rounds at the main shape (seed 1): forward {fwd_rounds}, "
        f"fused {fus_rounds}, nominal {rays}")
    fwd = lambda seed: rk.render_kernel(glossy, cam, H, W, SPP, BOUNCES, seed)
    fus = lambda seed: rg.render_fused(glossy, cam, H, W, SPP, BOUNCES, seed)
    phy = lambda seed: rp.render_physical_kernel(glossy, cam, H, W, SPP, BOUNCES, seed, **phys_kw)
    fwd_ms = median_ms(fwd)
    fus_ms = median_ms(fus)
    phy_ms = median_ms(phy)
    fwd_ms2 = median_ms(fwd)
    pf = lambda **kw: (lambda seed: pg.render_physical_fused(glossy, cam, H, W, SPP, BOUNCES, seed, **kw))
    pf_ms = median_ms(pf())
    pf_geo_ms = median_ms(pf(**geo_kw))
    pf_rough_ms = median_ms(pf(rough_grad=True))
    pf_nojit_ms = median_ms(pf(jitter=False))
    phy_ms2 = median_ms(phy)
    pb_ms = median_ms(lambda seed: pg._grad_leaves(pg.render_physical_bwd(
        glossy, cam, g_main, H, W, SPP, BOUNCES, seed, **geo_kw))[:8])
    pf_out = pg.render_physical_fused(glossy, cam, H, W, SPP, BOUNCES, 1, **geo_kw)
    pcon_ms = median_ms(lambda seed: pg._grad_leaves(
        pg.contract_physical_jacobian(glossy, pf_out[1], g_main, SPP))[:6])
    pcon_geo_ms = median_ms(lambda seed: pg._grad_leaves(
        pg.contract_physical_jacobian(glossy, pf_out[1], g_main, SPP, jac_geo=pf_out[2]))[:8])
    del pf_out
    fwd_twin_ms = median_ms(
        lambda seed: rk.render_kernel_reference(glossy, cam, H, W, SPP, BOUNCES, seed))
    fus_twin_ms = time_cuda(
        lambda seed: rg.render_fused_reference(glossy, cam, H, W, SPP, BOUNCES, seed), [1])[0]
    _, jac = fus(1)
    g_main = torch.randn((H, W, 3), device=dev)
    con_ms = median_ms(lambda seed: rg._grad_leaves(rg.contract_jacobian(glossy, jac, g_main, SPP)))
    del jac, g_main

    fit_target = rk.render_kernel(spheres, cam, cfg.height, cfg.width, cfg.spp, cfg.max_bounces, 12345)
    fit_step = lambda seed: torch.tensor(diff.fit_materials(
        spheres, fit_target, cam, cfg.height, cfg.width, cfg.spp, cfg.max_bounces,
        steps=1, lr=fcfg.lr, seed0=seed)[1], device=dev)
    step_ms = median_ms(fit_step)
    fit_fus_ms = median_ms(lambda seed: rg.render_fused(
        spheres, cam, cfg.height, cfg.width, cfg.spp, cfg.max_bounces, seed))

    fwd_bound, fwd_by = bound_ms(glossy, H, W, SPP, fwd_rounds, fused=False)
    fus_bound, fus_by = bound_ms(glossy, H, W, SPP, fus_rounds, fused=True)
    phy_bound, phy_by = bound_physical_ms(glossy, H, W, SPP, phys_events)
    n_planes = 9 * glossy.num_materials + 3 + 12 * n_live
    pf_bound, pf_by = bound_physical_fused_ms(glossy, H, W, SPP, pf_events, phys_events,
                                              n_planes, geom=True, rough=False)
    pb_bound, pb_by = bound_physical_bwd_ms(glossy, H, W, SPP, pf_events, phys_events, n_live)
    where = f"glossy {H}x{W} {SPP}spp {BOUNCES}b"
    for what, ms in (("forward kernel", fwd_ms), ("forward kernel, again after the others",
                                                   fwd_ms2),
                     ("forward plain twin", fwd_twin_ms), ("fused kernel", fus_ms),
                     ("fused plain twin (one run)", fus_twin_ms),
                     (f"physical kernel {phys_kw}", phy_ms),
                     ("physical kernel, again after the fused physical kernel", phy_ms2),
                     ("physical plain twin (one run)", phys_twin_ms),
                     ("fused physical kernel, no geometry planes", pf_ms),
                     (f"fused physical kernel {geo_kw}", pf_geo_ms),
                     ("fused physical kernel, rough_grad", pf_rough_ms),
                     ("fused physical kernel, jitter off", pf_nojit_ms),
                     (f"fused physical plain twin {geo_kw} (one run)", pf_twin_ms),
                     (f"two-pass physical kernel {geo_kw}", pb_ms),
                     (f"two-pass physical plain twin {geo_kw} (one run)", pb_twin_ms)):
        log(f"time {what}: {where}: {ms:.3f} ms, {rays / (ms / 1e3):.4e} nominal rays/s [{card}]")
    log(f"time contract_jacobian: {where}: {con_ms:.3f} ms [{card}]")
    log(f"time fused kernel / forward kernel: {fus_ms / fwd_ms:.3f}; "
        f"fwd+bwd (fused + contraction) {fus_ms + con_ms:.3f} ms [{card}]")
    log(f"time physical kernel / forward kernel: {phy_ms / fwd_ms:.3f} "
        f"({phy_ms / fwd_ms2:.3f} against the later forward time) [{card}]")
    log(f"time contract_physical_jacobian: {where}: {pcon_ms:.3f} ms; with the {12 * n_live} "
        f"geometry planes {pcon_geo_ms:.3f} ms [{card}]")
    log(f"time fused physical kernel / physical kernel: {pf_ms / phy_ms:.3f} "
        f"({pf_ms / phy_ms2:.3f} against the later physical time); with geometry planes "
        f"{pf_geo_ms / phy_ms:.3f}; two-pass / fused with geometry planes {pb_ms / pf_geo_ms:.3f}; "
        f"physical fwd+bwd (fused + contraction) {pf_ms + pcon_ms:.3f} ms, with geometry "
        f"{pf_geo_ms + pcon_geo_ms:.3f} ms [{card}]")
    log(f"bound forward kernel: {fwd_bound:.3f} ms by {fwd_by}; fused kernel: "
        f"{fus_bound:.3f} ms by {fus_by}; physical kernel: {phy_bound:.3f} ms by {phy_by}; "
        f"fused physical kernel {geo_kw}: {pf_bound:.3f} ms by {pf_by}; two-pass physical "
        f"kernel: {pb_bound:.3f} ms by {pb_by} "
        f"(67 TFLOP/s float32, 3.35 TB/s; executed rounds and events)")
    log(f"time one fit step (make params, fused kernel, backward, Adam), spheres32 "
        f"{cfg.width}x{cfg.height} {cfg.spp}spp {cfg.max_bounces}b: {step_ms:.3f} ms; "
        f"its fused kernel alone {fit_fus_ms:.3f} ms [{card}]")

    # launches: the main paths' runs; every time, bound and round count: the
    # glossy shape named in "timed_at".
    common = {"route": "cuda", "library_ms": None, "timed_at": where}
    log(json.dumps({"kernels": [
        {"name": "render_fwd", "source": rk.SOURCE, "replaces": rk.REPLACES,
         "launches": fwd_launches, "launches_by_path": {"render": fwd_launches},
         "max_abs_err": max_err, "ms": fwd_ms,
         "plain_ms": fwd_twin_ms, "bound_ms": fwd_bound, "bound_by": fwd_by,
         "executed_rounds": fwd_rounds, **common},
        {"name": "render_fused", "source": rg.SOURCE, "replaces": rg.REPLACES,
         "launches": lg_launches + fit_launches,
         "launches_by_path": {"loss_and_grad": lg_launches, "fit": fit_launches},
         "max_abs_err": jac_err, "ms": fus_ms,
         "plain_ms": fus_twin_ms, "bound_ms": fus_bound, "bound_by": fus_by,
         "executed_rounds": fus_rounds, **common},
        {"name": "render_phys", "source": rp.SOURCE, "replaces": rp.REPLACES,
         "launches": phys_launches, "launches_by_path": {"render --engine physical": phys_launches},
         "max_abs_err": phys_err, "ms": phy_ms,
         "plain_ms": phys_twin_ms, "bound_ms": phy_bound, "bound_by": phy_by,
         "executed_rounds": phys_events["rounds"], "events": phys_events, **common},
        {"name": "render_phys_fused", "source": pg.SOURCE, "replaces": pg.REPLACES,
         "launches": plg_launches + pvjp_launches + sum(cli_fits.values()),
         "launches_by_path": {"loss_and_grad physical_pallas": plg_launches,
                              "render_physical_kernel_vjp geom": pvjp_launches,
                              **{f"fit --mode {k}": v for k, v in cli_fits.items()}},
         "max_abs_err": pf_err, "ms": pf_geo_ms, "ms_no_geometry": pf_ms,
         "plain_ms": pf_twin_ms, "bound_ms": pf_bound, "bound_by": pf_by,
         "executed_rounds": pf_events["rounds"], "events": pf_events, **common},
        {"name": "render_phys_bwd", "source": pg.SOURCE_BWD, "replaces": pg.REPLACES_BWD,
         "launches": pbwd_launches, "launches_by_path": {"render_physical_bwd": pbwd_launches},
         "max_abs_err": pb_err, "max_abs_err_is": "largest |delta| over a leaf's largest entry",
         "ms": pb_ms, "plain_ms": pb_twin_ms, "bound_ms": pb_bound, "bound_by": pb_by,
         "executed_rounds": pf_events["rounds"], "events": pf_events, **common},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
