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
3. forward kernel against its plain twin: ``render_kernel`` and each of its
   measurement instantiations (``render_kernel_variant``: the other schedule
   or table placement, ``csrc/pt_sched.cuh``) on the card against
   ``render_kernel_reference`` on the card, value for value, for three
   scenes at 100x160, with jitter off and on and a nonzero sample offset, at
   a ragged 19x45, at the main path's shape and on a scene whose tables
   exceed the shared budget (the shared instantiations refuse it), and once
   against the twin on the CPU.
4. the forward main path: the CLI ``render`` at 1024x1024, 64 spp, 8
   bounces on the glossy scene. The kernel's launch count must grow; the
   BMP is decoded and checked.
5. fused kernel against its plain twin: ``render_fused``'s image must equal
   ``render_kernel``'s bit for bit and its Jacobian must equal
   ``render_fused_reference``'s, value for value, on the three scenes, a
   mixed scene (emission, glass, diffuse) and a scene whose only material
   is exactly black, and at the shapes of both gradient main paths (glossy
   at 1024x1024; the 33 materials of the fit's configuration at its own
   size), a ragged size with no bounce and one at the bounce cap.
   ``count_rounds`` of both kernels must equal their twins', and B2's
   thread- and warp lane-rounds (per sample, its schedule) the twin's.
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
   estimation off, jitter off and a nonzero sample offset, at the main
   shape and on the scene above the shared budget, value for value, and so
   must each of its measurement instantiations; the counted events (rounds,
   diffuse vertices, light samples, shadow scans) must equal the twin's, and
   the warp lane-rounds of every counting instantiation (its rounds, and
   those with a light sample and a shadow scan) the twin's grouping for the
   schedule it runs (phase 14 adds a ragged 19x45); once against the twin on
   the CPU. The twin runs every round of every path, so agreement shows
   that what the kernel skips adds exact zeros.
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
   ``rough_grad``, caps below, at and above the live emitter counts and
   the slot instantiations' budget (spheres32's four emitter materials, its
   sphere cap at 1, 2 and 4; triangle caps of 1 and 2), a ragged size with
   no bounce and one at the bounce cap; the counted rounds, valid light
   samples and plane adds by family, and the thread- and warp lane-rounds,
   must equal the twin's.
11. two-pass kernel against its plain twin and against the fused kernel's
   contraction, at the tolerance stated at ``BWD_RTOL``; two of its launches
   and its counting instantiation equal bit for bit, and the counts
   (``count_sites``: rounds, and each add site's lanes, rows, depth and
   visits) equal to the twin's, with rounds equal to B4's, at 100x160 and
   at config 4's shape on spheres32 (the cap at the live count and 0); then
   ``render_physical_kernel_vjp`` + ``backward`` against ``torch.autograd``
   through the eager physical tier.
12. the physical gradient's main path at full width (glossy, 1024x1024, 64
   spp, 8 bounces): ``loss_and_grad(engine="physical_pallas")`` (no geometry
   planes), ``render_physical_kernel_vjp`` with jitter on and the emitter cap
   at the scene's live emitter count plus ``backward``, and
   ``render_physical_bwd`` once; both kernels against their twins at that
   shape, B5's counts too; then the CLI ``fit --mode geometry``, ``fit --mode roughness`` and
   ``fit``, each with ``--engine physical_pallas``, on a small scene and
   configs the script writes: every step must go through the fused kernel,
   the loss must fall, and the printed error of the geometry and roughness
   fits must end below the start's.
13. times: the five kernels, the contractions, the twins and one fit step,
   with CUDA events, and each kernel's bound from this run's executed
   rounds and events (``utils/flops.py``).
14. speed of light: the calibration kernel (B6) against its twin for each of
   its four chains, within ``CALIB_ULPS``; the null and micro probes (B7, B8)
   against their twins, value for value, and the micro probe's SASS (the
   reload variant keeps its loads); the warp lane-rounds of the forward
   kernel's counting instantiations (timed kernel and measurement
   instantiations) against the twin's grouping for their schedule at a
   ragged shape and at the main shape; then the speed-of-light path, with
   its launches counted: the four op rates with their spread
   (``measure_op_rates``) and ``sol_decompose`` of B1 at the main shape, then
   of B3 at config 3's (with the prices of both kernels' policies, each the
   kernel against its measurement instantiation); the ALU rate at twice the
   launch size within 5% of the rate at the
   default size; the probes' times; ``sol_report`` of the five render
   kernels at phase 13's times, and every kernel's bound at the measured
   rates; B2's and B4's measurement instantiations against the kernels
   (images, and but for the sinks planes, value for value); what ptxas gave
   every instantiation of B2 and B4 (registers, stack, spills); the
   decompositions of B2's and B4's times (``fused_decompose``), with the
   twins' warp lane-rounds at the main shape under both schedules, and for
   B4 the price of each of its own policies (warp-uniform loops, three
   blocks, its pixel-constant planes in slots in shared and in local
   memory), each the kernel against itself, and its plane adds by family; the
   decomposition of B5's (``fused_decompose(kind="physical_bwd")``: its
   reduction against its sink, the geometry, its records in shared memory,
   its counts held to the twin's), and the shared atomics, matches and
   shuffles in the SASS of its instantiations (the timed kernel has no
   shared atomic).
15. the long runs: the CLI ``render`` at the main shape (B1) and of
   ``configs/config3_glossy_1024.json`` (B3), in one chunk and in chunks of
   ``CHUNK_SPP`` spp with and without a checkpoint file, timed in turns,
   every chunked BMP equal; a run interrupted inside its second save and
   resumed must write the uninterrupted chunked run's BMP and accumulator;
   the kernel must equal its plain twin, value for value, on the last
   chunk as the chunked run gave it (its arguments recorded at the CLI's
   renderer); ``render --debug-nans`` through B1 on a scene whose emission
   is NaN must raise; config 5's sweep (``animate``) with its mesh set to
   1x1 and ``SWEEP_FRAMES`` frames, with the native writer and with
   numpy's, in turns, then once more under ``torch.profiler`` for the
   device's busy share: the native writer must be the one named, every
   run's frames equal, frame 0 decoded and equal to the encoded kernel
   image, B1 equal to its twin at frame 0's arguments (all its samples, and
   its last 4 at their offset), the time a frame after the first (the
   sweep's window after frame 0 over its frames) beside B1's alone;
   config 4's CLI ``fit`` (B2) and a geometry fit
   on B4 stopped at half their steps and resumed must save the
   uninterrupted run's state bit for bit; the peak device memory of
   ``loss_and_grad(engine="core")`` at config 4's fit shape with each
   sample recomputed in backward (as it runs) and without.

16. row blocks and the parallel layer: B1-B4 and each of their
   instantiations (timed, counting, measurement) over four blocks of 256
   rows at the main shape and 7 + 12 rows of a ragged 19x45 against the
   whole launch, bit for bit (images, planes, counters summed; B1's warp
   lane-rounds of blocks that do not start on a multiple of its footprint's
   height against its twin's, block by block), B5's blocks
   summed against the whole at ``BWD_RTOL``; then, on meshes of cuda:0
   repeated: config 5's frame (2048^2, 256 spp, 4 bounces, B1) through
   ``render_sharded`` on 8x1 (bit for bit) and 4x2 (``SHARD_RTOL``), each
   eight launches of B1, timed beside the unsharded frame; config 3 through
   ``render_sharded(engine="physical_pallas")`` on 4x1 and 2x2 (B3); the
   sharded gradient on a 2x2 mesh and ``make_train_step``'s against the
   unsharded (B2, ``SHARD_GRAD_RTOL``); config 4's CLI ``fit`` on a 2x2 mesh
   for 20 steps (80 launches of B2, the loss falls); a geometry step on B4
   with ``geom=True`` against the unsharded; two processes on cuda:0 over
   gloo rendering on a 2x1 mesh, equal to one process bit for bit; the CLI's
   refusal of config 5's 4x2 mesh (``animate --config``) on this machine's
   cards; ``render
   --engine split`` on the card against the split tier on the CPU.
17. the measurement scripts' modules at the JAX scripts' TPU shapes: B1 and
   B3 against their twins, value for value, on the capacity sweep's scenes
   where the table placement flips (1024 to 2048 spheres and materials)
   and, above the shared budget, at the sweep's shape on a block of rows;
   B4 against its twin on the asymmetry's triangle-lit call; the eager
   physical gradient twice, bit for bit; the capacity sweep
   (``utils/capacity_sweep``, 512x512, 16 spp, 4 bounces, 5 to 2048 spheres
   and materials: each kernel's table placement, its ``global_tables``
   instantiation where the tables fit, its time alone on packed operands);
   the geometry-gradient asymmetry (``utils/geom_asym``, fused B4 against
   autograd through the eager tier, at 256x256, 16 spp, 4 bounces and at
   1024x1024, 64 spp, 8 bounces with peak device memory, the eager side
   there one call; the fused gradients finite); the scaling harness
   (``parallel/scaling``, B1 at 1024x1024, 64 spp, 8 bounces) on the visible
   cards and on cuda:0 repeated 2 and 4 times, every mesh's image equal to
   the unsharded render bit for bit. Each line is printed as it comes.
18. the launch shapes (``ops/render_kernel.TILES``): the sweep library
   (every render kernel at each point but its default, ``ops/build.py``)
   built, with its build time; at a small glossy shape (and there also the
   triangle-lit scene with ``tri_nee``), at a ragged 19x45 and on a block of
   rows, every point of B1-B4 equal to the default point bit for bit
   (images, every plane, ``rough_grad``'s, thread-rounds and counted
   events), each point's warp lane-rounds equal to the twin's grouping
   under its footprint, B5 at each point within ``BWD_RTOL`` of its twin and
   two launches the same bits; B2 at ``MAX_BOUNCES`` asked for its
   512-thread point, which ``fit_tile`` must shrink to a point that
   launches and equals the default (the point itself must fail to launch);
   then the sweep at the headline (``utils/tile_sweep.sweep``: glossy
   1024x1024, 8 bounces, B1 and B3 at 64 spp, B2, B4 and B5 at 16 spp, each
   as called and alone on operands packed once at each of its points, the
   alone launch's output equal to the call's, with its registers and
   spills). Any
   failure, a point that does not build or launch included, fails the run.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``. ``--worker`` runs one
process of phase 16's two-process render; nothing else passes arguments.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


class _Launches:
    """The port's launches since this was made, by kernel source stem:
    ``since["render_fwd"]`` is what the counter ``launch.render_fwd``
    (``utils/tracing.counters``) counted meanwhile."""

    def __init__(self):
        from path_tracer_c_tpu_torch.utils import tracing

        self._counters, self._base = tracing.counters, tracing.counters()

    def __getitem__(self, stem: str) -> int:
        return (self._counters() - self._base)[f"launch.{stem}"]


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
# Phase 15: chunks of 16 spp (a quarter of the main shape's 64), and config
# 5's sweep cut to 8 of its 48 frames for the time limit.
CHUNK_SPP = 16
SWEEP_CONFIG = "configs/config5_sweep_2048_multihost.json"
SWEEP_FRAMES = 8

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
# The calibration kernel against its twin: within 2 float32 ulp. The alu and
# sqrt chains round alike (separate multiplies and adds, IEEE roots) and agree
# bit for bit; the card's cosf and log1pf and PyTorch's cos and log1p are
# different routines, and each chain converges, so a difference stays at the
# last place. The rounds of the check, and of the kernel's timed call beside
# its twin (the twin runs one PyTorch operation a step).
CALIB_ULPS = 2
CALIB_CHECK_REPS, CALIB_TIMED_REPS = 4, 64

# Phase 16. Row blocks: four blocks of 256 rows at the main shape, 7 + 12
# rows at a ragged 19x45; each block must equal the same rows of the whole
# launch bit for bit (image, planes, counters summed), B5's cotangents summed
# over the blocks the whole's at BWD_RTOL. The sharded renders against the
# unsharded: bit for bit with no spp split. With one, bit for bit against
# the same fixed-order mean of unsharded renders of each sample range, and
# against the unsharded render at spp_split_rtol: the two sum the same spp
# non-negative float32 terms in another association, and each such sum is
# within (spp - 1) * 2^-24 of its exact value relative to it (the standard
# bound), so the two within twice that. At the JAX suite's 8 spp
# (tests/test_parallel.py) that is 8.3e-7, its rtol 1e-6 (SHARD_RTOL, the
# floor); at config 5's 256 spp it is 3.0e-5. Sharded gradients at its gate for the kernel
# engine's (rtol 1e-3, atol 1e-7), the geometry gradient at its gate for
# geometry (rtol 1e-4) with an absolute floor of BWD_ATOL_SCALE of the
# largest entry; the split engine on the card against itself on the CPU at
# tests/test_split.py's tolerance (rtol 2e-4, atol 2e-5). The two-process
# run is killed after MP_TIMEOUT seconds.
MAIN_BLOCKS = 4
RAGGED_BLOCKS = (19, 45, (7, 12))
SHARD_RTOL = SHARD_ATOL = 1e-6


def spp_split_rtol(spp: int) -> float:
    """The tolerance of a render whose samples were split against the
    unsplit one (see SHARD_RTOL)."""
    return max(SHARD_RTOL, 2 * (spp - 1) * 2.0**-24)
SHARD_GRAD_RTOL, SHARD_GRAD_ATOL = 1e-3, 1e-7
GEOM_GRAD_RTOL = 1e-4
SPLIT_RTOL, SPLIT_ATOL = 2e-4, 2e-5
MP_TIMEOUT = 300


def log(msg: str) -> None:
    print(msg, flush=True)


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


def big_table_scene(pt, dev):
    """Two spheres, a floor and a wall of 1000 small triangles, every seventh
    a light: tables above the shared budget of the forward kernels
    (tests/test_torch_cuda.py's scene)."""
    b = pt.SceneBuilder(sky_color=(0.3, 0.4, 0.6))
    grey = b.add_material(albedo=(0.5, 0.5, 0.5), roughness=0.6)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.9, 0.8),
                          emission_strength=5.0)
    b.add_sphere(center=(0.0, 0.0, 5.0), radius=1.0, material=grey)
    b.add_sphere(center=(1.5, 1.5, 4.0), radius=0.3, material=lamp)
    b.add_triangle(v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50), material=grey)
    for i in range(1000):
        x, y = i % 40 - 20.0, i // 40 - 12.0
        b.add_triangle(v0=(x, y, 9.0), v1=(x + 0.9, y, 9.0), v2=(x, y + 0.9, 9.0),
                       material=grey if i % 7 else lamp)
    return b.build(dev)


def check_instantiations(kernel, variant_fn, args, kw, ref, what) -> None:
    """Each measurement instantiation of a forward kernel (``VARIANTS``)
    against the twin's image ``ref``, value for value; where the scene's
    tables exceed the shared budget the shared ones must refuse it and the
    others still agree."""
    from path_tracer_c_tpu_torch.ops import render_kernel as rk

    for variant in rk.VARIANTS:
        if (rk.policy(variant)["tables"] == "shared"
                and rk.table_bytes(args[0], kernel == "B3") > rk.SHARED_TABLE_BUDGET):
            try:
                variant_fn(*args, variant, **kw)
            except ValueError:
                continue
            raise AssertionError(f"{what}: {variant} took tables above the shared budget")
        compare_exact(variant_fn(*args, variant, **kw), ref, f"{what} {kernel} {variant}")


def check_physical_rounds(args, kw, twin, what) -> dict:
    """The counting instantiations of B3 (timed kernel and measurement
    instantiations) against the twin's warp groupings ``twin``
    (``render_physical.WarpGroupings``): each counts its schedule's rounds,
    and those with a light sample and a shadow scan, as the twin groups
    them. Returns the counts by instantiation."""
    from path_tracer_c_tpu_torch.ops import render_kernel as rk
    from path_tracer_c_tpu_torch.ops import render_physical as rp

    out = {}
    for variant in (None, *rk.VARIANTS):
        if (variant and rk.policy(variant)["tables"] == "shared"
                and rk.table_bytes(args[0], True) > rk.SHARED_TABLE_BUDGET):
            continue  # refused: check_instantiations holds it to that
        got = rp.render_physical_kernel_round_counts(*args, variant=variant, **kw)
        if got != {k: twin[k] for k in got}:
            raise AssertionError(f"{what} {variant or 'kernel'}: rounds {got}, twin {twin}")
        out[variant or "kernel"] = {k: v for k, v in got.items() if "lane_rounds" in k}
    return out


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


def ulp_distance(a, b):
    """|a - b| in float32 units in the last place: the distance between the
    two values' places on the ordered line of float32 values."""
    import torch

    ia, ib = (x.contiguous().view(torch.int32).to(torch.int64) for x in (a, b))
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


def sass_counts(patterns: dict, opcode: str) -> dict:
    """Instructions whose opcode matches the regular expression ``opcode``,
    by opcode, in the SASS of each kernel whose mangled name contains every
    string of ``patterns[key]``, from cuobjdump on the built library
    (``ops/build.sass_opcodes``)."""
    from path_tracer_c_tpu_torch.ops import build

    found = {}
    for name, counts in build.sass_opcodes(opcode).items():
        key = next((k for k, pats in patterns.items() if all(p in name for p in pats)), None)
        if key is not None:
            found[key] = {op: n for op, n in counts.items() if op != "instructions"}
    if set(found) != set(patterns):
        raise AssertionError(f"SASS: kernels {sorted(set(patterns) - set(found))} not found")
    return found


def ptxas_resources(kernel: str) -> dict:
    """Registers, stack frame and spill bytes that ptxas reported for each
    instantiation of ``kernel`` (by its template arguments in the mangled
    name), from the build's ``-Xptxas -v`` lines (``ops/build.ptxas_entries``)."""
    from path_tracer_c_tpu_torch.ops import build

    found = {}
    for name, resources in build.ptxas_entries(build.resource_usage()).items():
        if kernel in name:
            m = re.search(kernel + r"I(.*?)EEvP", name)
            found[m.group(1) if m else name] = resources
    return found


def sass_global_loads(patterns: dict) -> dict:
    """Global loads (LDG instructions) in the SASS of each kernel whose
    mangled name contains ``patterns[key]``."""
    found = sass_counts({k: (p,) for k, p in patterns.items()}, r"LDG(?:\.[A-Z0-9.]+)?")
    return {k: sum(v.values()) for k, v in found.items()}


def speed_of_light(dev, card, glossy, cam, specs, twin_rounds) -> dict:
    """Phase 14: B6, B7 and B8 against their twins; the warp lane-rounds of
    B1's and B3's counting instantiations against the twins' grouping; the
    speed-of-light path (the op rates and the decomposition of B1's time)
    with its launches counted; B3's decomposition; the ALU rate's
    saturation; the probes' times; ``sol_report`` of B1-B5 from phase 13's
    times; the decompositions of B2's, B4's and B5's times; B5's SASS.
    ``specs``: kernel name -> (flops kind, events, keywords, milliseconds);
    ``twin_rounds``: ``round_groupings`` of B2's and B4's twins and B5's
    twin's counts at the main shape, by ``fused_decompose`` kind. Returns the
    measured bounds of B1-B5, B2's, B4's and B5's rounds and decompositions, B1's and B3's schedules, rounds and
    decompositions, the new kernels' entries, and B1's launches on this
    path."""
    import torch

    from path_tracer_c_tpu_torch.ops import render_kernel as rk
    from path_tracer_c_tpu_torch.ops import sol_probes as sp
    from path_tracer_c_tpu_torch.utils import flops
    from path_tracer_c_tpu_torch.utils.sol_decompose import fused_decompose, sol_decompose

    threads = flops.default_threads(dev)
    x = torch.linspace(-1.0, 1.0, threads, device=dev)
    log(f"calibration kernel vs plain twin ({threads} threads, {CALIB_CHECK_REPS}x"
        f"{flops.CALIB_UNROLL} dependent steps, within {CALIB_ULPS} ulp):")
    calib_err = 0.0
    for kind in flops.CLASSES:
        k = flops.calib_kernel(kind, CALIB_CHECK_REPS, x)
        r = flops.calib_reference(kind, CALIB_CHECK_REPS, x)
        torch.cuda.synchronize()
        ulps = ulp_distance(k, r)
        calib_err = max(calib_err, float((k - r).abs().max()))
        log(f"  {kind}: exact {float((ulps == 0).double().mean()):.6f}, largest "
            f"{int(ulps.max())} ulp, max |delta| {float((k - r).abs().max()):.3g}")
        if not bool(torch.isfinite(k).all()) or int(ulps.max()) > CALIB_ULPS:
            raise AssertionError(f"calib {kind}: outside {CALIB_ULPS} ulp of the twin")

    log("null and micro probes vs plain twins (all must be equal):")
    table = sp.micro_table(dev)
    seed = torch.tensor([[7]], dtype=torch.int32, device=dev)
    for h, w in ((19, 45), (100, 160), (H, W)):
        compare_exact(sp.sol_null(glossy, cam, h, w), sp.sol_null_reference(glossy, cam, h, w),
                      f"sol_null {h}x{w}")
        ref = sp.sol_micro_reference(table, seed, h, w)
        for hoisted in (False, True):
            compare_exact(sp.sol_micro(table, seed, h, w, hoisted), ref,
                          f"sol_micro {h}x{w} {'hoisted' if hoisted else 'reload'}")
    loads = sass_global_loads({"reload": "sol_micro_kernelILi0E", "hoisted": "sol_micro_kernelILi8E"})
    log(f"  SASS global loads: reload variant {loads['reload']}, hoisted variant "
        f"{loads['hoisted']} (the table is {5 * sp.MICRO_NOBJ} floats)")
    if not loads["reload"] < loads["hoisted"]:
        raise AssertionError("sol_micro: the reload variant's loads were hoisted as well")

    log("forward kernels' warp lane-rounds vs the plain twins' grouping for each schedule "
        "(timed kernel and measurement instantiations):")
    from path_tracer_c_tpu_torch.ops import render_physical as rp

    for what, args, kw in (("glossy 19x45 4spp 8b (ragged)", (glossy, cam, 19, 45, 4, 8, 7), {}),
                           ("glossy 100x160 4spp 8b jitter, offset 3",
                            (glossy, cam, 100, 160, 4, 8, 7), dict(jitter=True, sample_offset=3)),
                           (f"glossy {H}x{W} {SPP}spp {BOUNCES}b (main shape)",
                            (glossy, cam, H, W, SPP, BOUNCES, 1), {})):
        twin = rk.render_kernel_round_counts_reference(*args, **kw)
        for variant in (None, *rk.VARIANTS):
            got = rk.render_kernel_round_counts(*args, variant=variant, **kw)
            if got != {k: twin[k] for k in got}:
                raise AssertionError(f"{what} {variant or 'kernel'}: rounds {got}, twin {twin}")
        nominal = args[2] * args[3] * args[4] * (args[5] + 1)
        log(f"  B1 {what}: twin {twin}, nominal {nominal}; every counting instantiation equal")
        if twin["thread_rounds"] != rk.render_kernel(*args, count_rounds=True, **kw)[1]:
            raise AssertionError(f"{what}: thread-rounds differ from count_rounds'")
        if not (0 < twin["thread_rounds"] <= twin["warp_lane_rounds_regen"]
                <= twin["warp_lane_rounds"] <= nominal):
            raise AssertionError(f"{what}: thread <= regen <= per-sample <= nominal does not hold")
    fwd_twin_rounds = twin
    args, kw = (glossy, cam, 19, 45, 4, 8, 7), dict(jitter=True, sample_offset=3)
    what = f"B3 glossy 19x45 4spp 8b {kw} (ragged)"
    groups = rp.WarpGroupings(19, 45, 4, 8, dev)
    ref = rp.render_physical_kernel_reference(*args, on_round=groups.add_round, **kw)
    compare_exact(rp.render_physical_kernel(*args, **kw), ref, what)
    check_instantiations("B3", rp.render_physical_kernel_variant, args, kw, ref, what)
    log(f"  {what}: {check_physical_rounds(args, kw, groups.counts(), what)}, equal to the "
        f"twin's")

    # The speed-of-light path: the four rates, then B1's decomposition.
    since = _Launches()
    t0 = time.perf_counter()
    rates, samples = flops.measure_op_rates(dev, with_spread=True)
    decomposition = sol_decompose(dev, rates=rates)
    sol_seconds = time.perf_counter() - t0
    n_calib, n_null, n_micro, n_fwd = (since[k] for k in ("calib", "sol_null", "sol_micro",
                                                          "render_fwd"))
    log(f"speed-of-light path: measure_op_rates + sol_decompose in {sol_seconds:.1f} s launched "
        f"calib {n_calib}, sol_null {n_null}, sol_micro {n_micro}, render_kernel {n_fwd} time(s)")
    if min(n_calib, n_null, n_micro, n_fwd) < 1:
        raise AssertionError("the speed-of-light path did not launch every kernel")
    for cls in flops.CLASSES:
        log(f"rate {cls}: {rates[cls]:.4e} op/s (pairs {min(samples[cls]):.4e} to "
            f"{max(samples[cls]):.4e}) [{card}]")
        if not rates[cls] > 0:
            raise AssertionError(f"rate {cls} is not positive")
    log("sol_decompose " + json.dumps(decomposition))
    phys_decomposition = sol_decompose(dev, rates=rates, kind="physical")
    log(f"sol_decompose physical [{card}] " + json.dumps(phys_decomposition))
    alu2 = flops.measure_op_rate("alu", device=dev, threads=2 * threads)
    saturation = alu2 / rates["alu"]
    log(f"rate alu at {2 * threads} threads: {alu2:.4e} op/s, {saturation:.4f} x the rate at "
        f"{threads} [{card}]")
    if abs(saturation - 1.0) > 0.05:
        raise AssertionError("the ALU rate does not saturate at the default launch size")

    # The measurement instantiations that price B2's and B4's time compute
    # the kernels' image and, but for the sinks, their planes.
    from path_tracer_c_tpu_torch.ops import render_grad as rg
    from path_tracer_c_tpu_torch.ops import render_physical_grad as pg

    log("B2's and B4's measurement instantiations vs the kernels (all must be equal):")
    for h, w, bounces in ((37, 45, 3), (100, 160, 8)):
        args = (glossy, cam, h, w, 4, bounces, 7)
        out = {"B2": rg.render_fused(*args, jitter=True),
               "B4": pg.render_physical_fused(*args, n_em_cap=1)}
        for variant in rg.VARIANTS.keys() | pg.VARIANTS.keys():
            if variant == "registers" and bounces >= rg.REGISTER_ROUNDS:
                continue
            got = {}
            if variant in rg.VARIANTS:
                got["B2"] = rg.render_fused_variant(*args, variant, jitter=True)
            if variant in pg.VARIANTS:
                got["B4"] = pg.render_physical_fused_variant(*args, variant, n_em_cap=1)
            for name, v in got.items():
                what = f"{name} {variant} glossy {h}x{w} 4spp {bounces}b"
                compare_exact(v[0], out[name][0], what + " image")
                if variant != "sink":
                    for a, b in zip(v[1:], out[name][1:]):
                        compare_exact(a, b, what + " planes")

    # What ptxas gave B2's and B4's instantiations: B2's are those of the
    # parent's (its policies did not change); B4's show what each policy
    # costs in registers and spills.
    ptxas = {name: ptxas_resources(kernel) for name, kernel in (
        ("render_fused", "render_fused_kernel"), ("render_phys_fused", "render_phys_fused_kernel"))}
    for name, found in ptxas.items():
        log(f"  ptxas {name} (registers, stack, spill stores and loads by instantiation): "
            + json.dumps(found))
        if not found or any("registers" not in v for v in found.values()):
            raise AssertionError(f"ptxas: no resource lines for {name}")

    # Where B2's, B4's and B5's times go, at the measured rates.
    fused_parts = {}
    for kind, name in (("fused", "render_fused"), ("physical_fused", "render_phys_fused"),
                       ("physical_bwd", "render_phys_bwd")):
        d = fused_decompose(kind, dev, rates=rates, twin_counts=twin_rounds[kind])
        log(f"fused_decompose {kind} [{card}] " + json.dumps(d))
        fused_parts[name] = {
            "warp_lane_rounds": d["warp_lane_rounds"],
            "decomposition": {k: v for k, v in d.items()
                              if k.endswith("_fraction") and not k.startswith("vs_")}}
        if name in ptxas:
            fused_parts[name]["ptxas"] = ptxas[name]
        if kind == "physical_fused":
            fused_parts[name].update(
                kernel_policy=d["kernel_policy"], plane_adds=d["plane_adds"],
                **{k: d[k] for k in d if k.startswith("pixel_constant_adds_share")},
                policy_prices={k: v for k, v in d.items() if k.startswith("vs_")})
        if kind == "physical_bwd":
            fused_parts[name].update(counts=d["counts"], atomics=d["atomics"],
                                     sink_ms=d["sink_seconds"] * 1e3,
                                     shared_records_ms=d["shared_records_seconds"] * 1e3)
        else:
            fused_parts[name]["warp_lane_rounds_regen"] = d["warp_lane_rounds_regen"]

    # B5's adds in SASS: the timed kernel adds into its warps' tables with
    # plain stores, no shared atomics; its sink's one float atomicAdd a pixel
    # shows the form such an add takes.
    bwd_sass = sass_counts(
        {"kernel": ("render_phys_bwd_kernelILb0ELb0E", "LocalStores", "10WarpTables"),
         "kernel, tri_nee": ("render_phys_bwd_kernelILb0ELb1E", "LocalStores", "10WarpTables"),
         "sink": ("render_phys_bwd_kernelILb0ELb0E", "10SinkReduce")},
        r"ATOMS(?:\.[A-Z0-9.]+)?|MATCH\.ANY|SHFL\.IDX")
    log(f"  SASS of B5's instantiations (shared atomics, matches, shuffles): {bwd_sass}")
    if any(op.startswith("ATOMS") for k in ("kernel", "kernel, tri_nee") for op in bwd_sass[k]):
        raise AssertionError("B5's timed kernel issues shared atomics")
    fused_parts["render_phys_bwd"]["sass"] = bwd_sass

    # Times of the new kernels and their twins.
    xs = torch.full((threads,), 1.0, device=dev)
    calib_ms = median_ms(lambda s: flops.calib_kernel("alu", CALIB_TIMED_REPS, xs))
    calib_twin_ms = median_ms(lambda s: flops.calib_reference("alu", CALIB_TIMED_REPS, xs))
    calib_full_ms = median_ms(lambda s: flops.calib_kernel("alu", flops.CALIB_REPS["alu"], xs))
    null_call_ms = median_ms(lambda s: sp.sol_null(glossy, cam, H, W))
    launch = sp.sol_null_launcher(glossy, cam, H, W)
    null_ms = median_ms(lambda s: [launch() for _ in range(20)]) / 20  # the kernel alone
    null_twin_ms = median_ms(lambda s: sp.sol_null_reference(glossy, cam, H, W))
    micro_ms = median_ms(lambda s: sp.sol_micro(table, seed, H, W, False))
    hoisted_ms = median_ms(lambda s: sp.sol_micro(table, seed, H, W, True))
    micro_twin_ms = median_ms(lambda s: sp.sol_micro_reference(table, seed, H, W))
    where = f"glossy {H}x{W}"
    calib_at = f"alu chain, {threads} threads, {CALIB_TIMED_REPS}x{flops.CALIB_UNROLL} steps"
    log(f"time calib ({calib_at}): {calib_ms:.4f} ms, twin {calib_twin_ms:.3f} ms; at "
        f"{flops.CALIB_REPS['alu']}x{flops.CALIB_UNROLL} steps {calib_full_ms:.3f} ms [{card}]")
    log(f"time sol_null {where}: {null_ms:.4f} ms a launch on packed operands, {null_call_ms:.4f} "
        f"ms a call, twin {null_twin_ms:.4f} ms; sol_micro: "
        f"reload {micro_ms:.4f} ms, hoisted {hoisted_ms:.4f} ms, twin {micro_twin_ms:.3f} ms "
        f"[{card}]")

    # sol_report of B1-B5 at phase 13's times, and every kernel's bound at the
    # measured rates.
    transc = {c: rates[c] for c in flops.CLASSES[1:]}
    measured = {}
    for name, (kind, events, kw, ms) in specs.items():
        rep = flops.sol_report(kind, glossy, H, W, SPP, BOUNCES, ms * 1e-3, events, **kw,
                               alu_rate=rates["alu"], transc_rate=transc)
        counts = flops.kernel_op_counts(kind, glossy, H, W, SPP, BOUNCES, events, **kw)
        bound, by = flops.measured_bound_ms(counts, rates)
        measured[name] = {"measured_bound_ms": bound, "measured_bound_by": by,
                          "sol_fraction": bound / ms}
        log(f"sol_report {name} ({kind}): {ms:.3f} ms, {rep['alu_ops']:.4e} alu and "
            f"{rep['sqrt_ops']:.4e} sqrt ops, sol {rep['sol_seconds'] * 1e3:.3f} ms, "
            f"sol_fraction {rep['sol_fraction']:.4f}; bound at the measured rates {bound:.3f} ms "
            f"by {by} [{card}]")

    def entry(name, source, replaces, launches, path, err, ms, plain_ms, counts, timed_at, **extra):
        bound, by = flops.bound_ms(counts)
        mbound, mby = flops.measured_bound_ms(counts, rates)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_by_path": {path: launches}, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": None, "measured_bound_ms": mbound, "measured_bound_by": mby,
                "sol_fraction": mbound / ms, "timed_at": timed_at, **extra}

    entries = [
        entry("render_calib", flops.SOURCE_CALIB, flops.REPLACES_CALIB, n_calib,
              "measure_op_rates", calib_err, calib_ms, calib_twin_ms,
              flops.calib_ops("alu", CALIB_TIMED_REPS, threads), calib_at,
              ms_default_reps=calib_full_ms, rates=rates, rate_samples=samples,
              alu_saturation=saturation),
        entry("sol_null", sp.SOURCE, sp.REPLACES, n_null, "sol_decompose", 0.0, null_ms,
              null_twin_ms, flops.probe_op_counts("sol_null", H, W),
              where + ", 20 launches back to back on operands packed once", ms_call=null_call_ms,
              per_block_startup_us=decomposition["per_block_startup_us"]),
        entry("sol_micro", sp.SOURCE, sp.REPLACES_MICRO, n_micro, "sol_decompose", 0.0, micro_ms,
              micro_twin_ms, flops.probe_op_counts("sol_micro", H, W), where + " reload variant",
              ms_hoisted=hoisted_ms, sass_global_loads=loads,
              per_table_load_ns=decomposition["per_table_load_ns"]),
    ]
    forward_parts = {}
    for name, d, twin in (("render_fwd", decomposition, fwd_twin_rounds),
                          ("render_phys", phys_decomposition, None)):
        forward_parts[name] = {
            "kernel_policy": d["kernel_policy"],
            "decomposition": {k: v for k, v in d.items()
                              if k.endswith("_of_fwd") or k == "sol_fraction"},
            "policy_prices": {k: v for k, v in d.items() if k.startswith("vs_")}}
        if twin is not None:
            forward_parts[name].update(warp_lane_rounds=twin["warp_lane_rounds"],
                                       warp_lane_rounds_regen=twin["warp_lane_rounds_regen"])
    return {"measured": measured, "fused": fused_parts, "forward": forward_parts,
            "entries": entries, "fwd_launches": n_fwd}


class _Interrupt(Exception):
    """Raised from inside a render's checkpoint save to stop it there."""


def _cli_quiet(cli_main, argv) -> str:
    """Run the CLI with its standard output captured; its last line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    return buf.getvalue().strip().splitlines()[-1]


def _npz_equal(a: Path, b: Path, what: str) -> None:
    import numpy as np

    with np.load(a) as za, np.load(b) as zb:
        if sorted(za.keys()) != sorted(zb.keys()):
            raise AssertionError(f"{what}: checkpoint keys differ")
        for k in za.keys():
            if not np.array_equal(za[k], zb[k]):
                raise AssertionError(f"{what}: checkpoint entry {k} differs")


@contextlib.contextmanager
def _recorded_calls(app):
    """Keep the arguments of every call the CLI makes to its renderer
    (``app._renderer``'s result), with the keywords it binds, so that the
    kernel can be held against its twin at exactly those inputs. The
    kernel's own launch count is untouched."""
    calls, real = [], app._renderer

    def renderer(cfg):
        render = real(cfg)
        bound = getattr(render, "keywords", {})

        def call(*a, **k):
            calls.append((a, {**bound, **k}))
            return render(*a, **k)

        return call

    app._renderer = renderer
    try:
        yield calls
    finally:
        app._renderer = real


def long_runs(pt, root: Path, dev, card: str, cli_main) -> dict:
    """Phase 15: the long-run entry points through the kernels. Returns the
    launches of each kernel on these paths and what was measured."""
    import torch

    from path_tracer_c_tpu_torch.app import main as app
    from path_tracer_c_tpu_torch.grad import diff
    from path_tracer_c_tpu_torch.ops import render_grad as rg
    from path_tracer_c_tpu_torch.ops import render_kernel as rk
    from path_tracer_c_tpu_torch.ops import render_physical as rp
    from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
    from path_tracer_c_tpu_torch.scene.io import save_scene
    from path_tracer_c_tpu_torch.utils import checkpoint as ck
    from path_tracer_c_tpu_torch.utils import native
    from path_tracer_c_tpu_torch.utils.bitmap import bitmap_bytes
    from path_tracer_c_tpu_torch.utils.config import AnimationConfig, FitConfig, load
    from path_tracer_c_tpu_torch.utils.metrics import rays_per_render
    from path_tracer_c_tpu_torch.utils.profiling import trace

    launches = {"render_fwd": {}, "render_phys": {}, "render_fused": {}, "render_phys_fused": {}}
    errs = {"render_fwd": 0.0, "render_phys": 0.0}
    result = {"card": card, "twins": {}}

    def hold_to_twin(name, kernel, twin, a, k, what):
        """The kernel against its plain twin on the card, value for value,
        at the arguments a main path gave it (launches made here are not
        the path's)."""
        t1 = time.perf_counter()
        errs[name] = max(errs[name], compare_exact(kernel(*a, **k), twin(*a, **k), what))
        torch.cuda.synchronize()
        result["twins"][what] = {"max_abs_err": errs[name],
                                 "seconds": time.perf_counter() - t1}
        log(f"long runs: {what}: kernel equal to its plain twin "
            f"({time.perf_counter() - t1:.1f} s)")

    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)

        # Chunked renders: one chunk and chunks of CHUNK_SPP, timed in turns
        # on the host's clock to the written BMP; then a run interrupted
        # inside its second checkpoint save and resumed.
        renders = (
            ("B1", "render_fwd", rk.render_kernel, rk.render_kernel_reference,
             ["--scene", "glossy", "--width", str(W), "--height", str(H), "--spp", str(SPP),
              "--max-bounces", str(BOUNCES)], "glossy 1024x1024 64spp 8b"),
            ("B3", "render_phys", rp.render_physical_kernel, rp.render_physical_kernel_reference,
             ["--config", str(root / PHYS_CONFIG)], PHYS_CONFIG),
        )
        for label, name, kernel, twin, base, where in renders:
            every = ["--checkpoint-every", str(CHUNK_SPP)]
            runs = {"one chunk": [], "chunked": [], "chunked, saved": []}
            order = ("one chunk", "chunked", "chunked, saved", "chunked, saved", "chunked",
                     "one chunk")
            since = _Launches()
            for i, kind in enumerate(order):
                out = tmp / f"{label}_{i}.bmp"
                argv = ["render", *base, "--out", str(out)]
                if kind != "one chunk":
                    argv += every
                if kind == "chunked, saved":
                    argv += ["--checkpoint-path", str(tmp / f"{label}_{i}.npz")]
                t0 = time.perf_counter()
                with _recorded_calls(app) as calls:
                    _cli_quiet(cli_main, argv)
                runs[kind].append((time.perf_counter() - t0) * 1e3)
                if i == 1:
                    chunk_calls = calls
                if kind != "one chunk":
                    ref = tmp / f"{label}_1.bmp"
                    if out.read_bytes() != ref.read_bytes():
                        raise AssertionError(f"{label}: chunked renders differ")
            path = tmp / f"{label}_resumed.npz"
            out = tmp / f"{label}_resumed.bmp"
            saves, real_save = [], ck.save_render

            def save_then_stop(p, c):
                real_save(p, c)
                saves.append(c.spp_done)
                if len(saves) == 2:
                    raise _Interrupt

            ck.save_render = save_then_stop
            try:
                _cli_quiet(cli_main, ["render", *base, *every, "--checkpoint-path", str(path),
                                      "--out", str(out)])
                raise AssertionError(f"{label}: the interrupted render ran to its end")
            except _Interrupt:
                pass
            finally:
                ck.save_render = real_save
            if out.exists() or ck.load_render(path).spp_done != 2 * CHUNK_SPP:
                raise AssertionError(f"{label}: the interruption did not stop after two chunks")
            line = _cli_quiet(cli_main, ["render", *base, *every, "--checkpoint-path", str(path),
                                         "--out", str(out)])
            data = out.read_bytes()
            check_bmp(data, W, H)
            if data != (tmp / f"{label}_1.bmp").read_bytes():
                raise AssertionError(f"{label}: the resumed render differs from the chunked one")
            _npz_equal(path, tmp / f"{label}_2.npz", f"{label} resumed")
            n = since[name]
            launches[name][f"render --checkpoint-every {CHUNK_SPP} (6 renders, one interrupted "
                           f"and resumed)"] = n
            expected = 2 + 4 * (SPP // CHUNK_SPP) + SPP // CHUNK_SPP
            if n != expected:
                raise AssertionError(f"{label}: {n} launches, expected {expected}")
            # The last chunk as the chunked run gave it to the kernel.
            last = SPP - CHUNK_SPP
            a, k = next((a, k) for a, k in chunk_calls if k["sample_offset"] == last)
            hold_to_twin(name, kernel, twin, a, k, f"{label} {where}: the chunk of {CHUNK_SPP} "
                         f"spp at sample_offset {last}")
            med = {k: statistics.median(v) for k, v in runs.items()}
            result[f"{label} chunking"] = {"where": where, "ms": runs, "median_ms": med,
                                           "chunk_spp": CHUNK_SPP}
            log(f"long runs: {label} CLI `render` {where}, resumed after 2 of "
                f"{SPP // CHUNK_SPP} chunks: BMP and accumulator equal to the uninterrupted "
                f"chunked run's ({line}); {n} launches")
            log(f"long runs: {label} CLI wall ms to the BMP, in turns: "
                + "; ".join(f"{k} {', '.join(f'{x:.1f}' for x in v)}" for k, v in runs.items())
                + f"; chunks of {CHUNK_SPP} cost {med['chunked'] - med['one chunk']:+.1f} ms, "
                f"saving them {med['chunked, saved'] - med['chunked']:+.1f} ms [{card}]")

        # --debug-nans through B1 on a scene whose emission is NaN.
        nan_scene = pt.demo.diffuse_sphere_scene("cpu")
        nan_scene = dataclasses.replace(nan_scene, materials=dataclasses.replace(
            nan_scene.materials, emission_strength=torch.full_like(
                nan_scene.materials.emission_strength, float("nan"))))
        save_scene(tmp / "nan_scene.json", nan_scene)
        since = _Launches()
        try:
            _cli_quiet(cli_main, ["render", "--scene", str(tmp / "nan_scene.json"), "--width",
                                  "256", "--height", "256", "--spp", "4", "--max-bounces", "4",
                                  "--debug-nans", "--out", str(tmp / "nan.bmp")])
            raise AssertionError("--debug-nans: no FloatingPointError")
        except FloatingPointError as e:
            nan_msg = str(e)
        if since["render_fwd"] != 1 or (tmp / "nan.bmp").exists():
            raise AssertionError("--debug-nans: not one kernel launch, or a BMP written")
        launches["render_fwd"]["render --debug-nans"] = 1
        log(f"long runs: CLI `render --debug-nans` on a NaN scene through B1 raised: {nan_msg}")

        # The config-5 sweep on one card: its mesh set to 1x1 and 8 frames,
        # with the native writer and with numpy's, in turns.
        raw = json.loads((root / SWEEP_CONFIG).read_text())
        raw["render"]["mesh"] = {"tile": 1, "spp": 1}
        raw["frames"] = SWEEP_FRAMES
        acfg = load(root / SWEEP_CONFIG, AnimationConfig)
        r = acfg.render
        result["sweep"] = {"config": SWEEP_CONFIG, "reduced": [
            f"mesh {acfg.render.mesh.tile}x{acfg.render.mesh.spp} -> 1x1 (one card; phase 16 "
            f"lays the mesh on cuda:0 repeated for one frame)",
            f"frames {acfg.frames} -> {SWEEP_FRAMES} (time limit)"],
            "shape": f"{r.scene} {r.width}x{r.height} {r.spp}spp {r.max_bounces}b engine {r.engine}"}
        if not native.available():
            raise AssertionError("the native library did not build: the sweep needs its writer")
        real_available = native.available
        frame_ms = {"native": [], "numpy": []}
        window_ms = {"native": [], "numpy": []}
        frame_paths = {}
        since = _Launches()
        # In turns, then once more with the native writer under the profiler.
        for i, writer in enumerate(("native", "numpy", "numpy", "native", "native")):
            raw["out_dir"] = str(tmp / f"frames_{i}")
            cfg_path = tmp / f"sweep_{i}.json"
            cfg_path.write_text(json.dumps(raw))
            metrics = tmp / f"sweep_{i}.jsonl"
            traced = i == 4
            if writer == "numpy":
                native.available = lambda: False
            try:
                with contextlib.ExitStack() as stack:
                    calls = stack.enter_context(_recorded_calls(app))
                    prof = stack.enter_context(trace(str(tmp / "sweep_trace"))) if traced else None
                    t0 = time.perf_counter()
                    _cli_quiet(cli_main, ["animate", "--config", str(cfg_path), "--metrics",
                                          str(metrics)])
                    seconds = time.perf_counter() - t0
            finally:
                native.available = real_available
            if i == 0:
                sweep_calls = calls
            *recs, spans = [json.loads(x) for x in metrics.read_text().splitlines()]
            if spans["kind"] != "spans" or spans["counters"]["launch.render_fwd"] != SWEEP_FRAMES:
                raise AssertionError(f"sweep {i}: the last record is not the spans record of "
                                     f"{SWEEP_FRAMES} launches: {spans}")
            frames = [x for x in recs if x["kind"] == "frame"]
            if len(frames) != SWEEP_FRAMES or {x["writer"] for x in recs} != {writer}:
                raise AssertionError(f"sweep {i}: frames {len(frames)}, writers "
                                     f"{ {x['writer'] for x in recs} }, expected {writer}")
            frame_paths[i] = sorted(Path(raw["out_dir"]).glob("frame_*.bmp"))
            # The sweep's window after frame 0 was handed over (the rest
            # rendered, handed over and drained) over its frames.
            total = next(x for x in recs if x["kind"] == "animate")["seconds"]
            window = (total - frames[0]["seconds"]) * 1e3 / (SWEEP_FRAMES - 1)
            if traced:
                from torch.autograd import DeviceType

                device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                                if e.device_type == DeviceType.CUDA) / 1e3
                b1_ms = sum(e.self_device_time_total for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA and "render_fwd" in e.key) / 1e3
                result["sweep"]["traced"] = {
                    "writer": writer, "seconds": total, "device_busy_ms": device_ms,
                    "b1_device_ms": b1_ms, "device_busy_share": device_ms / (total * 1e3),
                    "ms_per_frame_after_first": window}
                log(f"long runs: sweep {i} (writer {writer}, under torch.profiler): "
                    f"{total * 1e3:.1f} ms, device busy {device_ms:.1f} ms "
                    f"({device_ms / (total * 1e3):.1%}; B1 {b1_ms:.1f} ms), {window:.1f} ms a "
                    f"frame after the first [{card}]")
                continue
            frame_ms[writer].append([x["seconds"] * 1e3 for x in frames])
            window_ms[writer].append(window)
            log(f"long runs: sweep {i} (writer {writer}): {seconds:.4f} s for {SWEEP_FRAMES} "
                f"frames, {window:.2f} ms a frame after the first; gaps between hand-overs ms "
                + ", ".join(f"{x:.1f}" for x in frame_ms[writer][-1]) + f" [{card}]")
        sweep_launches = since["render_fwd"]
        if sweep_launches != 5 * SWEEP_FRAMES:
            raise AssertionError(f"sweep: {sweep_launches} launches of B1")
        launches["render_fwd"][f"animate config 5 ({SWEEP_FRAMES} frames, 5 runs)"] = sweep_launches
        for i in (1, 2, 3, 4):
            if [p.read_bytes() for p in frame_paths[i]] != [p.read_bytes() for p in frame_paths[0]]:
                raise AssertionError(f"sweep {i}: frames differ from sweep 0's")
        # Frame 0 as the sweep gave it to B1: the kernel against its twin
        # there, and at its last samples (spp 4 at sample_offset spp - 4).
        data = frame_paths[0][0].read_bytes()
        check_bmp(data, r.width, r.height)
        a, k = sweep_calls[0]
        acfg.frames = SWEEP_FRAMES
        cam0 = app._orbit_cameras(acfg, dev)[0]
        if a[2:] != (r.height, r.width, r.spp, r.max_bounces, r.seed) or not all(
                torch.equal(getattr(a[1], f.name), getattr(cam0, f.name))
                for f in dataclasses.fields(cam0)):
            raise AssertionError(f"sweep frame 0: not config 5's frame-0 render: {a[2:]}")
        where0 = f"sweep frame 0 {r.scene} {r.width}x{r.height} {r.spp}spp {r.max_bounces}b"
        hold_to_twin("render_fwd", rk.render_kernel, rk.render_kernel_reference, a, k, where0)
        tail = (*a[:4], 4, *a[5:])
        hold_to_twin("render_fwd", rk.render_kernel, rk.render_kernel_reference, tail,
                     {**k, "sample_offset": r.spp - 4},
                     f"{where0}: spp 4 at sample_offset {r.spp - 4}")
        img = rk.render_kernel(*a, **k)
        if bitmap_bytes(pt.render_image_u8(img).cpu().numpy()) != data:
            raise AssertionError("sweep frame 0 differs from the encoded kernel image")
        del img
        sweep_kernel_ms = median_ms(lambda seed: rk.render_kernel(*a[:6], seed, **k), warm=(1,))
        per = {}
        for writer, runs in frame_ms.items():
            gaps = sorted(x for run in runs for x in run[1:])  # frame 0 fills the pipeline
            per[writer] = {"ms_per_frame_after_first": window_ms[writer],
                           "gap_median_ms": statistics.median(gaps), "gap_min_ms": gaps[0],
                           "gap_max_ms": gaps[-1], "first_frame_ms": [run[0] for run in runs]}
        result["sweep"].update({"per_frame": per, "b1_alone_ms": sweep_kernel_ms,
                                "nominal_rays": rays_per_render(r.height, r.width, r.spp,
                                                                r.max_bounces)})
        log(f"long runs: config-5 sweep, ms a frame after the first (window / frames, each "
            f"run): " + "; ".join(f"{w} writer " + ", ".join(f"{x:.2f}" for x in p[
                "ms_per_frame_after_first"]) for w, p in per.items())
            + f"; B1 alone at that shape {sweep_kernel_ms:.1f} ms; frame 0 decoded, equal to "
            f"the encoded kernel image [{card}]")

        # Resumed fits: config 4 on B2, the geometry fit on B4, each stopped
        # at half its steps and resumed, against the uninterrupted run.
        fit_scene = tmp / "light_fit_scene.json"
        save_scene(fit_scene, light_fit_scene(pt, "cpu"))
        geo_cfg = tmp / "geometry_fit.json"
        geo_cfg.write_text(json.dumps({
            "render": {"width": 128, "height": 128, "spp": 32, "max_bounces": 3,
                       "scene": str(fit_scene), "engine": "physical_pallas", "seed": 0},
            "steps": 60, "lr": 0.03}))
        fits = (("B2", "render_fused", rg.render_fused, str(root / FIT_CONFIG), []),
                ("B4", "render_phys_fused", pg.render_physical_fused, str(geo_cfg),
                 ["--mode", "geometry"]))
        for label, name, kernel, cfg_path, mode in fits:
            steps = load(cfg_path, FitConfig).steps
            every = ["--checkpoint-every", str(max(1, steps // 10))]
            since = _Launches()
            base = ["fit", "--config", cfg_path, *mode, *every]
            full = _cli_quiet(cli_main, base + ["--checkpoint-path", str(tmp / f"{label}_a.npz")])
            _cli_quiet(cli_main, base + ["--steps", str(steps // 2), "--checkpoint-path",
                                         str(tmp / f"{label}_b.npz")])
            resumed = _cli_quiet(cli_main, base + ["--checkpoint-path",
                                                   str(tmp / f"{label}_b.npz")])
            _npz_equal(tmp / f"{label}_a.npz", tmp / f"{label}_b.npz", f"{label} fit")
            strip = lambda s: re.sub(r"in [\d.]+s, ", "", s)
            if strip(full) != strip(resumed):
                raise AssertionError(f"{label} fit: lines differ: {full} / {resumed}")
            n = since[name]
            if n != 2 * steps:
                raise AssertionError(f"{label} fit: {n} launches for {2 * steps} steps")
            launches[name][" ".join(["fit", *mode, "--checkpoint-path (3 runs: whole, half, "
                                     "resumed)"])] = n
            log(f"long runs: {label} CLI `{' '.join(['fit', '--config', Path(cfg_path).name, *mode])}` "
                f"stopped at step {steps // 2} and resumed: variables, Adam's state and the "
                f"{steps} losses bit for bit those of the uninterrupted run ({resumed}); "
                f"{n} launches")

    # The eager tier's gradient at config 4's fit shape, with and without
    # each sample recomputed in backward: peak device memory.
    fcfg = load(root / FIT_CONFIG, FitConfig).render
    shape = (fcfg.height, fcfg.width, fcfg.spp, fcfg.max_bounces)
    spheres, cam = pt.demo.random_spheres_scene(dev), pt.Camera.reference(dev)
    target = rk.render_kernel(spheres, cam, *shape, 12345)
    mem = {}
    real_radiance = diff.render_radiance
    for remat in (True, False, True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if not remat:  # the same call with the recomputation turned off
            diff.render_radiance = lambda *a, remat, **k: real_radiance(*a, remat=False, **k)
        try:
            loss, d_scene = diff.loss_and_grad(spheres, target, cam, *shape, 1, engine="core")
        finally:
            diff.render_radiance = real_radiance
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        grad = d_scene.materials.albedo
        mem.setdefault(remat, []).append({"peak_bytes": torch.cuda.max_memory_allocated(),
                                          "resident_bytes": base_mem, "ms": ms,
                                          "loss": float(loss)})
        if not bool(torch.isfinite(grad).all()):
            raise AssertionError("remat pair: non-finite gradient")
        mem.setdefault(f"grad_{remat}", grad)
        del loss, d_scene, grad
    diff_max = float((mem.pop("grad_True") - mem.pop("grad_False")).abs().max())
    result["remat"] = {"shape": f"spheres32 {shape[1]}x{shape[0]} {shape[2]}spp {shape[3]}b",
                       "with": mem[True], "without": mem[False],
                       "grad_max_abs_delta": diff_max}
    walls = {k: ", ".join("%.0f" % m["ms"] for m in mem[k]) for k in (True, False)}
    log(f"long runs: loss_and_grad(engine='core') at config 4's fit shape: peak device memory "
        f"{mem[True][0]['peak_bytes'] / 2**20:.1f} MiB with remat (as it runs), "
        f"{mem[False][0]['peak_bytes'] / 2**20:.1f} MiB without; wall ms {walls[True]} / "
        f"{walls[False]}; d_albedo max |delta| {diff_max:.3g} [{card}]")
    return {"launches": launches, "result": result, "max_abs_err": errs}


def _row_blocks(h: int, parts) -> list:
    """``(row_start, rows)`` of the blocks: ``parts`` equal blocks, or the
    blocks of the heights ``parts`` names."""
    sizes = [h // parts] * parts if isinstance(parts, int) else list(parts)
    return [(sum(sizes[:i]), n) for i, n in enumerate(sizes)]


def _join(outs: list, width: int):
    """The blocks' outputs as one: tensors concatenated along their rows
    (dim 0 of an (rows, W, 3) image, dim 1 of (planes, rows, W) planes),
    counts and dicts of counts summed."""
    import torch

    first = outs[0]
    if isinstance(first, torch.Tensor):
        dim = 0 if first.shape[-1] == 3 and first.shape[1] == width else 1
        return torch.cat(outs, dim=dim)
    if isinstance(first, dict):
        return {k: sum(o[k] for o in outs) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(_join([o[i] for o in outs], width) for i in range(len(first)))
    return sum(outs)


def check_row_blocks(what: str, fn, args, kw, parts) -> float:
    """``fn(*args, **kw)`` over the whole image against ``fn`` over its row
    blocks (``_row_blocks(H, parts)``), joined: every tensor, count and dict
    of counts equal. Returns the largest |delta| (0)."""
    import torch

    h, width = args[2], args[3]
    whole = fn(*args, **kw)
    joined = _join([fn(*args, row_start=r0, rows=n, **kw) for r0, n in _row_blocks(h, parts)],
                   width)
    items = (whole, joined) if isinstance(whole, tuple) else ((whole,), (joined,))
    worst = 0.0
    for a, b in zip(*items):
        if isinstance(a, torch.Tensor):
            if a.shape != b.shape:
                raise AssertionError(f"{what}: shapes {tuple(a.shape)}/{tuple(b.shape)}")
            worst = max(worst, float((a - b).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: the blocks differ from the whole (max |delta| "
                                     f"{worst:.3g})")
        elif a != b:
            raise AssertionError(f"{what}: the blocks' counts {b} differ from the whole's {a}")
    log(f"  {what}: {len(_row_blocks(h, parts))} blocks equal the whole")
    return worst


def check_block_rounds(what: str, fn, twin, args, kw, parts) -> None:
    """B1's counting over row blocks that do not start on a multiple of its
    warp footprint's height: a block's launch lays its own warps from its
    first row, so its warp lane-rounds are not those of the whole's rows.
    Each block's counts against the twin's grouping of that block (``twin``,
    the counting twin), and the blocks' thread-rounds summed against the
    whole's."""
    whole = fn(*args, **kw)["thread_rounds"]
    total = 0
    for r0, n in _row_blocks(args[2], parts):
        got = fn(*args, row_start=r0, rows=n, **kw)
        ref = twin(*args, row_start=r0, rows=n)
        if got != {k: ref[k] for k in got}:
            raise AssertionError(f"{what}: rows {r0}-{r0 + n - 1}: rounds {got}, twin {ref}")
        total += got["thread_rounds"]
    if total != whole:
        raise AssertionError(f"{what}: the blocks' thread-rounds {total}, the whole's {whole}")
    log(f"  {what}: {len(_row_blocks(args[2], parts))} blocks equal the twin's, thread-rounds "
        f"the whole's")


def row_block_checks(pt, dev, glossy, cam) -> None:
    """Phase 16a: B1-B4 and every instantiation (timed kernel, counting,
    measurement) over row blocks against the whole launch, at the main shape
    and at a ragged 19x45; B5's cotangents summed over the blocks against
    the whole's. B1's warp lane-rounds sum to the whole's where the blocks
    start on multiples of its footprint's height (4 rows at 8x16/4x8), and
    are held to the twin's block by block elsewhere (``check_block_rounds``)."""
    import torch
    from path_tracer_c_tpu_torch.ops import render_grad as rg
    from path_tracer_c_tpu_torch.ops import render_kernel as rk
    from path_tracer_c_tpu_torch.ops import render_physical as rp
    from path_tracer_c_tpu_torch.ops import render_physical_grad as pg

    log("row blocks: each block equals the same rows of the whole launch (images, planes, "
        "counters summed):")
    n_live = rp.live_emitter_count(glossy)
    rh, rw, rparts = RAGGED_BLOCKS
    for shape, parts, seed in (((H, W, SPP, BOUNCES), MAIN_BLOCKS, 1), ((rh, rw, 4, 8), rparts, 7)):
        args = (glossy, cam, *shape, seed)
        where = "{}x{} {}spp {}b".format(*shape)
        check_row_blocks(f"B1 {where}", rk.render_kernel, args, dict(count_rounds=True), parts)
        warp_rows = rk.tile_point(None, "fwd").wh
        aligned = all(r0 % warp_rows == 0 for r0, _ in _row_blocks(shape[0], parts))
        for v in (None, *rk.VARIANTS):
            if aligned:
                check_row_blocks(f"B1 counting {v or 'kernel'} {where}",
                                 rk.render_kernel_round_counts, args, dict(variant=v), parts)
            else:
                check_block_rounds(f"B1 counting {v or 'kernel'} {where}",
                                   rk.render_kernel_round_counts,
                                   rk.render_kernel_round_counts_reference, args, dict(variant=v),
                                   parts)
            if v:
                check_row_blocks(f"B1 {v} {where}", rk.render_kernel_variant, args[:7] + (v,),
                                 {}, parts)
        check_row_blocks(f"B2 {where}", rg.render_fused, args, dict(count_rounds=True), parts)
        check_row_blocks(f"B2 counting {where}", rg.render_fused_round_counts, args, {}, parts)
        for v in rg.VARIANTS:
            vargs = args if v != "registers" else args[:5] + (rg.REGISTER_ROUNDS - 1, seed)
            check_row_blocks(f"B2 {v} {where}", rg.render_fused_variant, vargs + (v,), {}, parts)
        check_row_blocks(f"B3 {where}", rp.render_physical_kernel, args,
                         dict(count_events=True), parts)
        for v in (None, *rk.VARIANTS):
            check_row_blocks(f"B3 counting {v or 'kernel'} {where}",
                             rp.render_physical_kernel_round_counts, args, dict(variant=v), parts)
            if v:
                check_row_blocks(f"B3 {v} {where}", rp.render_physical_kernel_variant,
                                 args + (v,), {}, parts)
        check_row_blocks(f"B4 {where} n_em_cap={n_live} tri_nee", pg.render_physical_fused, args,
                         dict(n_em_cap=n_live, count_events=True, tri_nee=True,
                              tri_em_cap=rp.live_tri_emitter_count(glossy)), parts)
        check_row_blocks(f"B4 {where} rough_grad", pg.render_physical_fused, args,
                         dict(rough_grad=True), parts)
        check_row_blocks(f"B4 counting {where}", pg.render_physical_fused_round_counts, args, {},
                         parts)
        for v in pg.VARIANTS:
            vargs = args if v != "registers" else args[:5] + (rg.REGISTER_ROUNDS - 1, seed)
            check_row_blocks(f"B4 {v} {where}", pg.render_physical_fused_variant, vargs + (v,),
                             dict(n_em_cap=n_live), parts)
        g = torch.randn((shape[0], shape[1], 3), generator=torch.Generator().manual_seed(3)).to(dev)
        whole, counts = pg.render_physical_bwd(glossy, cam, g, *shape, seed, n_em_cap=n_live,
                                               count_sites=True)
        counted = [pg.render_physical_bwd(glossy, cam, g[r0:r0 + n], *shape, seed,
                                          n_em_cap=n_live, row_start=r0, rows=n,
                                          count_sites=True)
                   for r0, n in _row_blocks(shape[0], parts)]
        blocks = [d for d, _ in counted]
        if {k: sum(c[k] for _, c in counted) for k in counts} != counts:
            raise AssertionError(f"B5 {where}: the blocks' counts do not sum to the whole's")
        leaves = [lf for lf in pg._GRAD_LEAVES if lf[0] != "triangles" and lf[1] != "roughness"]
        summed = pg.replace_leaves(whole, [
            (tb, nm, sum(getattr(getattr(b, tb) if tb else b, nm) for b in blocks))
            for tb, nm in leaves])
        compare_cotangents(summed, whole, leaves, f"B5 {where}: blocks summed vs whole (counts "
                                                  f"summed equal too)")


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(argv) -> int:
    """One process of phase 16's two-process render: ``--worker RANK WORLD
    PORT OUT``. Joins the group over gloo (NCCL takes one process a card,
    and both run on cuda:0), checks its health, renders glossy 1024^2, 64
    spp, 8 bounces through B1 on a 2x1 mesh of cuda:0 (one slot a process),
    and on rank 0 saves the image, the status and its time to OUT."""
    import torch

    rank, world, port, out = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import path_tracer_c_tpu_torch as pt
    from path_tracer_c_tpu_torch import parallel
    from path_tracer_c_tpu_torch.ops import render_kernel as rk

    dev = torch.device("cuda", 0)
    parallel.distributed.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        mesh = parallel.make_mesh(tile=world, spp=1, devices=[dev])
        status = parallel.distributed.health_check(mesh)
        glossy, cam = pt.demo.glossy_scene(dev), pt.Camera.reference(dev)
        since = _Launches()
        t0 = time.perf_counter()
        img = parallel.render_sharded(glossy, cam, H, W, SPP, BOUNCES, 1, mesh, engine="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = since["render_fwd"]
        if rank == 0:
            torch.save({"image": img.cpu(), "status": status, "seconds": seconds,
                        "launches": launches,
                        "backend": torch.distributed.get_backend()}, out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def two_process_render(root: Path, tmp: Path) -> dict:
    """Two processes on cuda:0 over gloo (``worker``), each killed after
    MP_TIMEOUT seconds; a worker that fails fails the phase. Returns rank
    0's record and the wall time from start to both exits."""
    import torch

    port, out = _free_port(), tmp / "rank0.pt"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(root / "chip_smoke.py"), "--worker", str(r),
                               "2", str(port), str(out)], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs, failed = [], False
    for p in procs:
        try:
            text, _ = p.communicate(timeout=max(1.0, MP_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            text, _ = p.communicate()
            failed = True
        logs.append(text)
        failed = failed or p.returncode != 0
    wall = time.perf_counter() - t0
    for q in procs:
        if q.poll() is None:
            q.kill()
            q.wait()
    if failed or not out.exists():
        raise AssertionError("two-process render failed:\n" + "\n".join(
            f"rank {r} (rc {p.returncode}):\n{t[-4000:]}" for r, (p, t) in
            enumerate(zip(procs, logs))))
    rec = torch.load(out)
    rec["wall_seconds"] = wall
    return rec


def check_spp_split(img, whole, shape, n_spp: int, render, what: str) -> None:
    """A render sharded over ``n_spp`` sample ranges: bit for bit against
    the fixed-order mean of ``render(spp / n_spp, offset)`` over the ranges
    (each range rendered unsharded), and against the unsplit render
    ``whole`` of ``shape`` (H, W, spp, ...) within spp_split_rtol; logs the
    share of values outside SHARD_RTOL."""
    import torch

    spp = shape[2]
    k = spp // n_spp
    acc = render(k, 0)
    for si in range(1, n_spp):
        acc = acc + render(k, si * k)
    if not torch.equal(img, acc / n_spp):
        raise AssertionError(f"{what}: differs from the mean of its sample ranges")
    rtol = spp_split_rtol(spp)
    torch.testing.assert_close(img, whole, rtol=rtol, atol=SHARD_ATOL)
    d = (img - whole).abs()
    rel = float((d / whole.abs().clamp_min(1e-30)).max())
    out = float((d > SHARD_ATOL + SHARD_RTOL * whole.abs()).double().mean())
    log(f"  {what}: the mean of its sample ranges bit for bit; against the unsplit render max "
        f"|delta| {float(d.max()):.3g}, max relative {rel:.3g} (rtol {rtol:.3g} for {spp} spp), "
        f"share outside rtol {SHARD_RTOL} {out:.4f}")


def sharded_runs(pt, root: Path, dev, card: str, cli_main, glossy, cam) -> dict:
    """Phase 16: row blocks, then the parallel layer on one card, its slots
    on cuda:0 repeated: config 5's frame through B1 on 8x1 and 4x2 meshes,
    timed beside the unsharded frame; config 3's physical render on 4x1
    and 2x2 meshes (B3); the sharded gradients (B2, B4) and config 4's CLI
    fit on a 2x2 mesh; the two-process render over gloo; the CLI's refusal
    of config 5's 4x2 mesh (its sweep) on one card; the split engine. Returns the
    record and each kernel's launches by path."""
    import torch
    from path_tracer_c_tpu_torch import parallel
    from path_tracer_c_tpu_torch.grad import diff
    from path_tracer_c_tpu_torch.models.split import render_split
    from path_tracer_c_tpu_torch.ops import render_grad as rg
    from path_tracer_c_tpu_torch.ops import render_kernel as rk
    from path_tracer_c_tpu_torch.ops import render_physical as rp
    from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
    from path_tracer_c_tpu_torch.utils.bitmap import bitmap_bytes
    from path_tracer_c_tpu_torch.utils.config import AnimationConfig, FitConfig, RenderConfig, load

    result, launches = {}, {name: {} for name in ("render_fwd", "render_fused", "render_phys",
                                                   "render_phys_fused")}
    row_block_checks(pt, dev, glossy, cam)
    mesh = lambda tile, spp: parallel.make_mesh(tile=tile, spp=spp, devices=[dev] * (tile * spp))

    # Config 5's frame at full width through B1.
    acfg = load(root / SWEEP_CONFIG, AnimationConfig)
    c5 = acfg.render
    demo = pt.demo.demo_scene(dev) if c5.scene == "demo" else None
    frame = (c5.height, c5.width, c5.spp, c5.max_bounces, c5.seed)
    log(f"config 5's frame ({c5.scene} {c5.width}x{c5.height} {c5.spp}spp {c5.max_bounces}b, "
        f"B1) through render_sharded on cuda:0 repeated:")
    whole = rk.render_kernel(demo, cam, *frame)
    sharded = {}
    for tile, spp_ax in ((8, 1), (c5.mesh.tile, c5.mesh.spp)):
        m = mesh(tile, spp_ax)
        since = _Launches()
        img = parallel.render_sharded(demo, cam, *frame, m, engine="cuda")
        torch.cuda.synchronize()
        n = since["render_fwd"]
        launches["render_fwd"][f"render_sharded config 5 {tile}x{spp_ax}"] = n
        if n != tile * spp_ax:
            raise AssertionError(f"{tile}x{spp_ax}: B1 launched {n} times, not {tile * spp_ax}")
        err = float((img - whole).abs().max())
        if spp_ax == 1:
            if not torch.equal(img, whole):
                raise AssertionError(f"config 5 {tile}x1: differs from the unsharded frame ({err})")
            log(f"  {tile}x1: {n} launches of B1, bit for bit")
        else:
            check_spp_split(img, whole, frame, spp_ax,
                            lambda k, off: rk.render_kernel(demo, cam, *frame[:2], k, frame[3],
                                                            frame[4], sample_offset=off),
                            f"config 5 {tile}x{spp_ax}: {n} launches of B1")
        sharded[f"{tile}x{spp_ax}"] = (m, err)
    times = {}
    for label, fn in (("unsharded", lambda seed: rk.render_kernel(demo, cam, *frame[:4], seed)),
                      *((f"mesh {k}", (lambda m: lambda seed: parallel.render_sharded(
                          demo, cam, *frame[:4], seed, m, engine="cuda"))(m))
                        for k, (m, _) in sharded.items()),
                      ("unsharded again", lambda seed: rk.render_kernel(demo, cam, *frame[:4],
                                                                         seed))):
        times[label] = median_ms(fn, warm=(50,), seeds=(1, 2, 3))
        log(f"time config 5 frame, {label}: {times[label]:.3f} ms [{card}]")
    result["config5_frame"] = {"shape": frame[:4], "ms": times,
                               "max_abs_err": {k: e for k, (_, e) in sharded.items()}}

    # Config 3's physical render through B3 (jitter as the config).
    pcfg = load(root / PHYS_CONFIG, RenderConfig)
    pkw = dict(jitter=pcfg.jitter, tri_nee=pcfg.tri_nee)
    pshape = (pcfg.height, pcfg.width, pcfg.spp, pcfg.max_bounces, 1)
    pwhole = rp.render_physical_kernel(glossy, cam, *pshape, **pkw)
    for tile, spp_ax in ((4, 1), (2, 2)):
        since = _Launches()
        img = parallel.render_sharded(glossy, cam, *pshape, mesh(tile, spp_ax),
                                      engine="physical_pallas", **pkw)
        torch.cuda.synchronize()
        launches["render_phys"][f"render_sharded config 3 {tile}x{spp_ax}"] = \
            since["render_phys"]
        what = (f"config 3 through render_sharded(physical_pallas) {tile}x{spp_ax}: "
                f"{since['render_phys']} launches of B3")
        if spp_ax == 1:
            if not torch.equal(img, pwhole):
                raise AssertionError(f"{what}: differs from the unsharded render")
            log(f"{what}, bit for bit")
        else:
            check_spp_split(img, pwhole, pshape, spp_ax,
                            lambda k, off: rp.render_physical_kernel(
                                glossy, cam, *pshape[:2], k, pshape[3], pshape[4],
                                sample_offset=off, **pkw), what)

    # Training on config 4's shape (B2) on a 2x2 mesh.
    fcfg = load(root / FIT_CONFIG, FitConfig)
    cfg = fcfg.render
    spheres = pt.demo.random_spheres_scene(dev)
    fshape = (cfg.height, cfg.width, cfg.spp, cfg.max_bounces)
    target = rk.render_kernel(spheres, cam, *fshape, 12345)
    m22 = mesh(2, 2)
    leaves = [(tb, nm) for tb, nm in rg._GRAD_LEAVES]
    live = [getattr(getattr(spheres, tb) if tb else spheres, nm).detach().clone().requires_grad_()
            for tb, nm in leaves]
    since = _Launches()
    img = parallel.render_sharded(rg.replace_leaves(spheres, [(tb, nm, t) for (tb, nm), t in
                                                               zip(leaves, live)]),
                                  cam, *fshape, 3, m22, engine="cuda")
    g_sharded = torch.autograd.grad(torch.mean((img - target) ** 2), live)
    launches["render_fused"]["render_sharded 2x2 gradient"] = since["render_fused"]
    _, d_scene = diff.loss_and_grad(spheres, target, cam, *fshape, 3, engine="cuda")
    for (tb, nm), g in zip(leaves, g_sharded):
        ref = getattr(getattr(d_scene, tb) if tb else d_scene, nm)
        torch.testing.assert_close(g, ref, rtol=SHARD_GRAD_RTOL, atol=SHARD_GRAD_ATOL,
                                   msg=lambda msg: f"sharded gradient d_{nm}: {msg}")
    log(f"sharded gradient (2x2, B2) = loss_and_grad(engine='cuda') at rtol {SHARD_GRAD_RTOL}: "
        f"{len(leaves)} leaves")
    params = diff.make_material_params(spheres)
    step = parallel.make_train_step(cam, *fshape, m22, diff.apply_material_params, engine="cuda")
    since = _Launches()
    step(params, type("NoStep", (), {"step": staticmethod(lambda: None)})(), spheres, target, 3)
    launches["render_fused"]["make_train_step 2x2"] = since["render_fused"]
    probe = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    ref_loss = diff.render_loss(diff.apply_material_params(spheres, probe), target, cam, *fshape, 3,
                                engine="cuda")
    ref_g = torch.autograd.grad(ref_loss, list(probe.values()), allow_unused=True)
    for (k, v), g in zip(params.items(), ref_g):
        torch.testing.assert_close(v.grad, g if g is not None else torch.zeros_like(v),
                                   rtol=SHARD_GRAD_RTOL, atol=SHARD_GRAD_ATOL,
                                   msg=lambda msg: f"train step d_{k}: {msg}")
    log("make_train_step (2x2, B2): its gradient = the unsharded one at rtol "
        f"{SHARD_GRAD_RTOL}, {launches['render_fused']['make_train_step 2x2']} launches")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        raw = json.loads((root / FIT_CONFIG).read_text())
        raw["render"]["mesh"] = {"tile": 2, "spp": 2, "devices": ["cuda:0"] * 4}
        raw["steps"] = 20
        fit_cfg = tmp / "fit_2x2.json"
        fit_cfg.write_text(json.dumps(raw))
        since = _Launches()
        line = _cli_quiet(cli_main, ["fit", "--config", str(fit_cfg)])
        n = since["render_fused"]
        launches["render_fused"]["CLI fit on a 2x2 mesh"] = n
        got = re.search(r"fit on mesh 2x2: 20 steps in .*loss ([\d.e+-]+) -> ([\d.e+-]+)", line)
        if not got or n != 80 or not float(got.group(2)) < float(got.group(1)):
            raise AssertionError(f"CLI fit on a 2x2 mesh: {line!r}, {n} launches of B2")
        log(f"CLI fit on a 2x2 mesh of cuda:0: {line.strip()}; {n} launches of B2")
        result["fit_2x2"] = line.strip()

        # A physical geometry step on B4 with geom=True.
        lscene = light_fit_scene(pt, dev)
        gshape = (256, 256, 16, 4)
        gtarget = rp.render_physical_kernel(lscene, cam, *gshape, 5, jitter=False)
        li = int(rp.live_emitter_mask(lscene).argmax())
        shift = torch.zeros_like(lscene.spheres.center)
        shift[li] = torch.tensor([0.3, -0.2, 0.25], device=dev)
        moved = dataclasses.replace(lscene, spheres=dataclasses.replace(
            lscene.spheres, center=lscene.spheres.center + shift))
        apply_geo = lambda sc, p: diff.apply_geometry_params(sc, p, (li,))
        gparams = diff.make_geometry_params(moved, (li,))
        gstep = parallel.make_train_step(cam, *gshape, m22, apply_geo, engine="physical_pallas",
                                         geom=True)
        since = _Launches()
        gstep(gparams, type("NoStep", (), {"step": staticmethod(lambda: None)})(), moved,
              gtarget, 9)
        launches["render_phys_fused"]["make_train_step 2x2 geometry"] = \
            since["render_phys_fused"]
        gprobe = {k: v.detach().clone().requires_grad_() for k, v in gparams.items()}
        img = pg.render_physical_kernel_vjp(apply_geo(moved, gprobe), cam, *gshape, 9,
                                            jitter=False, geom=True)
        gref = torch.autograd.grad(torch.mean((img - gtarget) ** 2), list(gprobe.values()))
        for (k, v), g in zip(gparams.items(), gref):
            if not bool(g.abs().max() > 0):
                raise AssertionError(f"geometry step: the unsharded d_{k} is zero")
            torch.testing.assert_close(v.grad, g, rtol=GEOM_GRAD_RTOL,
                                       atol=BWD_ATOL_SCALE * float(g.abs().max()),
                                       msg=lambda msg: f"geometry step d_{k}: {msg}")
        log(f"make_train_step (2x2, B4, geom=True): the light's gradient = the unsharded one "
            f"at rtol {GEOM_GRAD_RTOL}")

        # Two processes on cuda:0 over gloo.
        rec = two_process_render(root, tmp)
        single = rk.render_kernel(glossy, cam, H, W, SPP, BOUNCES, 1)
        if not torch.equal(rec["image"], single.cpu()):
            raise AssertionError("the two-process render differs from the single-process one")
        launches["render_fwd"]["two-process render_sharded 2x1 (rank 0)"] = rec["launches"]
        log(f"two processes on cuda:0 (backend {rec['backend']}): health {rec['status']}; "
            f"glossy {W}x{H} {SPP}spp {BOUNCES}b on a 2x1 mesh equals the single-process "
            f"render bit for bit; render {rec['seconds']:.3f} s on rank 0, wall "
            f"{rec['wall_seconds']:.1f} s from start to both exits [{card}]")
        result["two_process"] = {"backend": rec["backend"], "status": rec["status"],
                                 "render_seconds": rec["seconds"],
                                 "wall_seconds": rec["wall_seconds"]}

        # The CLI refuses config 5's sweep, with its 4x2 mesh, on this
        # machine's cards.
        try:
            _cli_quiet(cli_main, ["animate", "--config", str(root / SWEEP_CONFIG), "--frames",
                                  "1", "--out-dir", str(tmp / "refused")])
        except SystemExit as e:
            msg = str(e)
        else:
            msg = ""
        n_dev = torch.cuda.device_count()
        if f"!= {n_dev} devices" not in msg or (tmp / "refused").exists():
            raise AssertionError(f"config 5's mesh on {n_dev} card(s) was not refused: {msg!r}")
        log(f"CLI animate of config 5 refused: {msg}")
        result["config5_refused"] = msg

        # The split engine on the card against itself on the CPU.
        out = tmp / "split.bmp"
        line = _cli_quiet(cli_main, ["render", "--engine", "split", "--width", "160", "--height",
                                     "100", "--spp", "4", "--max-bounces", "4", "--out", str(out)])
        check_bmp(out.read_bytes(), 160, 100)
        card_img = render_split(pt.demo.demo_scene(dev), cam, 100, 160, 4, 4, 0)
        cpu_img = render_split(pt.demo.demo_scene("cpu"), pt.Camera.reference("cpu"), 100, 160,
                               4, 4, 0)
        torch.testing.assert_close(card_img.cpu(), cpu_img, rtol=SPLIT_RTOL, atol=SPLIT_ATOL)
        if bitmap_bytes(pt.render_image_u8(card_img).cpu().numpy()) != out.read_bytes():
            raise AssertionError("the CLI's split BMP differs from the encoded card image")
        log(f"split engine: {line.strip()}; card = CPU within rtol {SPLIT_RTOL} atol "
            f"{SPLIT_ATOL} (max |delta| {float((card_img.cpu() - cpu_img).abs().max()):.3g})")
    return {"result": result, "launches": launches}


def script_runs(pt, dev, card: str) -> dict:
    """Phase 17: the measurement scripts' modules at the JAX scripts' TPU
    shapes. B1 and B3 against their twins, value for value, on the sweep's
    1024-, 1536- and 2048-sphere and -material scenes (where the placement
    flips) at 64x64, 1 spp, 2 bounces, and on the 2048 scenes (tables above
    the shared budget) at the sweep's shape on a block of rows; B4 against
    its twin on the asymmetry's triangle-lit call (``tri_nee``, geometry
    planes) at 1024x1024, 64 spp, 8 bounces on a block of rows; the eager
    physical gradient twice, bit for bit; then, with their launches
    counted, the capacity
    sweep (``utils/capacity_sweep``, 512x512, 16 spp, 4 bounces, seven
    points a sweep: each kernel's placement as ``tables_in_shared`` says,
    the ``global_tables`` instantiation timed only where the tables fit);
    the geometry-gradient asymmetry (``utils/geom_asym``: 256x256, 16 spp, 4
    bounces on glossy; the triangle-lit scene and the pair at 1024x1024, 64
    spp, 8 bounces, the pair's eager side one call; finite fused gradients);
    the scaling harness
    (``parallel/scaling``, engine pallas, 1024x1024, 64 spp, 8 bounces) on
    the visible cards, then on cuda:0 repeated 2 and 4 times, each mesh's
    image equal to the unsharded B1 image bit for bit. Each line is
    printed as it comes. Returns each kernel's launches by path and its
    largest difference from its twin."""
    import torch
    from path_tracer_c_tpu_torch.ops import render_kernel as rk
    from path_tracer_c_tpu_torch.ops import render_physical as rp
    from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
    from path_tracer_c_tpu_torch.parallel import scaling as sc
    from path_tracer_c_tpu_torch.utils import capacity_sweep as cs
    from path_tracer_c_tpu_torch.utils import geom_asym as ga
    from path_tracer_c_tpu_torch.utils.metrics import shape_name

    launches = {name: {} for name in ("render_fwd", "render_phys", "render_phys_fused")}
    cam = pt.Camera.reference(dev)
    small = (64, 64, 1, 2)
    max_err = {"render_fwd": 0.0, "render_phys": 0.0, "render_phys_fused": 0.0}
    kernels = (("render_fwd", rk.render_kernel, rk.render_kernel_reference, False),
               ("render_phys", rp.render_physical_kernel, rp.render_physical_kernel_reference,
                True))

    def held(name, out, twin, what):
        max_err[name] = max(max_err[name], compare_exact(out, twin, what))

    # Both placements at the points where they flip, at a small shape.
    for sweep_name in cs.SWEEPS:
        for n in (1024, 1536, 2048):
            scene = cs.sweep_scene(sweep_name, n, dev)
            for name, kernel, twin, physical in kernels:
                where = "shared" if rk.tables_in_shared(scene, physical) else "global"
                held(name, kernel(scene, cam, *small, 5), twin(scene, cam, *small, 5),
                     f"{name} on the {sweep_name} sweep's {n} scene "
                     f"({rk.table_bytes(scene, physical)} bytes of tables, {where}), "
                     f"{shape_name(small)}")
    # The sweep's own shape, tables above the budget: the kernel's whole image
    # against the twin's block of its rows 240-271.
    h, w, spp, bounces = cs.SHAPE
    for sweep_name, n in (("spheres", 2048), ("materials", 2048)):
        scene = cs.sweep_scene(sweep_name, n, dev)
        for name, kernel, twin, physical in kernels:
            if rk.tables_in_shared(scene, physical):
                raise AssertionError(f"{sweep_name} {n}: {name}'s tables fit the budget")
            whole = kernel(scene, cam, *cs.SHAPE, 6)
            held(name, whole[240:272],
                 twin(scene, cam, *cs.SHAPE, 6, row_start=240, rows=32),
                 f"{name} on the {sweep_name} sweep's {n} scene, {shape_name(cs.SHAPE)}, "
                 "rows 240-271 of the whole image")
    # One fused call of the asymmetry's triangle-lit side at its shape: B4's
    # image and planes against the twin's block of rows 448-575.
    tri = ga.tri_lit_scene(dev)
    tri_kw = dict(n_em_cap=rp.live_emitter_count(tri), tri_nee=True,
                  tri_em_cap=rp.live_tri_emitter_count(tri))
    whole = pg.render_physical_fused(tri, cam, *ga.HEADLINE, 31, **tri_kw)
    block = pg.render_physical_fused_reference(tri, cam, *ga.HEADLINE, 31, row_start=448,
                                               rows=128, **tri_kw)
    for i, (a, b) in enumerate(zip(whole, block)):
        a = a[448:576] if a.shape[-1] == 3 else a[:, 448:576]
        held("render_phys_fused", a, b,
             f"render_phys_fused triangle-lit {shape_name(ga.HEADLINE)} {tri_kw}, output {i} "
             f"{tuple(b.shape)}, rows 448-575")
    del whole, block

    # The eager physical gradient (geom_asym's eager side) twice: the same bits.
    glossy = pt.demo.glossy_scene(dev)
    shape = (256, 256, 4, 4)
    fn = ga.eager_grad(glossy, cam, shape,
                       rp.render_physical_kernel(glossy, cam, *shape, 99))
    first, second = fn(1), fn(1)
    if not all((a is None) == (b is None) and (a is None or torch.equal(a, b))
               for a, b in zip(first, second)):
        raise AssertionError(f"eager physical gradient {shape_name(shape)}: two runs differ")
    log(f"  eager physical gradient {shape_name(shape)}: two runs equal bit for bit [{card}]")
    del first, second

    # The capacity sweep.
    since = _Launches()
    for line in cs.sweep(dev, cs.SHAPE):
        log(json.dumps(line))
        for key, physical in (("fwd", False), ("physical", True)):
            scene = cs.sweep_scene(line["sweep"], line["n"], dev)
            shared = rk.tables_in_shared(scene, physical)
            if ((line[f"{key}_tables"] == "shared") != shared
                    or (line[f"{key}_global_tables_seconds"] is None) == shared
                    or line[f"{key}_alone_seconds"] is None):
                raise AssertionError(f"capacity sweep {line['sweep']} {line['n']}: {key} "
                                     "placement or instantiation time wrong")
    torch.cuda.synchronize()
    n_calls = len(cs.SWEEPS) * len(cs.POINTS) * 4  # a warm-up call and three timed
    for name, n in (("render_fwd", since["render_fwd"]),
                    ("render_phys", since["render_phys"])):
        if n != n_calls:
            raise AssertionError(f"capacity sweep: {name} launched {n} times, not {n_calls}")
        launches[name]["capacity sweep"] = n

    # The geometry gradient, fused against eager.
    since = _Launches()
    asym = ga.geom_asym(dev, pair_eager_reps=1,
                        log=lambda msg: log(f"  geom_asym: {msg} [{card}]"))
    torch.cuda.synchronize()
    log(json.dumps(asym))
    if not asym["fused_grads_finite"]:
        raise AssertionError("geom_asym: a fused gradient leaf is not finite")
    if not all(v > 0 for k, v in asym.items() if k.endswith("_seconds") and v is not None):
        raise AssertionError("geom_asym: a time is not positive")
    launches["render_phys"]["geom_asym targets"] = since["render_phys"]
    launches["render_phys_fused"]["geom_asym fused sides"] = since["render_phys_fused"]
    if since["render_phys_fused"] != 3 * 5:  # warm-up, three timed, one checked
        raise AssertionError(f"geom_asym: B4 launched {since['render_phys_fused']} "
                             "times, not 15")

    # The scaling harness on B1.
    whole = rk.render_kernel(pt.demo.glossy_scene(dev), cam, *sc.SHAPE, sc.WARM_SEED)
    visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    for label, devices in (("visible", visible), ("cuda:0 x2", [dev] * 2),
                           ("cuda:0 x4", [dev] * 4)):
        since = _Launches()
        for line, image in sc.scaling(devices, sc.SHAPE, "pallas"):
            log(json.dumps(line))
            if not torch.equal(image, whole):
                raise AssertionError(f"scaling {label} {line['mesh']}: differs from the "
                                     "unsharded B1 image")
        torch.cuda.synchronize()
        launches["render_fwd"][f"scaling {label}"] = since["render_fwd"]
    log(f"scaling: every mesh's image equals the unsharded B1 image bit for bit [{card}]")
    return {"launches": launches, "max_abs_err": max_err}


def tile_runs(dev, card: str) -> dict:
    """Phase 18: the sweep library built, every point checked against the
    default point and the twins (``utils/tile_sweep.check_tiles``), then
    the sweep at the headline. Returns the build, check and sweep times, the
    checks' summary and each kernel's times by point."""
    from path_tracer_c_tpu_torch.ops import build
    from path_tracer_c_tpu_torch.ops import render_kernel as rk
    from path_tracer_c_tpu_torch.utils import tile_sweep as ts

    t0 = time.perf_counter()
    build.load_sweep_library(rk._sweep_units())
    build_s = time.perf_counter() - t0
    log(f"tiles: sweep library of {len(rk._sweep_units())} units built in {build_s:.1f} s "
        f"({build.sweep_library_path(rk._sweep_units()).name})")
    t0 = time.perf_counter()
    summary = ts.check_tiles(dev, log=log)
    check_s = time.perf_counter() - t0
    log(f"tiles: checks took {check_s:.1f} s; B5's largest |delta| / leaf scale against the "
        f"twin {summary['bwd_worst']:.3g}")
    t0 = time.perf_counter()
    records = ts.sweep(tuple(ts.KIND_NAMES), dev, log=lambda line: log(f"tile sweep: {line} "
                                                                         f"[{card}]"))
    sweep_s = time.perf_counter() - t0
    by_kernel = {}
    for r in records:
        by_kernel.setdefault(r["kind"], {})[r["point"]] = {
            k: r[k] for k in ("ms", "alone_ms", "grays_per_s", "registers", "spill_stores",
                              "spill_loads")}
    return {"build_seconds": build_s, "check_seconds": check_s, "sweep_seconds": sweep_s,
            "checks": summary, "sweep": by_kernel}


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
    from path_tracer_c_tpu_torch.utils import flops
    from path_tracer_c_tpu_torch.utils.metrics import rays_per_render
    from path_tracer_c_tpu_torch.utils.profiling import card_line

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    # -- 1. device --
    dev = torch.device("cuda", 0)
    card = card_line(dev)
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
    log("forward kernel and its measurement instantiations vs plain twin (on the card, value "
        "for value, unless named):")
    cam = pt.Camera.reference(dev)
    since = _Launches()
    max_err = 0.0
    demo_names = ("demo_scene", "glossy_scene", "cornell_spheres_scene")
    small_cases = ((False, 0, 4), (True, 3, 8))  # jitter, sample offset, bounces
    glossy = pt.demo.glossy_scene(dev)
    big = big_table_scene(pt, dev)
    fwd_cases = [(name, getattr(pt.demo, name)(dev), (100, 160, 4, bounces),
                  dict(sample_offset=offset, jitter=jitter))
                 for name in demo_names for jitter, offset, bounces in small_cases]
    fwd_cases += [("glossy_scene", glossy, (19, 45, 4, 8), {}),  # ragged: a partial warp a row
                  ("glossy_scene", glossy, (H, W, SPP, BOUNCES), {}),
                  ("big_table_scene", big, (100, 160, 4, 8), dict(jitter=True))]
    log(f"  instantiations: timed kernel {rk.KERNEL_POLICY}, measurement {list(rk.VARIANTS)}; "
        f"tables {rk.table_bytes(glossy)} bytes (glossy), {rk.table_bytes(big)} (big_table_scene), "
        f"shared budget {rk.SHARED_TABLE_BUDGET}")
    for name, scene, shape, kw in fwd_cases:
        args = (scene, cam, *shape, 7 if shape[0] < H else 1)
        what = "{} {}x{} {}spp {}b {}".format(name, *shape, kw)
        k = rk.render_kernel(*args, **kw)
        r = rk.render_kernel_reference(*args, **kw)
        max_err = max(max_err, compare_exact(k, r, what))
        check_instantiations("B1", rk.render_kernel_variant, args, kw, r, what)
        del k, r
    cpu_scene = pt.demo.demo_scene("cpu")
    k = rk.render_kernel(pt.demo.demo_scene(dev), cam, 24, 40, 2, 4, 5, sample_offset=2, jitter=True)
    r = rk.render_kernel_reference(cpu_scene, pt.Camera.reference("cpu"), 24, 40, 2, 4, 5,
                                   sample_offset=2, jitter=True)
    s = compare(k.cpu(), r, "demo_scene 24x40 2spp 4b jitter, twin on the CPU")
    max_err = max(max_err, s["max"])
    if since["render_fwd"] < 1:
        raise AssertionError("render_kernel did not launch its kernel")

    # -- 4. the forward main path, through the CLI --
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "glossy.bmp"
        since = _Launches()
        cli_main(["render", "--scene", "glossy", "--width", str(W), "--height", str(H),
                  "--spp", str(SPP), "--max-bounces", str(BOUNCES), "--out", str(out)])
        fwd_launches = since["render_fwd"]
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
    cases.append(("glossy_scene 19x45 4spp 0b (ragged, no bounce)",
                  (scenes["glossy_scene"], cam, 19, 45, 4, 0, 7), {}))
    cases.append((f"mixed_scene 37x45 2spp {rg.MAX_BOUNCES}b jitter (ragged, the bounce cap)",
                  (scenes["mixed_scene"], cam, 37, 45, 2, rg.MAX_BOUNCES, 7), dict(jitter=True)))
    main_args = (glossy, cam, H, W, SPP, BOUNCES, 1)
    cases.append((f"glossy_scene {H}x{W} {SPP}spp {BOUNCES}b (main shape)", main_args, {}))
    jac_err = 0.0
    for what, args, kw in cases:
        img, jac = rg.render_fused(*args, **kw)
        if not torch.equal(img, rk.render_kernel(*args, **kw)):
            raise AssertionError(f"{what}: fused image differs from render_kernel's")
        pixel_rounds = []
        r_img, r_jac = rg.render_fused_reference(*args, on_sample=pixel_rounds.append, **kw)
        torch.cuda.synchronize()
        compare_exact(img, r_img, what + " image")
        jac_err = max(jac_err, compare_exact(jac, r_jac, what + " Jacobian"))
        del img, jac, r_img, r_jac
        twin = rk.round_groupings(torch.stack(pixel_rounds))
        del pixel_rounds
        got = rg.render_fused_round_counts(*args, **kw)
        log(f"    rounds {got}, equal to the twin's; path regeneration would run "
            f"{twin['warp_lane_rounds_regen']} warp lane-rounds")
        if any(got[k] != twin[k] for k in got):
            raise AssertionError(f"{what}: rounds {got}, twin {twin}")
        if args is main_args:
            fused_twin_rounds = twin
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
    since = _Launches()
    torch.cuda.reset_peak_memory_stats()
    loss, d_scene = diff.loss_and_grad(glossy, target, cam, H, W, SPP, BOUNCES, 1, engine="cuda")
    torch.cuda.synchronize()
    lg_launches = since["render_fused"]
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
    since = _Launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_main(["fit", "--config", str(root / FIT_CONFIG)])
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - t0
    fit_launches = since["render_fused"]
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
    since = _Launches()
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
    phys_scenes["big_table_scene"] = big
    phys_cases.append(("big_table_scene", dict(tri_nee=True)))
    for name, kw in phys_cases:
        args = (phys_scenes[name], cam, 100, 160, 4, 8, 7)
        what = f"{name} 100x160 4spp 8b {kw}"
        groups = rp.WarpGroupings(100, 160, 4, 8, dev)
        k, ev = rp.render_physical_kernel(*args, count_events=True, **kw)
        r, ev_twin = rp.render_physical_kernel_reference(*args, count_events=True,
                                                         on_round=groups.add_round, **kw)
        phys_err = max(phys_err, compare_exact(k, r, what))
        if not torch.equal(k, rp.render_physical_kernel(*args, **kw)):
            raise AssertionError(f"{name}: the counting instantiation's image differs")
        if ev != ev_twin or ev["rounds"] != rp.render_physical_kernel(
                *args, count_rounds=True, **kw)[1]:
            raise AssertionError(f"{name}: events {ev}, twin {ev_twin}")
        check_instantiations("B3", rp.render_physical_kernel_variant, args, kw, r, what)
        rounds = check_physical_rounds(args, kw, groups.counts(), what)
        log(f"    events {ev} of nominal {100 * 160 * 4 * 9} rounds, equal to the twin's; "
            f"warp lane-rounds {rounds}, equal to the twin's")
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
    main_what = f"glossy_scene {H}x{W} {SPP}spp {BOUNCES}b {phys_kw} (main shape)"
    phys_err = max(phys_err, compare_exact(k_main, r_main, main_what))
    if phys_events != ev_twin:
        raise AssertionError(f"main shape: events {phys_events}, twin {ev_twin}")
    check_instantiations("B3", rp.render_physical_kernel_variant,
                         (glossy, cam, H, W, SPP, BOUNCES, 1), phys_kw, r_main, main_what)
    del r_main
    groups = rp.WarpGroupings(H, W, SPP, BOUNCES, dev)
    rp.render_physical_kernel_reference(glossy, cam, H, W, SPP, BOUNCES, 1,
                                        on_round=groups.add_round, **phys_kw)
    phys_twin_rounds = groups.counts()
    del groups
    main_rounds = check_physical_rounds((glossy, cam, H, W, SPP, BOUNCES, 1), phys_kw,
                                        phys_twin_rounds, main_what)
    log(f"    events {phys_events} of nominal {rays_per_render(H, W, SPP, BOUNCES)} rounds, "
        f"equal to the twin's; warp lane-rounds {main_rounds}, equal to the twin's "
        f"{phys_twin_rounds}")
    del k_main
    tri_cpu = tri_light_scene(pt, "cpu")
    k = rp.render_physical_kernel(phys_scenes["tri_light_scene"], cam, 24, 40, 2, 4, 5,
                                  sample_offset=2, tri_nee=True)
    r = rp.render_physical_kernel_reference(tri_cpu, pt.Camera.reference("cpu"), 24, 40, 2, 4, 5,
                                            sample_offset=2, tri_nee=True)
    s = compare_physical(k.cpu(), r, "tri_light_scene 24x40 2spp 4b tri_nee, twin on the CPU")
    phys_err = max(phys_err, s["max"])
    if since["render_phys"] < 1:
        raise AssertionError("render_physical_kernel did not launch its kernel")

    # -- 9. the physical main path, through the CLI --
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "config3.bmp"
        since = _Launches()
        t0 = time.perf_counter()
        cli_main(["render", "--config", str(root / PHYS_CONFIG), "--out", str(out)])
        phys_cli_seconds = time.perf_counter() - t0
        phys_launches = since["render_phys"]
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
        ("glossy_scene", dict(n_em_cap=1), (19, 45, 4, 0)),  # ragged, no bounce
        ("tri_light_scene", dict(tri_nee=True, n_em_cap=1, tri_em_cap=2),
         (37, 45, 2, pg.MAX_BOUNCES)),  # ragged, the bounce cap
        # Caps and emitter counts that straddle the budget of B4's slot
        # instantiations (chip_plane_split: two sphere ordinals, or one
        # triangle ordinal, then emitter materials): spheres32 has four
        # sphere emitters of four materials.
        ("spheres32", dict(n_em_cap=1)), ("spheres32", dict(n_em_cap=2)),
        ("spheres32", dict(n_em_cap=4, rough_grad=True)),
        ("tri_light_scene", dict(tri_nee=True, tri_em_cap=1)),
        ("tri_light_scene", dict(tri_nee=True, tri_em_cap=2, jitter=False)),
    ]
    phys_scenes["spheres32"] = spheres
    pf_err = 0.0
    for name, kw, *shape in pf_cases:
        h, w, spp, bounces = shape[0] if shape else (100, 160, 4, 8)
        args = (phys_scenes[name], cam, h, w, spp, bounces, 7)
        what = f"{name} {h}x{w} {spp}spp {bounces}b {kw}"
        out = pg.render_physical_fused(*args, count_events=True, **kw)
        pixel_rounds = []
        ref = pg.render_physical_fused_reference(*args, count_events=True,
                                                 on_sample=pixel_rounds.append, **kw)
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
        twin = rk.round_groupings(torch.stack(pixel_rounds))
        got = pg.render_physical_fused_round_counts(*args, **fwd_kw)
        if any(got[k] != twin[k] for k in got):
            raise AssertionError(f"{what}: rounds {got}, twin {twin}")
        log(f"    events {out[-1]} (forward kernel: {n_fwd} rounds), rounds {got}, equal to the "
            f"twin's; path regeneration would run {twin['warp_lane_rounds_regen']} warp "
            f"lane-rounds")

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
    # Every addition of B5 is in a fixed order: two launches equal bit for
    # bit; its counting instantiation gives the same cotangents and the twin's
    # counts, whose rounds are B4's. At 100x160 and at config 4's shape.
    log("two-pass kernel: two launches and the counting instantiation equal bit for bit, the "
        "counts equal to the twin's, the rounds to B4's:")
    g_fit = torch.randn((cfg.height, cfg.width, 3),
                        generator=torch.Generator().manual_seed(4)).to(dev)
    n_live_s = rp.live_emitter_count(spheres)
    fit_shape = (cfg.height, cfg.width, cfg.spp, cfg.max_bounces)
    for scene, g_, shape, kw, what in (
            (phys_scenes["glossy_scene"], g_small, (100, 160, 4, 8),
             dict(n_em_cap=1, sample_offset=3), "glossy_scene 100x160 4spp 8b"),
            (phys_scenes["glossy_scene"], g_small, (100, 160, 4, 8), dict(n_em_cap=0),
             "glossy_scene 100x160 4spp 8b"),
            (phys_scenes["tri_light_scene"], g_small, (100, 160, 4, 8),
             dict(tri_nee=True, n_em_cap=2, jitter=False), "tri_light_scene 100x160 4spp 8b"),
            (spheres, g_fit, fit_shape, dict(n_em_cap=n_live_s),
             "spheres32 {1}x{0} {2}spp {3}b (config 4's shape)".format(*fit_shape)),
            (spheres, g_fit, fit_shape, dict(n_em_cap=0),
             "spheres32 {1}x{0} {2}spp {3}b (config 4's shape)".format(*fit_shape))):
        args = (scene, cam, g_, *shape, 7)
        d5, counts = pg.render_physical_bwd(*args, count_sites=True, **kw)
        again = pg.render_physical_bwd(*args, **kw)
        r5, twin_counts = pg.render_physical_bwd_reference(*args, count_sites=True, **kw)
        what = f"{what} {kw}"
        if not all(torch.equal(a, b) for a, b in zip(pg._grad_leaves(d5)[:8],
                                                     pg._grad_leaves(again)[:8])):
            raise AssertionError(f"{what}: two launches of the two-pass kernel differ")
        pb_err = max(pb_err, compare_cotangents(again, r5, pb_leaves, what + " vs twin"))
        b4 = pg.render_physical_fused_round_counts(
            scene, cam, *shape, 7, **{k: v for k, v in kw.items() if k != "n_em_cap"})
        if counts != twin_counts or (counts["fwd_thread_rounds"], counts["fwd_warp_lane_rounds"]) != (
                b4["thread_rounds"], b4["warp_lane_rounds"]):
            raise AssertionError(f"{what}: counts {counts}, twin {twin_counts}, B4 {b4}")
        log(f"    counts {counts}")
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
    since = _Launches()
    torch.cuda.reset_peak_memory_stats()
    loss, d_scene = diff.loss_and_grad(glossy, phys_target, cam, H, W, SPP, BOUNCES, 1,
                                       engine="physical_pallas")
    torch.cuda.synchronize()
    plg_launches = since["render_phys_fused"]
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
    pvjp_launches = since["render_phys_fused"] - plg_launches
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
    pbwd_launches = since["render_phys_bwd"]
    if pbwd_launches != 1:
        raise AssertionError("render_physical_bwd did not launch its kernel once")
    log(f"physical gradient main path: render_physical_bwd launched its kernel {pbwd_launches} time(s)")
    compare_cotangents(d5, d_vjp, pb_leaves, f"glossy_scene {H}x{W} {SPP}spp {BOUNCES}b two-pass vs fused path")

    # Both kernels against their twins at the main shape; the twins' one run timed.
    geo_kw = dict(n_em_cap=n_live)
    pf_main = pg.render_physical_fused(glossy, cam, H, W, SPP, BOUNCES, 1, count_events=True, **geo_kw)
    pf_events = pf_main[-1]
    pixel_rounds = []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    pf_twin = pg.render_physical_fused_reference(glossy, cam, H, W, SPP, BOUNCES, 1,
                                                 count_events=True, on_sample=pixel_rounds.append,
                                                 **geo_kw)
    end.record()
    torch.cuda.synchronize()
    pf_twin_ms = start.elapsed_time(end)
    phys_fused_twin_rounds = rk.round_groupings(torch.stack(pixel_rounds))
    del pixel_rounds
    got = pg.render_physical_fused_round_counts(glossy, cam, H, W, SPP, BOUNCES, 1)
    if any(got[k] != phys_fused_twin_rounds[k] for k in got):
        raise AssertionError(f"main shape: rounds {got}, twin {phys_fused_twin_rounds}")
    log(f"    rounds {got}, equal to the twin's; path regeneration would run "
        f"{phys_fused_twin_rounds['warp_lane_rounds_regen']} warp lane-rounds")
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
    d5c, pb_counts = pg.render_physical_bwd(glossy, cam, g_main, H, W, SPP, BOUNCES, 1,
                                            count_sites=True, **geo_kw)
    _, pb_twin_counts = pg.render_physical_bwd_reference(glossy, cam, g_main, H, W, SPP, BOUNCES,
                                                         1, count_sites=True, **geo_kw)
    if pb_counts != pb_twin_counts or pb_counts["fwd_thread_rounds"] != pf_events["rounds"] or (
            pb_counts["fwd_warp_lane_rounds"] != phys_fused_twin_rounds["warp_lane_rounds"]):
        raise AssertionError(f"main shape: two-pass counts {pb_counts}, twin {pb_twin_counts}")
    log(f"    two-pass counts {pb_counts}, equal to the twin's; the rounds B4's")
    log(f"    two-pass adds by site (every lane's atomics, as the parent design; the warp "
        f"groups', as the kernel): {json.dumps(pg.bwd_atomics(pb_counts))}")
    del d5c

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
            since = _Launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli_main(["fit", "--config", str(cfg_path), "--mode", mode])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            line = buf.getvalue().strip().splitlines()[-1]
            launches = since["render_phys_fused"]
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

    # Each kernel's operations and bytes at the main shape, from this run's
    # executed rounds and events (utils/flops.py), and the data-sheet bound.
    # kernel -> (flops kind, events, keywords, milliseconds)
    specs = {
        "render_fwd": ("forward", {"rounds": fwd_rounds}, {}, fwd_ms),
        "render_fused": ("fused", {"rounds": fus_rounds}, {}, fus_ms),
        "render_phys": ("physical", phys_events, {}, phy_ms),
        "render_phys_fused": ("physical_fused_geom", pf_events,
                              dict(fwd_events=phys_events, n_em_cap=n_live), pf_geo_ms),
        "render_phys_bwd": ("physical_bwd", pf_events,
                            dict(fwd_events=phys_events, n_em_cap=n_live), pb_ms),
    }
    (fwd_bound, fwd_by), (fus_bound, fus_by), (phy_bound, phy_by), (pf_bound, pf_by), (
        pb_bound, pb_by) = (
        flops.bound_ms(flops.kernel_op_counts(kind, glossy, H, W, SPP, BOUNCES, events, **kw))
        for kind, events, kw, _ in specs.values())
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

    # -- 14. speed of light --
    sol = speed_of_light(dev, card, glossy, cam, specs,
                         {"fused": fused_twin_rounds, "physical_fused": phys_fused_twin_rounds,
                          "physical_bwd": pb_twin_counts})

    # -- 15. the long runs --
    t0 = time.perf_counter()
    longr = long_runs(pt, root, dev, card, cli_main)
    log(f"long runs: phase 15 took {time.perf_counter() - t0:.1f} s")

    # -- 16. row blocks and the parallel layer --
    t0 = time.perf_counter()
    shard = sharded_runs(pt, root, dev, card, cli_main, glossy, cam)
    log(f"sharded runs: phase 16 took {time.perf_counter() - t0:.1f} s")

    # -- 17. the measurement scripts' modules --
    t0 = time.perf_counter()
    scripts = script_runs(pt, dev, card)
    log(f"script runs: phase 17 took {time.perf_counter() - t0:.1f} s")

    # -- 18. the launch shapes --
    t0 = time.perf_counter()
    tiles = tile_runs(dev, card)
    log(f"tile runs: phase 18 took {time.perf_counter() - t0:.1f} s (build "
        f"{tiles['build_seconds']:.1f} s, checks {tiles['check_seconds']:.1f} s, sweep "
        f"{tiles['sweep_seconds']:.1f} s)")

    # launches: the main paths' runs; every time, bound and round count: the
    # glossy shape named in "timed_at".
    common = {"route": "cuda", "library_ms": None, "timed_at": where}
    kernels = [
        {"name": "render_fwd", "source": rk.SOURCE, "replaces": rk.REPLACES,
         "launches": fwd_launches + sol["fwd_launches"],
         "launches_by_path": {"render": fwd_launches, "sol_decompose": sol["fwd_launches"]},
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
    ]
    for entry in kernels:
        entry.update(sol["measured"][entry["name"]])
        entry.update(sol["fused"].get(entry["name"], {}))
        entry.update(sol["forward"].get(entry["name"], {}))
    kernels[2].update({k: phys_twin_rounds[k] for k in phys_twin_rounds
                       if "warp_lane_rounds" in k})
    for entry in kernels:
        if entry["name"] in longr["max_abs_err"]:
            entry["max_abs_err"] = max(entry["max_abs_err"], longr["max_abs_err"][entry["name"]])
        extra = longr["launches"].get(entry["name"], {})
        entry["launches_by_path"].update(extra)
        entry["launches"] += sum(extra.values())
    for entry in kernels:
        for extra in (shard["launches"].get(entry["name"], {}),
                      scripts["launches"].get(entry["name"], {})):
            entry["launches_by_path"].update(extra)
            entry["launches"] += sum(extra.values())
        if entry["name"] in scripts["max_abs_err"]:
            entry["max_abs_err"] = max(entry["max_abs_err"], scripts["max_abs_err"][entry["name"]])
    # Each render kernel's launch shape, and its times at every point.
    for entry, tile_kind in zip(kernels, ("fwd", "fused", "phys", "phys_fused", "phys_bwd")):
        entry["tile"] = rk.tile_point(None, tile_kind).name
        entry["tile_sweep_ms"] = {p: v["ms"] for p, v in tiles["sweep"][tile_kind].items()}
        entry["tile_sweep_alone_ms"] = {p: v["alone_ms"]
                                        for p, v in tiles["sweep"][tile_kind].items()}
    log(json.dumps({"tile_runs": {k: tiles[k] for k in ("build_seconds", "check_seconds",
                                                        "sweep_seconds", "checks")}}))
    log(json.dumps({"sharded_runs": shard["result"]}))
    log(json.dumps({"long_runs": longr["result"]}))
    log(json.dumps({"kernels": kernels + sol["entries"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(sys.argv[2:]))
    sys.exit(main())
