"""Profiling: ``torch.profiler`` traces, timing, and a hand roofline estimate.

The counterpart of ``path_tracer_c_tpu/utils/profiling.py``. ``trace()``
records host and device activity around a block and writes a Chrome trace;
``time_fn`` is a median wall time that waits for the device; ``roofline()``
is the JAX package's back-of-envelope operation table for one render, with
the H100's published float32 rate as its default peak. The measured model
(operation counts from the kernels' sources against rates measured on the
card by kernel B6) is ``utils/flops.sol_report``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "time_fn", "roofline", "H100_PEAK_FP32"]

# The float32 rate of one H100 SXM outside the tensor cores (NVIDIA's data
# sheet, at the 700 W power limit), counting a fused multiply-add as two.
H100_PEAK_FP32 = 67e12


@contextlib.contextmanager
def trace(logdir: str):
    """Record the body with ``torch.profiler`` (the CPU, and CUDA where a
    device is present) and write ``trace.json`` (Chrome trace format) into
    ``logdir``. Yields the profiler, for ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _wait(out):
    """Wait for the device of every tensor in ``out`` (a tensor or a
    tuple, list or dict of them)."""
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else (out,))
    for t in items:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)


def time_fn(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall time in seconds of ``fn(*args)`` after ``warmup`` calls;
    each call waits for the device its result lies on."""
    for _ in range(warmup):
        _wait(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _wait(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


# The JAX package's rough per-ray-bounce operation counts of its megakernel:
# a sphere test, a triangle test, a material select, the shading.
_FLOPS_SPHERE = 22
_FLOPS_TRI = 50
_FLOPS_MAT = 10
_FLOPS_SHADE = 190


def roofline(
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    n_spheres: int,
    n_triangles: int,
    n_materials: int,
    peak_flops: float = H100_PEAK_FP32,
):
    """Estimated FLOPs, bytes and speed-of-light seconds of one render.

    Hand-estimated only (a fixed per-op table and one blended rate), with
    the JAX package's formula: every pixel-sample runs ``max_bounces + 1``
    rounds, and the kernel writes 12 bytes of radiance per pixel. The
    default peak is the H100 data sheet's float32 rate; the kernels, built
    without FMA contraction, can reach at most half of it.
    """
    rays = height * width * spp * (max_bounces + 1)
    flops_per = (
        _FLOPS_SPHERE * n_spheres
        + _FLOPS_TRI * n_triangles
        + _FLOPS_MAT * n_materials
        + _FLOPS_SHADE
    )
    flops = rays * flops_per
    return {
        "rays": rays,
        "flops": flops,
        "flops_per_ray": flops_per,
        "hbm_bytes": 12 * height * width,
        "sol_seconds": flops / peak_flops,
    }
