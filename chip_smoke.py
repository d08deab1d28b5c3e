#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), and PyTorch's name
   for it. No CUDA device is a failure.
2. build: compile the CUDA sources of ``path_tracer_c_tpu_torch/csrc`` with
   nvcc (``ops/build.py``) and print the build time.
3. kernel against its plain twin: ``render_kernel`` on the card against
   ``render_kernel_reference`` on the card, for three scenes at a size with
   a ragged edge, with jitter off and on and a nonzero sample offset, at the
   main path's shape, and once against the twin on the CPU.
4. main path: the CLI ``render`` at 1024x1024, 64 spp, 8 bounces on the
   glossy scene. The kernel's launch count must grow; the BMP is decoded
   and checked.
5. times: the kernel and the plain twin at that shape, with CUDA events.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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
# The main path's shape: the glossy scene at 1024^2, 64 spp, 8 bounces.
H = W = 1024
SPP, BOUNCES = 64, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def compare(a, b, what: str) -> dict:
    """|a - b| statistics; raises unless within the stated tolerance."""
    import torch

    err = (a.detach().double().cpu() - b.detach().double().cpu()).abs().flatten()
    if a.shape != b.shape or not torch.isfinite(err).all():
        raise AssertionError(f"{what}: shapes {a.shape}/{b.shape} or non-finite values")
    stats = {
        "q999": float(torch.quantile(err, 0.999)),
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
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("non-finite radiance in a timed run")
        times.append(start.elapsed_time(end))
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import path_tracer_c_tpu_torch as pt
    from path_tracer_c_tpu_torch.app.main import main as cli_main
    from path_tracer_c_tpu_torch.ops import build
    from path_tracer_c_tpu_torch.ops import render_kernel as rk
    from path_tracer_c_tpu_torch.utils.bitmap import bitmap_bytes
    from path_tracer_c_tpu_torch.utils.metrics import rays_per_render

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    # -- 1. device --
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card (nvidia-smi name, power limit): {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")

    # -- 2. build --
    t0 = time.perf_counter()
    build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({build.build_dir()})")

    # -- 3. kernel against its plain twin --
    log("kernel vs plain twin (both on the card unless named):")
    cam = pt.Camera.reference(dev)
    launches0 = rk.render_kernel.launches
    max_err = 0.0
    for name in ("demo_scene", "glossy_scene", "cornell_spheres_scene"):
        scene = getattr(pt.demo, name)(dev)
        for jitter, offset, bounces in ((False, 0, 4), (True, 3, 8)):
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

    # -- 4. the main path, through the CLI --
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "glossy.bmp"
        rk.render_kernel.launches = 0
        cli_main(["render", "--scene", "glossy", "--width", str(W), "--height", str(H),
                  "--spp", str(SPP), "--max-bounces", str(BOUNCES), "--out", str(out)])
        launches = rk.render_kernel.launches
        log(f"main path: render_kernel launched {launches} time(s)")
        if launches < 1:
            raise AssertionError("the CLI render did not go through the kernel")
        data = out.read_bytes()
    if data[:2] != b"BM" or len(data) != 54 + 3 * W * H:
        raise AssertionError(f"BMP: bad magic or size {len(data)}")
    size, _, offset = struct.unpack("<III", data[2:14])
    bw, bh, _, bpp = struct.unpack("<iiHH", data[18:30])
    if (size, offset, bw, bh, bpp) != (len(data), 54, W, H, 24):
        raise AssertionError(f"BMP header {(size, offset, bw, bh, bpp)}")
    pixels = data[54:]
    if len(set(pixels)) < 2 or not any(pixels):
        raise AssertionError("BMP pixels are all equal or all zero")
    # The CLI's image is the kernel's (seed 0), encoded.
    rad = rk.render_kernel(glossy, cam, H, W, SPP, BOUNCES, 0)
    if bitmap_bytes(pt.render_image_u8(rad).cpu().numpy()) != data:
        raise AssertionError("CLI BMP differs from the encoded kernel image")
    log(f"main path: BMP {len(data)} bytes, {W}x{H}, decoded and checked")

    # -- 5. times --
    rays = rays_per_render(H, W, SPP, BOUNCES)
    kern = lambda seed: rk.render_kernel(glossy, cam, H, W, SPP, BOUNCES, seed)
    plain = lambda seed: rk.render_kernel_reference(glossy, cam, H, W, SPP, BOUNCES, seed)
    time_cuda(kern, [100])  # warm-up
    k_ms = statistics.median(time_cuda(kern, [1, 2, 3]))
    time_cuda(plain, [100])
    p_ms = statistics.median(time_cuda(plain, [1, 2, 3]))
    for what, ms in (("kernel", k_ms), ("plain twin", p_ms)):
        log(f"time {what}: glossy {H}x{W} {SPP}spp {BOUNCES}b: {ms / 1e3:.4f} s, "
            f"{rays / (ms / 1e3):.4e} nominal rays/s [{card}]")

    log(json.dumps({"kernels": [{
        "name": "render_fwd", "route": "cuda", "source": rk.SOURCE,
        "replaces": rk.REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
