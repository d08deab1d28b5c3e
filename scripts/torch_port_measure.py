#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's main paths goes, on one GPU:
measurements chip_smoke.py does not take.

    python3 scripts/torch_port_measure.py

Runs ``torch.profiler`` over (1) ``loss_and_grad`` at the main shape
(glossy, 1024x1024, 64 spp, 8 bounces), (2) steps of ``fit_materials`` at
the shape of ``configs/config4_inverse_spheres32.json`` and (3) the CLI
``render --config configs/config3_glossy_1024.json`` (the physical tier),
(4) the physical tier's fwd+bwd at the main shape, without geometry planes
(``loss_and_grad(engine="physical_pallas")``) and with them
(``render_physical_kernel_vjp`` with jitter on and the cap at the live
emitter count, plus ``backward``), and (5) steps of ``fit_geometry`` on the
fused physical kernel (cornell, 256x256, 8 spp, 3 bounces: config 4's size),
and prints for each the device time by kernel, the wall time per step and
the share of it the device is busy; for (3) also the render's stages on
the host's clock (set-up, kernel, u8 and copy to the host, BMP encode and
write). Every line of results carries the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
H = W = 1024
SPP, BOUNCES = 64, 8

# Operators whose device time (inclusive of what they call) is reported:
# the autograd.Function's forward (zero-fill of the planes and the fused
# kernel) and backward (the contraction), and the optimizer.
OPS_OF_INTEREST = ("_RenderFused", "_RenderFusedBackward", "_RenderPhysicalFused",
                   "_RenderPhysicalFusedBackward", "Optimizer.step#Adam.step")


def profile(fn, steps: int) -> dict:
    """Wall time per step, device time by kernel, and the device's busy
    share, over ``steps`` calls of ``fn(i)`` after 3 warm-up calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for i in range(3):
        fn(1000 + i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        fn(2000 + i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            fn(3000 + i)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    kernels, ops = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.key.startswith("Optimizer."):
            continue  # the optimizer's range on the device: its kernels are counted below
        if e.device_type == DeviceType.CUDA:  # a kernel or a copy on the device
            kernels[e.key] = e.self_device_time_total / 1e3 / steps
        elif e.key in OPS_OF_INTEREST:  # an operator: its own and its children's kernels
            ops[e.key] = e.device_time_total / 1e3 / steps
    device_ms = sum(kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms, "steps": steps,
            "device_ms_by_op": ops, "device_ms_by_kernel": top,
            "kernels_seen": len(kernels)}


def render_stages(cfg, reps: int = 5) -> dict:
    """Median milliseconds of the stages of one CLI render of ``cfg``, each
    closed by a device synchronise, on the host's clock."""
    import torch
    from path_tracer_c_tpu_torch.app.main import _renderer, get_scene
    from path_tracer_c_tpu_torch.models.integrator import render_image_u8
    from path_tracer_c_tpu_torch.ops.camera import Camera
    from path_tracer_c_tpu_torch.utils import bitmap

    dev = torch.device("cuda", 0)
    stages = {"setup": [], "kernel": [], "u8_and_copy": [], "bmp_encode_write": []}
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(reps + 1):
            t = [time.perf_counter()]
            scene, cam = get_scene(cfg.scene, dev), Camera.reference(dev, cfg.fov_deg)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            rad = _renderer(cfg)(scene, cam, cfg.height, cfg.width, cfg.spp, cfg.max_bounces,
                                 cfg.seed + rep, jitter=cfg.jitter)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            u8 = render_image_u8(rad).cpu().numpy()
            t.append(time.perf_counter())
            bitmap.write_bitmap(str(Path(tmp) / "o.bmp"), u8, y_inverted=True)
            t.append(time.perf_counter())
            if rep:  # the first is the warm-up
                for name, a, b in zip(stages, t, t[1:]):
                    stages[name].append((b - a) * 1e3)
    return {name: statistics.median(v) for name, v in stages.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_measure: no CUDA device")
    sys.path.insert(0, str(REPO))
    import path_tracer_c_tpu_torch as pt
    from path_tracer_c_tpu_torch.grad import diff
    from path_tracer_c_tpu_torch.ops import render_kernel as rk
    from path_tracer_c_tpu_torch.utils.config import FitConfig, load
    from path_tracer_c_tpu_torch.utils.profiling import card_line

    card = card_line("cuda")
    dev = torch.device("cuda", 0)
    cam = pt.Camera.reference(dev)
    glossy = pt.demo.glossy_scene(dev)
    target = rk.render_kernel(glossy, cam, H, W, SPP, BOUNCES, 12345)
    result = {"card": card}
    result["loss_and_grad"] = profile(
        lambda i: diff.loss_and_grad(glossy, target, cam, H, W, SPP, BOUNCES, i, engine="cuda"),
        steps=5)
    del target

    fcfg = load(REPO / "configs" / "config4_inverse_spheres32.json", FitConfig)
    cfg = fcfg.render
    spheres = pt.demo.random_spheres_scene(dev)
    fit_target = rk.render_kernel(spheres, cam, cfg.height, cfg.width, cfg.spp,
                                  cfg.max_bounces, 12345)
    # One call of fit_materials with 20 steps: the loop a user runs.
    result["fit_20_steps"] = profile(
        lambda i: diff.fit_materials(spheres, fit_target, cam, cfg.height, cfg.width, cfg.spp,
                                     cfg.max_bounces, steps=20, lr=fcfg.lr, seed0=i),
        steps=3)
    fit = result["fit_20_steps"]
    for key in ("wall_ms_per_step", "device_ms_per_step"):
        fit[key.replace("per_step", "per_fit_step")] = fit.pop(key) / 20
    for key in ("device_ms_by_op", "device_ms_by_kernel"):
        fit[key] = {k: v / 20 for k, v in fit[key].items()}
    from path_tracer_c_tpu_torch.app.main import main as cli_main
    from path_tracer_c_tpu_torch.utils.config import RenderConfig

    config3 = REPO / "configs" / "config3_glossy_1024.json"
    with tempfile.TemporaryDirectory() as tmp:
        def cli(i):
            with contextlib.redirect_stdout(io.StringIO()):
                cli_main(["render", "--config", str(config3), "--seed", str(i),
                          "--out", str(Path(tmp) / "c3.bmp")])
        result["cli_render_config3"] = profile(cli, steps=5)
    result["cli_render_config3"]["stage_ms"] = render_stages(load(config3, RenderConfig))

    # The physical tier's gradient at the main shape: a material objective
    # (no geometry planes, jitter off), then the call with geometry planes.
    from path_tracer_c_tpu_torch.ops import render_physical as rp
    from path_tracer_c_tpu_torch.ops import render_physical_grad as pg

    target = rp.render_physical_kernel(glossy, cam, H, W, SPP, BOUNCES, 12345, jitter=False)
    result["physical_loss_and_grad"] = profile(
        lambda i: diff.loss_and_grad(glossy, target, cam, H, W, SPP, BOUNCES, i,
                                     engine="physical_pallas"), steps=5)
    n_live = rp.live_emitter_count(glossy)

    def fwd_bwd_geom(i):
        leaves = [x.clone().requires_grad_() for x in pg._grad_leaves(glossy)]
        img = pg.render_physical_kernel_vjp(pg._with_leaves(glossy, leaves), cam, H, W, SPP,
                                            BOUNCES, i, n_em_cap=n_live)
        return torch.autograd.grad(diff.mse_loss(img, target), leaves, allow_unused=True)

    result["physical_fwd_bwd_geom"] = profile(fwd_bwd_geom, steps=5)
    result["physical_fwd_bwd_geom"]["n_em_cap"] = n_live
    del target

    # Steps of the geometry fit on the fused physical kernel, at config 4's
    # size: the loop `fit --mode geometry --engine physical_pallas` runs.
    cornell = pt.demo.cornell_spheres_scene(dev)
    li = int(rp.live_emitter_mask(cornell).argmax())
    geo_target = rp.render_physical_kernel(cornell, cam, cfg.height, cfg.width, cfg.spp,
                                           cfg.max_bounces, 12345, jitter=False)
    result["fit_geometry_20_steps"] = profile(
        lambda i: diff.fit_geometry(cornell, geo_target, cam, cfg.height, cfg.width, cfg.spp,
                                    cfg.max_bounces, sphere_indices=(li,), steps=20, lr=0.02,
                                    seed0=i, engine="physical_pallas"),
        steps=3)
    geo = result["fit_geometry_20_steps"]
    for key in ("wall_ms_per_step", "device_ms_per_step"):
        geo[key.replace("per_step", "per_fit_step")] = geo.pop(key) / 20
    for key in ("device_ms_by_op", "device_ms_by_kernel"):
        geo[key] = {k: v / 20 for k, v in geo[key].items()}

    for name, r in result.items():
        if name != "card":
            print(f"{name} [{card}]: {json.dumps(r)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
