"""The ``render`` loop: a closed loop of whole frames.

A unit is one frame: one call of the traffic mix's ``entry`` at the run's
seed plus the frame's index, its image brought to the host as the command
line takes it (``.cpu().numpy()``). Frames stay in host memory; a sample
of ``check_units`` of them, drawn from the seed, is kept for the check.

``numbers``: ``mismatch_share``, the largest share, over the frames kept,
of image values that differ from the image of the mix's ``reference``
(``module:function`` under ``reference/``) at the frame's seed. The
kernels are specified operation for operation (built without contraction
into fused multiply-adds), so a sound frame equals the reference value
for value.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import window as _w
from reference import scenes, tracer


def count_at(cell, seed: int) -> dict:
    """The inputs at which the kernel's events are counted: the window's
    first frame."""
    cfg = cell.config
    return {"tables": scenes.scene(cfg["scene"]), "camera": scenes.camera(cfg["fov_deg"]),
            "seed": seed & _w.MASK, "jitter": bool(cfg["jitter"])}


def run(run: _w.Run) -> _w.Window:
    tr = run.cell.traffic
    H, W, spp, B = run.shape
    at = count_at(run.cell, run.seed)
    jitter = at["jitter"]
    entry = _w.resolve(tr["entry"])
    scene, camera = _w.port_inputs(run, at["tables"], at["camera"])
    run.mark("inputs")

    def frame(seed):
        return entry(scene, camera, H, W, spp, B, seed, jitter=jitter)

    for i in range(int(tr["warmup"])):
        frame((run.seed - 1 - i) & _w.MASK).cpu()
    _w.sync(run.device)
    out = _w.Window(setup_s=time.perf_counter() - run.t0,
                    tables={"scene": at["tables"], "camera": at["camera"]})
    lat, calls = [], []
    keep = _w.Reservoir(int(tr["check_units"]), run.seed)

    def unit(i):
        seed = (run.seed + i) & _w.MASK
        t0 = time.perf_counter()
        img = frame(seed)
        t1 = time.perf_counter()
        host = img.cpu().numpy()
        lat.append(time.perf_counter() - t0)
        calls.append(t1 - t0)
        keep.offer(i, (seed, host))

    out.units, out.window_s, out.prof, out.traced_units = _w.drive(run, unit, tr["trace_seconds"])
    out.attempted = out.units
    out.e2e = {"rays_per_s": out.units * H * W * spp * (B + 1) / out.window_s,
               "frame_p95_ms": float(np.percentile(lat, 95)) * 1e3}
    out.spans = {"render_call_s": calls, "frame_s": lat}
    out.kept = {"frames": keep.items}
    return out


@torch.no_grad()
def numbers(run: _w.Run, window: _w.Window) -> dict:
    H, W, spp, B = run.shape
    render = _w.reference(run.cell.traffic["reference"])
    scene = tracer.tensors(window.tables["scene"], run.device)
    cam = tracer.camera_tensors(window.tables["camera"], run.device)
    worst = 0.0
    for seed, host in window.kept["frames"].values():
        ref = render(scene, cam, H, W, spp, B, seed, jitter=bool(run.cell.config["jitter"]))
        worst = max(worst, float(np.mean(host != ref.cpu().numpy())))
    return {"mismatch_share": worst}


def controls(cell, seed: int, device, what: set) -> list:
    """The control: the reference computed in bfloat16 (the nearest
    precision below the configuration's float32) in the program's place,
    judged against the float32 reference at the window's first frame."""
    if "control" not in what:
        return []
    H, W, spp, B = (cell.config[k] for k in ("height", "width", "spp", "max_bounces"))
    at = count_at(cell, seed)
    render = _w.reference(cell.traffic["reference"])
    with torch.no_grad():
        imgs = [render(tracer.tensors(at["tables"], device, dt),
                       tracer.camera_tensors(at["camera"], device, dt),
                       H, W, spp, B, at["seed"], jitter=at["jitter"]).float().cpu().numpy()
                for dt in (torch.float32, torch.bfloat16)]
    return [{"reading": "control", "mismatch_share": float((imgs[0] != imgs[1]).mean()),
             "limit": cell.traffic["limits"]["mismatch_share"]}]
