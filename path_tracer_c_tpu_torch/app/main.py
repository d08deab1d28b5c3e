"""Command-line interface: offline render to BMP, and the material fit.

The ``render`` and ``fit`` subcommands of the JAX package's ``app/main.py``
on PyTorch. ``render``: a built-in scene or scene JSON, written as a
24-bit BMP, rendered by one of four engines. Reference tier: the hand CUDA
kernel (``--engine cuda``, the default) or the eager integrator
(``--engine core``). Physical tier (importance-sampled BRDF, next-event
estimation): its hand CUDA kernel (``--engine physical``) or its eager
integrator (``--engine physical_core``); ``--tri-nee`` adds emissive
triangles to the physical tier's light sampling. ``fit``: render a target
with the true scene, corrupt albedo and emission strength, and recover
them with Adam on the gradient of the fused CUDA kernel (``--engine
cuda``) or of the eager integrator (``--engine core``).

``--device cuda`` (the default) needs a CUDA device and raises without
one; it never carries on on the CPU. ``--device cpu`` runs the same
engines on the CPU, where a kernel engine takes the kernel's plain twin.
The kernels have no tile-divisibility rule, so the kernel engines render
every image size through the kernel.

Usage:
    python -m path_tracer_c_tpu_torch.app.main render --scene glossy \
        --width 1024 --height 1024 --spp 64 --max-bounces 8 --out out.bmp
    python -m path_tracer_c_tpu_torch.app.main fit \
        --config configs/config4_inverse_spheres32.json
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch


def _scenes():
    from ..scene import demo

    return {
        "demo": demo.demo_scene,
        "diffuse": demo.diffuse_sphere_scene,
        "cornell": demo.cornell_spheres_scene,
        "glossy": demo.glossy_scene,
        "spheres32": demo.random_spheres_scene,
    }


def get_scene(name: str, device):
    """Resolve a scene by built-in name or JSON file path."""
    scenes = _scenes()
    if name in scenes:
        return scenes[name](device)
    if name.endswith(".json") and Path(name).exists():
        from ..scene.io import load_scene

        return load_scene(name, device)
    raise SystemExit(
        f"unknown scene '{name}'; available: {', '.join(sorted(scenes))} "
        "or a scene .json path"
    )


# Engines and settings of the JAX CLI that this package has not ported
# yet, with the ROADMAP.md item that ports them.
_NOT_PORTED_ENGINES = {"split": "A10 (split tier)"}
_PHYSICAL_GRADIENT = "A9, second half (B4, B5)"
# The JAX package's names for its kernel engines, and this package's.
_ENGINE_ALIASES = {"pallas": "cuda", "physical_pallas": "physical"}
_PHYSICAL_ENGINES = ("physical", "physical_core")
_ENGINES = ("cuda", "core") + _PHYSICAL_ENGINES


def _check_ported(cfg, fit=False):
    if cfg.engine in _NOT_PORTED_ENGINES:
        raise SystemExit(
            f"engine '{cfg.engine}' is not ported to PyTorch yet: see "
            f"ROADMAP.md {_NOT_PORTED_ENGINES[cfg.engine]}"
        )
    if cfg.engine not in _ENGINES:
        raise SystemExit(f"unknown engine '{cfg.engine}'; available: {', '.join(_ENGINES)}")
    if fit and (cfg.engine in _PHYSICAL_ENGINES or cfg.tri_nee):
        what = "tri_nee" if cfg.tri_nee else f"engine '{cfg.engine}'"
        raise SystemExit(
            f"fit: {what} needs the physical tier's gradient, which is not ported "
            f"to PyTorch yet: see ROADMAP.md {_PHYSICAL_GRADIENT}"
        )
    if cfg.mesh.tile * cfg.mesh.spp > 1:
        raise SystemExit(
            "a multi-device mesh is not ported yet: see ROADMAP.md A11 "
            "(parallel layer)"
        )
    _refuse_if_set(cfg, ("checkpoint_every", "checkpoint_path", "progressive", "debug_nans"))


def _refuse_if_set(cfg, names):
    """Settings of ROADMAP.md A12 (checkpoints and the rest of the CLI)."""
    for name in names:
        if getattr(cfg, name):
            raise SystemExit(
                f"{name} is not ported yet: see ROADMAP.md A12 "
                "(checkpoint and the rest of the CLI)"
            )


def _device(name: str) -> torch.device:
    if name == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _renderer(cfg):
    """The configured engine as ``render(scene, camera, H, W, spp, bounces,
    seed, jitter=...)``. ``tri_nee`` reaches the physical engines only; the
    reference tier has no light sampling and ignores it, as the JAX CLI
    does."""
    import functools

    from ..models.integrator import render_radiance
    from ..models.physical import render_physical
    from ..ops import render_kernel as rk
    from ..ops import render_physical as rp

    if cfg.engine in _PHYSICAL_ENGINES:
        render = rp.render_physical_kernel if cfg.engine == "physical" else render_physical
        return functools.partial(render, tri_nee=cfg.tri_nee)
    return rk.render_kernel if cfg.engine == "cuda" else render_radiance


def cmd_render(args):
    from ..models.integrator import render_image_u8
    from ..ops.camera import Camera
    from ..utils import bitmap
    from ..utils.config import RenderConfig, load
    from ..utils.metrics import MetricsLogger, Timer, throughput

    cfg = load(args.config) if args.config else RenderConfig()
    for name in ("width", "height", "spp", "max_bounces", "seed", "scene", "engine"):
        v = getattr(args, name)
        if v is not None:
            setattr(cfg, name, v)
    cfg.engine = _ENGINE_ALIASES.get(cfg.engine, cfg.engine)
    if args.tri_nee:
        cfg.tri_nee = True
    if args.out:
        cfg.output = args.out
    _check_ported(cfg)
    device = _device(args.device)

    scene = get_scene(cfg.scene, device)
    camera = Camera.reference(device, cfg.fov_deg)
    metrics = MetricsLogger(args.metrics)
    render = _renderer(cfg)
    with Timer() as t:
        rad = render(
            scene, camera, cfg.height, cfg.width, cfg.spp, cfg.max_bounces,
            cfg.seed, jitter=cfg.jitter,
        )
        u8 = render_image_u8(rad).cpu().numpy()  # waits for the device
    rps = throughput(cfg.height, cfg.width, cfg.spp, cfg.max_bounces, t.seconds)
    metrics.log("render", engine=cfg.engine, device=str(device),
                seconds=t.seconds, rays_per_sec=rps)
    print(f"spp {cfg.spp}  {t.seconds:.2f}s  {rps:.3e} rays/s  "
          f"({cfg.engine} on {device})")
    bitmap.write_bitmap(cfg.output, u8, y_inverted=True)
    print(f"wrote {cfg.output} ({cfg.width}x{cfg.height}, {cfg.spp} spp)")


def cmd_fit(args):
    """Inverse rendering: recover albedo and emission strength."""
    import numpy as np

    from ..grad import diff
    from ..ops.camera import Camera
    from ..utils.config import FitConfig, load
    from ..utils.metrics import MetricsLogger

    fcfg = load(args.config, FitConfig) if args.config else FitConfig()
    cfg = fcfg.render
    for name in ("width", "height", "spp", "max_bounces", "scene", "engine"):
        v = getattr(args, name)
        if v is not None:
            setattr(cfg, name, v)
    if args.steps:
        fcfg.steps = args.steps
    mode = args.mode or fcfg.mode or "materials"
    if mode in ("geometry", "roughness"):
        raise SystemExit(
            f"fit --mode {mode} is not ported to PyTorch yet: see ROADMAP.md "
            f"{_PHYSICAL_GRADIENT}")
    if mode != "materials":
        raise SystemExit(f"fit: unknown mode {mode!r}; expected materials")
    # An explicit engine is honoured; "pallas" (the JAX package's kernel
    # engine) and "auto" are this package's "cuda".
    cfg.engine = "cuda" if cfg.engine == "auto" else _ENGINE_ALIASES.get(cfg.engine, cfg.engine)
    _check_ported(cfg, fit=True)
    _refuse_if_set(fcfg, ("checkpoint_every", "checkpoint_path"))
    device = _device(args.device)

    true_scene = get_scene(cfg.scene, device)
    camera = Camera.reference(device, cfg.fov_deg)
    metrics = MetricsLogger(args.metrics)
    if fcfg.target:
        target = torch.from_numpy(np.load(fcfg.target)).to(device, torch.float32)
    else:
        # The target comes from the engine's own forward renderer: on a
        # card the eager integrator would take far longer than the fit.
        target = _renderer(cfg)(true_scene, camera, cfg.height, cfg.width, cfg.spp,
                        cfg.max_bounces, (cfg.seed + 12345) & 0xFFFFFFFF)

    t0 = time.time()
    # Corrupt the materials, then recover them.
    mats = true_scene.materials
    init = dataclasses.replace(true_scene, materials=dataclasses.replace(
        mats, albedo=torch.full_like(mats.albedo, 0.5),
        emission_strength=torch.full_like(mats.emission_strength, 0.1)))
    callback = None
    if args.metrics:
        callback = lambda i, l: metrics.log("fit_step", step=i, loss=l, engine=cfg.engine)
    fitted, losses = diff.fit_materials(
        init, target, camera, cfg.height, cfg.width, cfg.spp, cfg.max_bounces,
        steps=fcfg.steps, lr=fcfg.lr, seed0=cfg.seed, callback=callback,
        engine=cfg.engine)
    err = float((fitted.materials.albedo - mats.albedo).abs().max())
    print(f"fit: {fcfg.steps} steps in {time.time() - t0:.1f}s, "
          f"loss {losses[0]:.3e} -> {losses[-1]:.3e}, max albedo err {err:.4f}")


def build_parser():
    p = argparse.ArgumentParser(
        prog="path_tracer_c_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="offline render to BMP")
    r.add_argument("--config", help="JSON config file")
    r.add_argument("--scene")
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--spp", type=int)
    r.add_argument("--max-bounces", type=int, dest="max_bounces")
    r.add_argument("--seed", type=int)
    r.add_argument("--out", help="output BMP path")
    r.add_argument("--metrics", help="metrics JSONL output path")
    r.add_argument(
        "--engine", choices=list(_ENGINES) + list(_ENGINE_ALIASES),
        help="cuda: the reference tier's hand kernel; core: its eager "
             "integrator; physical: the physical tier's hand kernel; "
             "physical_core: its eager integrator. A kernel engine takes "
             "its plain twin on --device cpu. pallas and physical_pallas, "
             "the JAX package's names, mean cuda and physical (default: "
             "the config's, else cuda)",
    )
    r.add_argument("--tri-nee", action="store_true", dest="tri_nee",
                   help="physical engines: light-sample emissive triangles "
                        "too (default: the config's)")
    r.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    r.set_defaults(fn=cmd_render)

    f = sub.add_parser("fit", help="inverse rendering: recover materials")
    f.add_argument("--config", help="JSON fit config file")
    f.add_argument("--scene")
    f.add_argument("--width", type=int)
    f.add_argument("--height", type=int)
    f.add_argument("--spp", type=int)
    f.add_argument("--max-bounces", type=int, dest="max_bounces")
    f.add_argument("--steps", type=int)
    f.add_argument("--mode", choices=["materials", "geometry", "roughness"],
                   help="materials (default: the config's); the other two "
                        "need the physical tier's gradient, which is not "
                        "ported yet")
    f.add_argument("--metrics", help="metrics JSONL output path")
    f.add_argument(
        "--engine",
        help="cuda: the fused kernel and its contraction (their plain twin "
             "on --device cpu); core: autograd through the eager integrator "
             "(default: the config's, else cuda)",
    )
    f.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    f.set_defaults(fn=cmd_fit)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
