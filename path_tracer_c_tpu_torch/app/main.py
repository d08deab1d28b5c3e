"""Command-line interface: offline render to BMP, and the fits.

The ``render`` and ``fit`` subcommands of the JAX package's ``app/main.py``
on PyTorch. ``render``: a built-in scene or scene JSON, written as a
24-bit BMP, rendered by one of four engines. Reference tier: the hand CUDA
kernel (``--engine cuda``, the default) or the eager integrator
(``--engine core``). Physical tier (importance-sampled BRDF, next-event
estimation): its hand CUDA kernel (``--engine physical``) or its eager
integrator (``--engine physical_core``); ``--tri-nee`` adds emissive
triangles to the physical tier's light sampling. ``fit``: render a target
with the true scene, corrupt it, and recover it with Adam. ``--mode
materials`` (the default) corrupts albedo and emission strength and fits on
the gradient of the fused CUDA kernel (``--engine cuda``), of the eager
integrator (``--engine core``), or of the physical tier: ``--engine
physical_pallas`` is the fused physical kernel, ``--engine physical``
autograd through the eager physical tier (the JAX package's names at this
entry point; in a render ``physical`` is the forward kernel, which has no
gradient to choose). ``--mode geometry`` moves the first emissive sphere
and recovers its centre, ``--mode roughness`` sets every roughness to 0.5
and recovers it by the score-function gradient; both need a physical
engine and take ``physical`` where none is named.

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
# The JAX package's names for its kernel engines, and this package's, in a
# render.
_ENGINE_ALIASES = {"pallas": "cuda", "physical_pallas": "physical"}
_PHYSICAL_ENGINES = ("physical", "physical_core")
_ENGINES = ("cuda", "core") + _PHYSICAL_ENGINES
# In a fit the physical engines carry the JAX package's names (grad/diff.py).
_FIT_ALIASES = {"auto": "cuda", "pallas": "cuda", "physical_core": "physical"}
_FIT_PHYSICAL_ENGINES = ("physical", "physical_pallas")
_FIT_ENGINES = ("cuda", "core") + _FIT_PHYSICAL_ENGINES


def _check_ported(cfg, engines=_ENGINES):
    if cfg.engine in _NOT_PORTED_ENGINES:
        raise SystemExit(
            f"engine '{cfg.engine}' is not ported to PyTorch yet: see "
            f"ROADMAP.md {_NOT_PORTED_ENGINES[cfg.engine]}"
        )
    if cfg.engine not in engines:
        raise SystemExit(f"unknown engine '{cfg.engine}'; available: {', '.join(engines)}")
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


def _named_engine(args):
    """The engine the user named, on the command line or in the config
    file's render block; None where neither names one."""
    import json

    if args.engine is not None:
        return args.engine
    if args.config:
        return json.loads(Path(args.config).read_text()).get("render", {}).get("engine")
    return None


def cmd_fit(args):
    """Inverse rendering: recover materials, or with ``--mode`` the light's
    position or the roughness (physical tier)."""
    import numpy as np

    from ..grad import diff
    from ..ops import render_physical as rp
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
    if args.tri_nee:
        cfg.tri_nee = True
    mode = args.mode or fcfg.mode or "materials"
    if mode not in ("materials", "geometry", "roughness"):
        raise SystemExit(f"fit: unknown mode {mode!r} (config file?): expected "
                         "materials | geometry | roughness")
    # An explicit engine is honoured; "pallas" (the JAX package's kernel
    # engine) and "auto" are this package's "cuda".
    cfg.engine = _FIT_ALIASES.get(cfg.engine, cfg.engine)
    if mode != "materials":
        # These modes exist in the physical tier only. Where no engine is
        # named they take its eager one; a reference-tier engine that was
        # named is refused, not replaced.
        named = _named_engine(args)
        if named is None:
            cfg.engine = "physical"
        elif cfg.engine in _FIT_ENGINES and cfg.engine not in _FIT_PHYSICAL_ENGINES:
            raise SystemExit(
                f"fit --mode {mode} needs a physical engine ({', '.join(_FIT_PHYSICAL_ENGINES)}); "
                f"engine '{named}' belongs to the reference tier, which keeps "
                f"{'geometry' if mode == 'geometry' else 'roughness'} detached by contract")
    _check_ported(cfg, _FIT_ENGINES)
    _refuse_if_set(fcfg, ("checkpoint_every", "checkpoint_path"))
    device = _device(args.device)
    physical = cfg.engine in _FIT_PHYSICAL_ENGINES

    true_scene = get_scene(cfg.scene, device)
    camera = Camera.reference(device, cfg.fov_deg)
    metrics = MetricsLogger(args.metrics)
    target_seed = (cfg.seed + 12345) & 0xFFFFFFFF
    if fcfg.target:
        target = torch.from_numpy(np.load(fcfg.target)).to(device, torch.float32)
    elif physical:
        # The target comes from the tier's forward kernel: on a card the
        # eager tier would take far longer than the fit.
        target = rp.render_physical_kernel(
            true_scene, camera, cfg.height, cfg.width, cfg.spp, cfg.max_bounces,
            target_seed, jitter=False, tri_nee=cfg.tri_nee)
    else:
        target = _renderer(cfg)(true_scene, camera, cfg.height, cfg.width, cfg.spp,
                                cfg.max_bounces, target_seed)

    t0 = time.time()
    callback = None
    if args.metrics:
        callback = lambda i, l: metrics.log("fit_step", step=i, loss=l, engine=cfg.engine)
    common = dict(steps=fcfg.steps, lr=fcfg.lr, seed0=cfg.seed, callback=callback,
                  engine=cfg.engine)
    shape = (cfg.height, cfg.width, cfg.spp, cfg.max_bounces)
    mats = true_scene.materials

    if mode == "geometry":
        # Move the first emissive sphere, then recover its centre through the
        # light samples' geometry gradient.
        em = rp.live_emitter_mask(true_scene)
        if not em.any():
            raise SystemExit("fit --mode geometry needs a scene with an emissive sphere")
        li = int(np.argmax(em))
        sph = true_scene.spheres
        shift = torch.zeros_like(sph.center)
        shift[li] = torch.tensor([0.3, -0.2, 0.25], dtype=sph.center.dtype, device=device)
        init = dataclasses.replace(true_scene, spheres=dataclasses.replace(
            sph, center=sph.center + shift))
        fitted, losses = diff.fit_geometry(
            init, target, camera, *shape, sphere_indices=(li,),
            tri_nee=True if cfg.tri_nee else None, **common)
        err = float((fitted.spheres.center[li] - sph.center[li]).abs().max())
        print(f"geometry fit ({cfg.engine}): {fcfg.steps} steps in {time.time() - t0:.1f}s, "
              f"loss {losses[0]:.3e} -> {losses[-1]:.3e}, max light-center err {err:.4f}")
        return

    if mode == "roughness":
        # Corrupt every roughness, then recover it by the score-function
        # estimator (rough_grad).
        init = dataclasses.replace(true_scene, materials=dataclasses.replace(
            mats, roughness=torch.full_like(mats.roughness, 0.5)))
        fitted, losses = diff.fit_materials(init, target, camera, *shape, rough_grad=True,
                                            **common)
        err = float((fitted.materials.roughness - mats.roughness).abs().max())
        print(f"roughness fit ({cfg.engine}, score-function): {fcfg.steps} steps in "
              f"{time.time() - t0:.1f}s, loss {losses[0]:.3e} -> {losses[-1]:.3e}, "
              f"max roughness err {err:.4f}")
        return

    # Corrupt the materials, then recover them.
    init = dataclasses.replace(true_scene, materials=dataclasses.replace(
        mats, albedo=torch.full_like(mats.albedo, 0.5),
        emission_strength=torch.full_like(mats.emission_strength, 0.1)))
    fitted, losses = diff.fit_materials(init, target, camera, *shape, **common)
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

    f = sub.add_parser("fit", help="inverse rendering: recover materials, a "
                                   "light's position or roughness")
    f.add_argument("--config", help="JSON fit config file")
    f.add_argument("--scene")
    f.add_argument("--width", type=int)
    f.add_argument("--height", type=int)
    f.add_argument("--spp", type=int)
    f.add_argument("--max-bounces", type=int, dest="max_bounces")
    f.add_argument("--steps", type=int)
    f.add_argument("--mode", choices=["materials", "geometry", "roughness"],
                   help="materials: albedo and emission (default: the "
                        "config's); geometry: the first emissive sphere's "
                        "centre; roughness: every roughness, by the "
                        "score-function gradient. The last two run on a "
                        "physical engine")
    f.add_argument("--metrics", help="metrics JSONL output path")
    f.add_argument(
        "--engine",
        help="cuda: the fused kernel and its contraction (their plain twin "
             "on --device cpu); core: autograd through the eager integrator; "
             "physical_pallas: the fused physical kernel and its contraction; "
             "physical: autograd through the eager physical tier (default: "
             "the config's, else cuda; with --mode geometry or roughness, "
             "physical)",
    )
    f.add_argument("--tri-nee", action="store_true", dest="tri_nee",
                   help="physical engines: light-sample emissive triangles "
                        "too, in the target and in a geometry fit (default: "
                        "the config's)")
    f.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    f.set_defaults(fn=cmd_fit)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
