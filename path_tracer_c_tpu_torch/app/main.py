"""Command-line interface: offline render to BMP, camera sweep, and the fits.

The ``render``, ``animate`` and ``fit`` subcommands of the JAX package's
``app/main.py`` on PyTorch. ``render``: a built-in scene or scene JSON, written as a
24-bit BMP, rendered by one of four engines. Reference tier: the hand CUDA
kernel (``--engine cuda``, the default) or the eager integrator
(``--engine core``). Physical tier (importance-sampled BRDF, next-event
estimation): its hand CUDA kernel (``--engine physical``) or its eager
integrator (``--engine physical_core``); ``--tri-nee`` adds emissive
triangles to the physical tier's light sampling; ``--bounce-stats`` logs
and prints the per-bounce event histogram of a separate render of at most 4
spp (the physical tier's, with its light-sample counts, for the physical
engines). A render runs in chunks of ``checkpoint_every`` spp where that is
set, each at the sample offset of the spp before it, folded into an
accumulator (``utils/checkpoint.py``) from which the image is written by
numpy's encoder, as the JAX package writes it (the printed line and the
metrics name the writer). With ``checkpoint_path`` the accumulator is
saved after every chunk and a render resumes from it; ``--progressive``
rewrites the output after every chunk, ``--live`` draws it in the terminal,
``--debug-nans`` raises on non-finite radiance in a chunk. ``animate``:
``frames`` renders on a circle around a target, written by the native
asynchronous frame writer (``utils/native.py``) where it builds, else by
numpy, while the device renders the next frame. ``fit``: render a target
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
engine and take ``physical`` where none is named. ``--checkpoint-path`` saves
the fit's state every ``--checkpoint-every`` steps, and a fit resumes from
it.

``--engine split`` renders the reference shader's two-branch estimator
(``models/split.py``), an eager parity tier on one device.

A config's ``mesh`` of more than one slot renders ``render``, its chunks
and ``animate`` through ``parallel.render_sharded``, and fits materials
through ``parallel.make_train_step`` (``_fit_sharded_materials``). Its
slots lie on every visible CUDA device, on the CPU under ``--device cpu``,
or on the mesh's own ``devices`` (a device may repeat, and each must be of
``--device``'s type); a mesh that is not exactly those devices is refused
with their count.

``--device cuda`` (the default) needs a CUDA device and raises without
one; it never carries on on the CPU. ``--device cpu`` runs the same
engines on the CPU, where a kernel engine takes the kernel's plain twin.
The kernels have no tile-divisibility rule, so the kernel engines render
every image size through the kernel.

Usage:
    python -m path_tracer_c_tpu_torch.app.main render --scene glossy \
        --width 1024 --height 1024 --spp 64 --max-bounces 8 --out out.bmp
    python -m path_tracer_c_tpu_torch.app.main render --config \
        configs/config3_glossy_1024.json --checkpoint-every 16 \
        --checkpoint-path render.ckpt.npz
    python -m path_tracer_c_tpu_torch.app.main animate --frames 24 --out-dir frames/
    python -m path_tracer_c_tpu_torch.app.main fit \
        --config configs/config4_inverse_spheres32.json --checkpoint-path fit.ckpt.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
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


# The JAX package's names for its kernel engines, and this package's, in a
# render.
_ENGINE_ALIASES = {"pallas": "cuda", "physical_pallas": "physical"}
_PHYSICAL_ENGINES = ("physical", "physical_core")
_ENGINES = ("cuda", "core") + _PHYSICAL_ENGINES + ("split",)
# A render engine's name in parallel.render_sharded, which takes the JAX
# package's (the physical kernel is "physical_pallas" there).
_SHARDED_ENGINES = {"cuda": "cuda", "core": "core", "physical": "physical_pallas",
                    "physical_core": "physical"}
# In a fit the physical engines carry the JAX package's names (grad/diff.py).
_FIT_ALIASES = {"auto": "cuda", "pallas": "cuda", "physical_core": "physical"}
_FIT_PHYSICAL_ENGINES = ("physical", "physical_pallas")
_FIT_ENGINES = ("cuda", "core") + _FIT_PHYSICAL_ENGINES


def _check_engine(cfg, engines=_ENGINES):
    if cfg.engine not in engines:
        raise SystemExit(f"unknown engine '{cfg.engine}'; available: {', '.join(engines)}")
    if _sharded(cfg) and cfg.engine == "split":
        raise SystemExit(
            "engine 'split' is a single-device parity/analysis tier "
            "and does not support a multi-device mesh; drop the mesh "
            "or use engine core/cuda/physical"
        )


def _sharded(cfg) -> bool:
    return cfg.mesh.tile * cfg.mesh.spp > 1


def _mesh(cfg, device):
    """The config's mesh: on its ``devices`` where it names them, else on
    every visible CUDA device, or the CPU for a CPU run. A mesh that is not
    exactly those devices, or that names a device of another type than
    ``--device``, is refused."""
    from .. import parallel

    other = [d for d in cfg.mesh.devices if torch.device(d).type != device.type]
    if other:
        raise SystemExit(
            f"mesh {cfg.mesh.tile}x{cfg.mesh.spp} refused: its devices {other} are not "
            f"of --device {device.type}'s type")
    devices = cfg.mesh.devices or ("cpu" if device.type == "cpu" else None)
    try:
        return parallel.make_mesh(tile=cfg.mesh.tile, spp=cfg.mesh.spp, devices=devices)
    except ValueError as e:
        raise SystemExit(f"mesh {cfg.mesh.tile}x{cfg.mesh.spp} refused: {e}") from None


def _device(name: str) -> torch.device:
    if name == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _renderer(cfg):
    """The configured engine as ``render(scene, camera, H, W, spp, bounces,
    seed, jitter=..., sample_offset=...)`` on one device. ``tri_nee``
    reaches the physical engines only; the reference tier has no light
    sampling and ignores it, as the JAX CLI does."""
    import functools

    from ..models.integrator import render_radiance
    from ..models.physical import render_physical
    from ..models.split import render_split
    from ..ops import render_kernel as rk
    from ..ops import render_physical as rp

    if cfg.engine == "split":
        return lambda *a, jitter=False, **kw: render_split(*a, **kw)
    if cfg.engine in _PHYSICAL_ENGINES:
        render = rp.render_physical_kernel if cfg.engine == "physical" else render_physical
        return functools.partial(render, tri_nee=cfg.tri_nee)
    return rk.render_kernel if cfg.engine == "cuda" else render_radiance


def _render_fn(cfg, device):
    """``_renderer``'s call through ``parallel.render_sharded`` on the
    config's mesh where it has more than one slot (the mesh is refused
    here, before any work, if it does not fit the devices)."""
    if not _sharded(cfg):
        return _renderer(cfg)
    import functools

    from ..parallel import render_sharded

    return functools.partial(render_sharded, mesh=_mesh(cfg, device),
                             engine=_SHARDED_ENGINES[cfg.engine],
                             tri_nee=cfg.tri_nee and cfg.engine in _PHYSICAL_ENGINES)


def _u8(image: np.ndarray) -> np.ndarray:
    """The accumulator's float32 mean image as RGB8."""
    from ..models.integrator import render_image_u8

    return render_image_u8(torch.from_numpy(image)).numpy()


def cmd_render(args):
    from ..ops.camera import Camera
    from ..utils import bitmap
    from ..utils import checkpoint as ckpt_mod
    from ..utils.config import RenderConfig, load
    from ..utils.metrics import MetricsLogger, throughput

    cfg = load(args.config) if args.config else RenderConfig()
    for name in ("width", "height", "spp", "max_bounces", "seed", "scene", "engine",
                 "checkpoint_every", "checkpoint_path"):
        v = getattr(args, name)
        if v is not None:
            setattr(cfg, name, v)
    cfg.engine = _ENGINE_ALIASES.get(cfg.engine, cfg.engine)
    for name in ("tri_nee", "debug_nans", "progressive"):
        if getattr(args, name):
            setattr(cfg, name, True)
    if args.out:
        cfg.output = args.out
    _check_engine(cfg)
    viewer = None
    if args.live:
        from ..utils.termview import TerminalViewer

        viewer = TerminalViewer()
    if (cfg.progressive or viewer is not None) and not cfg.checkpoint_every:
        cfg.checkpoint_every = max(1, cfg.spp // 8)  # 8 previews
    device = _device(args.device)
    render = _render_fn(cfg, device)

    scene = get_scene(cfg.scene, device)
    camera = Camera.reference(device, cfg.fov_deg)
    metrics = MetricsLogger(args.metrics)
    ck = None
    spp_done = spp_start = 0
    if cfg.checkpoint_path and Path(cfg.checkpoint_path).exists():
        ck = ckpt_mod.load_render(cfg.checkpoint_path)
        spp_done = spp_start = ck.spp_done
        print(f"resuming from {cfg.checkpoint_path}: {spp_done} spp done")
    chunk = cfg.checkpoint_every or (cfg.spp - spp_done)
    seconds = 0.0
    while spp_done < cfg.spp:
        n = min(chunk, cfg.spp - spp_done)
        t0 = time.perf_counter()
        rad = render(scene, camera, cfg.height, cfg.width, n, cfg.max_bounces, cfg.seed,
                     jitter=cfg.jitter, sample_offset=spp_done)
        rad = rad.cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0
        seconds += dt
        if cfg.debug_nans and not np.isfinite(rad).all():
            bad = int(np.count_nonzero(~np.isfinite(rad)))
            raise FloatingPointError(
                f"non-finite radiance in chunk at spp_done={spp_done}: {bad} values "
                f"(seed {cfg.seed}, engine {cfg.engine})")
        ck = ckpt_mod.accumulate(ck, rad, n, cfg.seed)
        spp_done = ck.spp_done
        if cfg.checkpoint_every:
            rps = throughput(cfg.height, cfg.width, n, cfg.max_bounces, dt)
            metrics.log("render_chunk", spp_done=spp_done, seconds=dt, rays_per_sec=rps)
            print(f"spp {spp_done}/{cfg.spp}  {dt:.2f}s  {rps:.3e} rays/s")
        if cfg.checkpoint_path:
            ckpt_mod.save_render(cfg.checkpoint_path, ck)
        if cfg.progressive and spp_done < cfg.spp:
            bitmap.write_bitmap(cfg.output, _u8(ck.image), y_inverted=True)
            metrics.log("progressive_preview", spp_done=spp_done)
        if viewer is not None:
            viewer.show(_u8(ck.image), caption=f"spp {spp_done}/{cfg.spp}")
    rendered = cfg.spp - spp_start
    rps = throughput(cfg.height, cfg.width, rendered, cfg.max_bounces, seconds) if rendered else 0.0
    mesh = [cfg.mesh.tile, cfg.mesh.spp]
    metrics.log("render", engine=cfg.engine, device=str(device), spp=rendered,
                seconds=seconds, rays_per_sec=rps, writer="numpy", mesh=mesh)
    where = f"mesh {mesh[0]}x{mesh[1]} on {device.type}" if _sharded(cfg) else str(device)
    print(f"spp {rendered}  {seconds:.2f}s  {rps:.3e} rays/s  ({cfg.engine} on {where})")
    if args.bounce_stats:
        _bounce_stats(cfg, scene, camera, metrics)
    # The image is the accumulator's mean, (rad * spp) / spp for one chunk,
    # as the JAX package writes it.
    bitmap.write_bitmap(cfg.output, _u8(ck.image), y_inverted=True)
    print(f"wrote {cfg.output} ({cfg.width}x{cfg.height}, {cfg.spp} spp, writer numpy)")


def _bounce_stats(cfg, scene, camera, metrics):
    """The per-bounce event histogram, counted on a render of its own at
    ``min(spp, 4)`` samples by the engine's tier, logged as a
    ``bounce_histogram`` record with that spp and the engine, and printed."""
    from ..models.integrator import render_bounce_stats
    from ..models.physical import render_bounce_stats_physical

    stats_spp = min(cfg.spp, 4)
    args = (scene, camera, cfg.height, cfg.width, stats_spp, cfg.max_bounces, cfg.seed)
    if cfg.engine in _PHYSICAL_ENGINES:
        stats = render_bounce_stats_physical(*args, jitter=cfg.jitter, tri_nee=cfg.tri_nee)
    else:
        stats = render_bounce_stats(*args)
    stats = {k: v.tolist() for k, v in stats.items()}
    metrics.log("bounce_histogram", spp=stats_spp, engine=cfg.engine, **stats)
    print(f"bounce histogram ({stats_spp} spp, per bounce): {stats}")


def _orbit_cameras(acfg, device):
    """The sweep's cameras: frame ``f`` on the circle of ``orbit_radius``
    around ``target``, at ``orbit_height``, looking at ``target``."""
    from ..ops.camera import Camera

    cams = []
    for f in range(acfg.frames):
        ang = 2.0 * np.pi * f / acfg.frames
        eye = (acfg.orbit_radius * np.sin(ang), acfg.orbit_height,
               acfg.target[2] - acfg.orbit_radius * np.cos(ang))
        cams.append(Camera.look_at(eye, acfg.target, device, fov_deg=acfg.render.fov_deg))
    return cams


def cmd_animate(args):
    """Camera sweep: frame ``f`` at seed ``seed + f``, written as
    ``frame_{f:04d}.bmp``. The device renders frame ``f + 1`` while the
    host copies out and hands over frame ``f``: its copy goes into pinned
    memory behind the render, and the host waits for that copy only after
    it has queued the next render. The native writer encodes and writes on
    its own threads; without it numpy encodes on this thread."""
    from ..models.integrator import render_image_u8
    from ..utils import bitmap, native
    from ..utils.config import AnimationConfig, load
    from ..utils.metrics import MetricsLogger, rays_per_render

    acfg = load(args.config, AnimationConfig) if args.config else AnimationConfig()
    cfg = acfg.render
    for name in ("width", "height", "spp", "max_bounces", "scene", "engine"):
        v = getattr(args, name)
        if v is not None:
            setattr(cfg, name, v)
    if args.frames:
        acfg.frames = args.frames
    if args.out_dir:
        acfg.out_dir = args.out_dir
    cfg.engine = _ENGINE_ALIASES.get(cfg.engine, cfg.engine)
    _check_engine(cfg)
    device = _device(args.device)
    render = _render_fn(cfg, device)

    scene = get_scene(cfg.scene, device)
    cameras = _orbit_cameras(acfg, device)
    out_dir = Path(acfg.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    metrics = MetricsLogger(args.metrics)
    viewer = None
    if args.live:
        from ..utils.termview import TerminalViewer

        viewer = TerminalViewer()
    writer = native.AsyncBitmapWriter() if native.available() else None
    writer_name = "native" if writer is not None else "numpy"
    rays = rays_per_render(cfg.height, cfg.width, cfg.spp, cfg.max_bounces)
    last = time.perf_counter()

    def hand_over(f, host, copied):
        """Wait for frame ``f``'s copy, give it to the writer, report the
        time since the last frame was handed over."""
        nonlocal last
        if copied is not None:
            copied.synchronize()
        u8 = host.numpy()
        path = out_dir / f"frame_{f:04d}.bmp"
        if writer is not None:
            writer.submit(path, u8, True)
        else:
            bitmap.write_bitmap(path, u8, y_inverted=True)
        if viewer is not None:
            viewer.show(u8, caption=f"frame {f + 1}/{acfg.frames}")
        now = time.perf_counter()
        dt, last = now - last, now
        metrics.log("frame", frame=f, seconds=dt, rays_per_sec=rays / dt, writer=writer_name,
                    engine=cfg.engine)
        print(f"frame {f + 1}/{acfg.frames}  {dt:.3f}s  {rays / dt:.3e} rays/s  "
              f"(writer {writer_name})")

    t0 = time.perf_counter()
    pending = None
    for f, camera in enumerate(cameras):
        u8 = render_image_u8(render(scene, camera, cfg.height, cfg.width, cfg.spp,
                                    cfg.max_bounces, cfg.seed + f, jitter=cfg.jitter))
        u8 = u8.to(device)  # a mesh's image lies on its first slot's device
        copied = None
        if device.type == "cuda":
            host = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(u8, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
        else:
            host = u8
        if pending is not None:
            hand_over(*pending)
        pending = (f, host, copied)
    if pending is not None:
        hand_over(*pending)
    if writer is not None:
        writer.drain()
    seconds = time.perf_counter() - t0
    metrics.log("animate", frames=acfg.frames, seconds=seconds, writer=writer_name,
                engine=cfg.engine, device=str(device))
    print(f"wrote {acfg.frames} frames to {out_dir} in {seconds:.2f}s "
          f"({cfg.engine} on {device}, writer {writer_name})")


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
    if args.checkpoint_path:
        fcfg.checkpoint_path = args.checkpoint_path
    if args.checkpoint_every:
        fcfg.checkpoint_every = args.checkpoint_every
    if fcfg.checkpoint_path and not fcfg.checkpoint_every:
        fcfg.checkpoint_every = max(1, fcfg.steps // 10)
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
    _check_engine(cfg, _FIT_ENGINES)
    if _sharded(cfg) and mode != "materials":
        raise SystemExit(f"fit --mode {mode} runs on one device; a mesh shards the "
                         "materials fit only (drop the mesh)")
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
        target = _render_fn(cfg, device)(true_scene, camera, cfg.height, cfg.width, cfg.spp,
                                         cfg.max_bounces, target_seed)

    t0 = time.time()
    callback = None
    if args.metrics:
        callback = lambda i, l: metrics.log("fit_step", step=i, loss=l, engine=cfg.engine)
    common = dict(steps=fcfg.steps, lr=fcfg.lr, seed0=cfg.seed, callback=callback,
                  engine=cfg.engine, checkpoint_path=fcfg.checkpoint_path or None,
                  checkpoint_every=fcfg.checkpoint_every)
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
    if _sharded(cfg):
        fitted, losses = _fit_sharded_materials(init, target, camera, cfg, fcfg, metrics,
                                                device, bool(args.metrics))
    else:
        fitted, losses = diff.fit_materials(init, target, camera, *shape, **common)
    err = float((fitted.materials.albedo - mats.albedo).abs().max())
    where = f" on mesh {cfg.mesh.tile}x{cfg.mesh.spp}" if _sharded(cfg) else ""
    print(f"fit{where}: {fcfg.steps} steps in {time.time() - t0:.1f}s, "
          f"loss {losses[0]:.3e} -> {losses[-1]:.3e}, max albedo err {err:.4f}")


def _fit_sharded_materials(init, target, camera, cfg, fcfg, metrics, device, log_steps):
    """Mesh-sharded material fit: ``parallel.make_train_step`` for every
    step, with the fit loop, seeds and checkpoints of ``diff.fit_materials``
    (``--checkpoint-path`` resumes it). Every step is logged with the mesh
    where metrics are written. Returns ``(scene, losses)``."""
    from .. import parallel
    from ..grad import diff

    mesh = _mesh(cfg, device)
    step = parallel.make_train_step(
        camera, cfg.height, cfg.width, cfg.spp, cfg.max_bounces, mesh,
        diff.apply_material_params, engine=cfg.engine)
    params = diff.make_material_params(init)
    opt = diff._adam(params, fcfg.lr)
    shape = [cfg.mesh.tile, cfg.mesh.spp]
    callback = None
    if log_steps:
        callback = lambda i, l: metrics.log("fit_step", step=i, loss=l, engine=cfg.engine,
                                            mesh=shape)
    losses = diff._run_fit_loop(
        lambda seed: step(params, opt, init, target, seed), fcfg.steps, cfg.seed, callback,
        params, opt, fcfg.checkpoint_path or None, fcfg.checkpoint_every)
    with torch.no_grad():
        return diff.apply_material_params(init, params), losses


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
             "physical_core: its eager integrator; split: the reference "
             "shader's two-branch estimator (eager, one device). A kernel "
             "engine takes its plain twin on --device cpu. pallas and "
             "physical_pallas, the JAX package's names, mean cuda and "
             "physical (default: the config's, else cuda)",
    )
    r.add_argument("--tri-nee", action="store_true", dest="tri_nee",
                   help="physical engines: light-sample emissive triangles "
                        "too (default: the config's)")
    r.add_argument("--bounce-stats", action="store_true", dest="bounce_stats",
                   help="log and print the per-bounce event histogram (hits, "
                        "misses, TIR deaths; light samples on the physical "
                        "engines) of a render at min(spp, 4)")
    r.add_argument("--checkpoint-every", type=int, dest="checkpoint_every",
                   help="render in chunks of this many spp, each folded into "
                        "the accumulator (default: the config's, else one chunk)")
    r.add_argument("--checkpoint-path", dest="checkpoint_path",
                   help="save the accumulator here after every chunk; a render "
                        "whose file exists resumes from it")
    r.add_argument("--progressive", action="store_true",
                   help="rewrite the output BMP with the mean so far after every "
                        "chunk (chunks of spp/8 unless set)")
    r.add_argument("--debug-nans", action="store_true", dest="debug_nans",
                   help="raise FloatingPointError when a chunk's radiance is not "
                        "finite, with the count, seed and engine: a check on the "
                        "host after each chunk (the JAX package's jax_debug_nans, "
                        "which re-runs the faulty operation, has no counterpart)")
    r.add_argument("--live", action="store_true",
                   help="draw the accumulating image in the terminal after every "
                        "chunk (ANSI truecolor; chunks of spp/8 unless set)")
    r.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    r.set_defaults(fn=cmd_render)

    a = sub.add_parser("animate", help="camera sweep to frames/")
    a.add_argument("--config", help="JSON animation config file (a render block, "
                                     "frames, orbit_radius, orbit_height, target, out_dir)")
    a.add_argument("--scene")
    a.add_argument("--width", type=int)
    a.add_argument("--height", type=int)
    a.add_argument("--spp", type=int)
    a.add_argument("--max-bounces", type=int, dest="max_bounces")
    a.add_argument("--engine", choices=list(_ENGINES) + list(_ENGINE_ALIASES),
                   help="as in render")
    a.add_argument("--frames", type=int)
    a.add_argument("--out-dir", dest="out_dir")
    a.add_argument("--metrics", help="metrics JSONL output path")
    a.add_argument("--live", action="store_true",
                   help="draw each frame in the terminal as it is written")
    a.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a.set_defaults(fn=cmd_animate)

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
    f.add_argument("--checkpoint-path", dest="checkpoint_path",
                   help="save the fit's state (variables, Adam's state, step, "
                        "losses) here; a fit whose file exists resumes from it, "
                        "bit for bit")
    f.add_argument("--checkpoint-every", type=int, dest="checkpoint_every",
                   help="steps between saves (default: steps/10 when a path is set)")
    f.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    f.set_defaults(fn=cmd_fit)
    return p


def main(argv=None):
    """Run a subcommand. With ``--metrics`` it runs under
    ``utils/tracing.recording()``, and its last record (``"kind": "spans"``)
    holds each span's count, total and largest milliseconds by name
    (``spans``) and what the counters counted (``counters``)."""
    args = build_parser().parse_args(argv)
    if not args.metrics:
        return args.fn(args)
    from ..utils import tracing
    from ..utils.metrics import MetricsLogger

    with tracing.recording() as rec:
        out = args.fn(args)
    MetricsLogger(args.metrics).log("spans", **rec.summary())
    return out


if __name__ == "__main__":
    sys.exit(main())
