#!/usr/bin/env python3
"""Times of the hand kernels on one GPU, with the card's name and power
limit; for comparing two checkouts in one call.

    python3 scripts/torch_fused_times.py [--tree DIR] [--label NAME]
                                         [--forward | --bwd | --phys-fused]

``--tree`` names another checkout (``git archive`` of a parent unpacked
under ``build/``) whose package is imported and built in place of this
one; every call below exists in the port since its gradient slices, so a
parent times through the same code. Run parent, this, this, parent in one
chip call to compare.

By default, the two fused primal + Jacobian kernels (B2
``csrc/render_fused.cu``, B4 ``csrc/render_phys_fused.cu``) and the fit
steps that launch them; each time the median of 3 after a warm-up:

- each kernel alone: 20 launches back to back on operands packed once
  (planes allocated once), by CUDA events, divided: B2 on the glossy scene
  at 1024x1024, 64 spp, 8 bounces and at config 4's fit shape (spheres32,
  256x256, 8 spp, 3 bounces); B4 at the glossy shape without and with the
  live emitter's geometry planes, and on cornell at the fit shape with
  them (the geometry fit's launch);
- each kernel as a user calls it (``render_fused``,
  ``render_physical_fused``: packing, zero-filled planes, launch), by CUDA
  events;
- a step of config 4's material fit (``fit_materials``) and of the
  geometry fit on B4 (``fit_geometry(engine="physical_pallas")``, cornell
  at the fit shape), 20 steps a call, on the host's clock.

With ``--bwd``, the two-pass oracle B5 (``csrc/render_phys_bwd.cu``)
instead: alone on operands packed once, as above, at the glossy shape with
the emitter cap at the live count and at config 4's shape (spheres32, cap
at its live count); the timed kernel and, where the tree has them, each of
its measurement instantiations (``render_physical_grad.BWD_VARIANTS``, through
``render_phys_bwd_variant``); and as a user calls it
(``render_physical_bwd``).

With ``--forward``, the two forward kernels instead: B1 (``csrc/render_fwd.cu``)
at the forward headline (glossy, 1024x1024, 64 spp, 8 bounces) and B3
(``csrc/render_phys.cu``) at config 3's shape (the same, jitter on), each
alone on packed operands as above, the timed kernel and, where the tree has
them, each of its instantiations (``render_kernel.VARIANTS``, through
``render_fwd_variant`` and ``render_phys_variant``), and each as a user
calls it.

With ``--phys-fused``, B4 (``csrc/render_phys_fused.cu``) alone, on operands
packed once as above, at six shapes: glossy 1024x1024, 64 spp, 8 bounces
with the emitter cap at the live count and at 0, and with ``rough_grad``;
the triangle-and-sphere-lit scene with ``tri_nee`` and both caps at their
live counts at the same size; config 4's shape (spheres32, cap at its live
count); the geometry fit's (the CLI fits' light scene, 128x128, 32 spp, 3
bounces, cap 1). The timed kernel and, where the tree has them, the
instantiations of B4's own policies (``render_physical_grad.POLICY_VARIANTS``;
not with ``rough_grad``, which they are built without), those whose planes
live in slots at 16, 32 and 48 floats a thread and at the splits of
``PROBE_SPLITS``; beside them the shared, local and generic loads and
stores in the SASS of each instantiation.

Prints one JSON line, and what ptxas said of the kernels timed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
H = W = 1024
SPP, BOUNCES = 64, 8
FIT = (256, 256, 8, 3)  # config 4's fit shape
REPEAT = 20


def this_module(path: str):
    """This checkout's module at ``path`` (under the package), loaded by
    its path: ``--tree`` may name a checkout without it."""
    spec = importlib.util.spec_from_file_location(
        "_this_" + Path(path).stem, REPO / "path_tracer_c_tpu_torch" / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card_line() -> str:
    """This checkout's ``utils/profiling.card_line`` for the card."""
    return this_module("utils/profiling.py").card_line("cuda")


def median_ms(fn, repeat=1, seeds=(1, 2, 3), warm=100) -> float:
    """Median milliseconds of ``repeat`` calls of ``fn(seed)`` back to back,
    by CUDA events, divided."""
    import torch

    fn(warm)
    times = []
    for seed in seeds:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for i in range(repeat):
            fn(seed + 10 * i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / repeat)
    return statistics.median(times)


def fit_step_ms(fn, steps=20, calls=3) -> float:
    """Median wall milliseconds a step of ``fn(seed0, steps)``, one warm-up
    call first."""
    import torch

    fn(1000, steps)
    torch.cuda.synchronize()
    times = []
    for i in range(calls):
        t0 = time.perf_counter()
        fn(2000 + 100 * i, steps)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / steps)
    return statistics.median(times)


def ptxas_lines(build, kernels) -> list[str]:
    """What ptxas said of the instantiations of each kernel in ``kernels``
    (names as in the mangled entry functions)."""
    out, keep = [], False
    for line in build.resource_usage().splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in kernels)
        if keep and ("Compiling entry function" in line or "registers" in line
                     or "stack frame" in line):
            out.append(line.split("ptxas info    :")[-1].strip())
    return out


def b2_launcher(lib, rk, scene, cam, h, w, spp, bounces):
    """B2's timed kernel on operands packed once: a function of the seed."""
    import torch

    dev = scene.device
    operands = rk._scene_operands(scene)
    par = rk._camera_params(cam, scene, h, w)
    img = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    jac = torch.zeros((9 * scene.num_materials + 3, h, w), dtype=torch.float32, device=dev)
    tables = (*rk._table_args(operands), rk._ptr(par), rk._ptr(img), rk._ptr(jac), None)

    def launch(seed):
        err = lib.render_fused(*tables, *rk._run_args(h, w, spp, bounces, seed, 0, False, dev))
        if err != 0:
            raise RuntimeError(f"render_fused: CUDA error {err}")

    launch.keep = (operands, par, img, jac)  # the pointers' tensors, kept alive
    return launch


def b4_launcher(lib, rk, rp, pg, scene, cam, h, w, spp, bounces, n_em_cap=0, tri_em_cap=0,
                tri_nee=False, rough_grad=False, variant=None, floats=None, split=None):
    """B4's timed kernel (``variant`` None) or one of its instantiations,
    jitter and next-event estimation on, on operands packed once, where its
    planes live in slots ``floats`` a thread (default the tree's), or with
    the ``split`` (sphere ordinals, triangle ordinals, emitter material
    slots) given: a function of the seed."""
    import torch

    dev = scene.device
    operands = rk._scene_operands(scene)
    ph = rp._phys_operands(scene, operands)
    par = rk._camera_params(cam, scene, h, w)
    planes = lambda k: torch.zeros((k, h, w), dtype=torch.float32, device=dev)
    img = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    jac = planes((12 if rough_grad else 9) * scene.num_materials + 3)
    jgeo = planes(12 * n_em_cap) if n_em_cap else None
    jtri = planes(27 * tri_em_cap) if tri_em_cap else None
    head = (*rk._table_args(operands), *rp._emitter_args(ph), rk._ptr(par), rk._ptr(img),
            rk._ptr(jac), rk._ptr(jgeo), rk._ptr(jtri))
    flags = (int(tri_nee), int(rough_grad), n_em_cap, tri_em_cap)
    if variant is None:
        go = lambda *run: lib.render_phys_fused(*head, None, 1, *flags, *run)
    else:
        split = split or pg._chip_split(scene, n_em_cap, tri_em_cap, variant, floats)
        go = lambda *run: lib.render_phys_fused_variant(
            pg.VARIANTS[variant], *head, 1, int(tri_nee), n_em_cap, tri_em_cap, *split, *run)

    def launch(seed):
        err = go(*rk._run_args(h, w, spp, bounces, seed, 0, True, dev))
        if err != 0:
            raise RuntimeError(f"render_phys_fused {variant}: CUDA error {err}")

    launch.keep = (operands, ph, par, img, jac, jgeo, jtri)  # the pointers' tensors, kept alive
    return launch


def b1_launcher(lib, rk, scene, cam, h, w, spp, bounces, variant=None):
    """B1 (``variant`` None) or one of its instantiations on operands packed
    once: a function of the seed. The tree's ``packed_launcher`` where it
    has one."""
    import torch

    if hasattr(rk, "packed_launcher"):
        return rk.packed_launcher(scene, cam, h, w, spp, bounces, variant)

    dev = scene.device
    operands = rk._scene_operands(scene)
    par = rk._camera_params(cam, scene, h, w)
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    tables = (*rk._table_args(operands), rk._ptr(par), rk._ptr(out), None)
    go = (lib.render_fwd if variant is None
          else lambda *a: lib.render_fwd_variant(rk.VARIANTS[variant], *a))

    def launch(seed):
        err = go(*tables, *rk._run_args(h, w, spp, bounces, seed, 0, False, dev))
        if err != 0:
            raise RuntimeError(f"render_fwd {variant}: CUDA error {err}")

    launch.keep = (operands, par, out)  # the pointers' tensors, kept alive
    return launch


def b3_launcher(lib, rk, rp, scene, cam, h, w, spp, bounces, variant=None):
    """B3 (``variant`` None) or one of its instantiations, jitter and
    next-event estimation on, on operands packed once: a function of the
    seed. The tree's ``packed_launcher`` where it has one."""
    import torch

    if hasattr(rp, "packed_launcher"):
        return rp.packed_launcher(scene, cam, h, w, spp, bounces, variant)

    dev = scene.device
    operands = rk._scene_operands(scene)
    ph = rp._phys_operands(scene, operands)
    par = rk._camera_params(cam, scene, h, w)
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    tables = (*rk._table_args(operands), *rp._emitter_args(ph), rk._ptr(par), rk._ptr(out),
              None, 1, 0)
    go = (lib.render_phys if variant is None
          else lambda *a: lib.render_phys_variant(rk.VARIANTS[variant], *a))

    def launch(seed):
        err = go(*tables, *rk._run_args(h, w, spp, bounces, seed, 0, True, dev))
        if err != 0:
            raise RuntimeError(f"render_phys {variant}: CUDA error {err}")

    launch.keep = (operands, ph, par, out)  # the pointers' tensors, kept alive
    return launch


def b5_launcher(lib, rk, rp, pg, scene, cam, h, w, spp, bounces, n_em_cap, variant=None):
    """B5 (``variant`` None) or one of its instantiations, jitter and
    next-event estimation on, on operands packed once: a function of the
    seed. A tree from before the partial sums (no ``BWD_COUNTS``) takes the
    outputs zero-filled once and adds into them."""
    import torch

    dev = scene.device
    operands = rk._scene_operands(scene)
    ph = rp._phys_operands(scene, operands)
    par = rk._camera_params(cam, scene, h, w)
    eco = scene.materials.emission_color.contiguous()
    g = torch.randn((h, w, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    n_mat = scene.num_materials
    out = torch.zeros((n_mat + 1, 8), dtype=torch.float32, device=dev)
    geo = torch.zeros((max(n_em_cap, 1), 4), dtype=torch.float32, device=dev)
    em = rp._emitter_args(ph)
    head = (*rk._table_args(operands), *em[:-1], rk._ptr(eco), em[-1], rk._ptr(par),
            rk._ptr(g), rk._ptr(out), rk._ptr(geo))
    partials = None
    if hasattr(pg, "BWD_COUNTS"):
        n_blocks = -(-w // 32) * -(-h // 8)
        partials = torch.empty(((out.numel() + geo.numel()) * n_blocks,), dtype=torch.float32,
                               device=dev)
        head += (rk._ptr(partials),)
    if variant is not None:
        go = lambda *run: lib.render_phys_bwd_variant(pg.BWD_VARIANTS[variant], *head, 1,
                                                      n_em_cap, *run)
    elif partials is not None:
        go = lambda *run: lib.render_phys_bwd(*head, None, 1, 0, n_em_cap, *run)
    else:
        go = lambda *run: lib.render_phys_bwd(*head, 1, 0, n_em_cap, *run)

    def launch(seed):
        err = go(*rk._run_args(h, w, spp, bounces, seed, 0, True, dev))
        if err != 0:
            raise RuntimeError(f"render_phys_bwd {variant}: CUDA error {err}")

    launch.keep = (operands, ph, par, eco, g, out, geo, partials)  # the pointers' tensors
    return launch


def bwd_times(lib, pt, rk, rp, pg, dev, cam) -> dict:
    """B5 alone at the glossy shape and config 4's, with its other
    instantiations where this tree has them, and as called."""
    import torch

    glossy = pt.demo.glossy_scene(dev)
    spheres = pt.demo.random_spheres_scene(dev)
    n_live, n_live_s = rp.live_emitter_count(glossy), rp.live_emitter_count(spheres)
    shapes = {"": (glossy, (H, W, SPP, BOUNCES), n_live),
              " fit shape": (spheres, FIT, n_live_s)}
    alone = {}
    for suffix, (scene, shape, cap) in shapes.items():
        alone["B5" + suffix] = b5_launcher(lib, rk, rp, pg, scene, cam, *shape, cap)
        for v in getattr(pg, "BWD_VARIANTS", {}):
            alone[f"B5 {v}{suffix}"] = b5_launcher(lib, rk, rp, pg, scene, cam, *shape, cap, v)
    result = {"kernel_ms": {k: median_ms(fn, repeat=REPEAT) for k, fn in alone.items()}}
    del alone
    g = torch.randn((H, W, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    result["call_ms"] = {"B5": median_ms(lambda s: pg._grad_leaves(pg.render_physical_bwd(
        glossy, cam, g, H, W, SPP, BOUNCES, s, n_em_cap=n_live))[:8])}
    result["shapes"] = {"B5": f"glossy {H}x{W} {SPP}spp {BOUNCES}b, jitter on, n_em_cap={n_live}",
                        "fit shape": "spheres32 {}x{} {}spp {}b, jitter on, n_em_cap={}".format(
                            *FIT, n_live_s)}
    return result


def sass_memory_ops(build, kernel: str) -> dict:
    """Shared (LDS, STS), generic (LD, ST), local (LDL, STL) and global
    (LDG, STG) loads and stores, and all instructions, in the SASS of each
    instantiation of ``kernel`` in the library that ``build`` (the tree's
    ``ops/build.py``) built, by mangled name, counted by this checkout's
    ``ops/build.sass_opcodes``."""
    found = this_module("ops/build.py").sass_opcodes(r"LDS|STS|LDL|STL|LDG|STG|LD|ST",
                                                    build.library_path())
    return {name: counts for name, counts in found.items() if kernel in name}


# (sphere ordinals, triangle ordinals, emitter material slots) in slots, by
# shape: none (the instantiation's own cost); at glossy the emitter's
# geometry alone, its emission alone, and its emission with 15 slots more
# than the scene's one emitter material fills (shared memory a block takes
# from L1, alone); elsewhere the geometry of each family alone and both.
# Local slots take no emission planes.
PROBE_SPLITS = {
    "glossy geometry": ((0, 0, 0), (1, 0, 0), (0, 0, 1), (0, 0, 16)),
    "glossy": ((0, 0, 0), (0, 0, 1), (0, 0, 16)),
    "tri_light": ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0)),
    "spheres32 fit shape": ((0, 0, 0), (1, 0, 0), (2, 0, 0), (4, 0, 0)),
    "geometry fit shape": ((0, 0, 0), (1, 0, 0)),
}


def phys_fused_times(lib, build, pt, rk, rp, pg, dev, cam) -> dict:
    """B4 alone at the six shapes of ``--phys-fused``, with the
    instantiations of its own policies where this tree has them."""
    from chip_smoke import light_fit_scene, tri_light_scene

    glossy = pt.demo.glossy_scene(dev)
    spheres = pt.demo.random_spheres_scene(dev)
    tri = tri_light_scene(pt, dev)
    light = light_fit_scene(pt, dev)
    n_live, n_live_s = rp.live_emitter_count(glossy), rp.live_emitter_count(spheres)
    main_shape = (H, W, SPP, BOUNCES)
    shapes = {
        "glossy geometry": (glossy, main_shape, dict(n_em_cap=n_live)),
        "glossy": (glossy, main_shape, {}),
        "glossy rough_grad": (glossy, main_shape, dict(rough_grad=True)),
        "tri_light": (tri, main_shape, dict(tri_nee=True, n_em_cap=rp.live_emitter_count(tri),
                                            tri_em_cap=rp.live_tri_emitter_count(tri))),
        "spheres32 fit shape": (spheres, FIT, dict(n_em_cap=n_live_s)),
        "geometry fit shape": (light, (128, 128, 32, 3), dict(n_em_cap=1)),
    }
    variants = getattr(pg, "POLICY_VARIANTS", ())
    times = {}
    for label, (scene, shape, kw) in shapes.items():
        alone = {f"B4 {label}": b4_launcher(lib, rk, rp, pg, scene, cam, *shape, **kw)}
        for v in variants if not kw.get("rough_grad") else ():
            slots = pg.policy(v)["planes"] != "device"
            for floats in (16, 32, 48) if slots else (None,):
                name = f"B4 {v}{'' if floats is None else f'@{floats}'} {label}"
                alone[name] = b4_launcher(lib, rk, rp, pg, scene, cam, *shape, variant=v,
                                          floats=floats, **kw)
            for split in PROBE_SPLITS.get(label, ()) if slots else ():
                if (split[0] <= kw.get("n_em_cap", 0) and split[1] <= kw.get("tri_em_cap", 0)
                        and not (split[2] and pg.policy(v)["planes"] == "local")):
                    alone[f"B4 {v} split {split} {label}"] = b4_launcher(
                        lib, rk, rp, pg, scene, cam, *shape, variant=v, split=split, **kw)
        times.update({k: median_ms(fn, repeat=REPEAT) for k, fn in alone.items()})
        del alone
    result = {"kernel_ms": times,
              "kernel_policy": getattr(pg, "KERNEL_POLICY", {"loops": "lane", "planes": "device",
                                                             "blocks": 4}),
              "chip_plane_floats": getattr(pg, "CHIP_PLANE_FLOATS", 0),
              "shapes": {k: "{} {}x{} {}spp {}b {}".format(s.num_materials, *sh, kw)
                         for k, (s, sh, kw) in shapes.items()}}
    result["sass"] = sass_memory_ops(build, "render_phys_fused_kernel")
    return result


def forward_times(lib, pt, rk, rp, dev, cam) -> dict:
    """B1 and B3, alone and as called, with their instantiations where this
    tree has them."""
    glossy = pt.demo.glossy_scene(dev)
    main_shape = (H, W, SPP, BOUNCES)
    variants = list(getattr(rk, "VARIANTS", {}))
    alone = {"B1": b1_launcher(lib, rk, glossy, cam, *main_shape),
             "B3": b3_launcher(lib, rk, rp, glossy, cam, *main_shape)}
    for v in variants:
        alone[f"B1 {v}"] = b1_launcher(lib, rk, glossy, cam, *main_shape, v)
        alone[f"B3 {v}"] = b3_launcher(lib, rk, rp, glossy, cam, *main_shape, v)
    result = {"kernel_ms": {k: median_ms(fn, repeat=REPEAT) for k, fn in alone.items()}}
    result["call_ms"] = {
        "B1": median_ms(lambda s: rk.render_kernel(glossy, cam, *main_shape, s)),
        "B3": median_ms(lambda s: rp.render_physical_kernel(glossy, cam, *main_shape, s)),
    }
    result["kernel_policy"] = getattr(rk, "KERNEL_POLICY", {"schedule": "per_sample",
                                                            "tables": "global"})
    result["shapes"] = {"B1": f"glossy {H}x{W} {SPP}spp {BOUNCES}b",
                        "B3": f"glossy {H}x{W} {SPP}spp {BOUNCES}b, jitter on (config 3)"}
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--label", default="this")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--forward", action="store_true",
                      help="time B1 and B3 and their instantiations, not B2, B4 and the fits")
    mode.add_argument("--bwd", action="store_true",
                      help="time B5 and its instantiations, not B2, B4 and the fits")
    mode.add_argument("--phys-fused", action="store_true",
                      help="time B4 and the instantiations of its policies at six shapes")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_fused_times: no CUDA device")
    sys.path.insert(0, str(Path(args.tree).resolve()))
    sys.path.insert(1, str(REPO))
    import path_tracer_c_tpu_torch as pt
    from path_tracer_c_tpu_torch.grad import diff
    from path_tracer_c_tpu_torch.ops import build
    from path_tracer_c_tpu_torch.ops import render_grad as rg
    from path_tracer_c_tpu_torch.ops import render_kernel as rk
    from path_tracer_c_tpu_torch.ops import render_physical as rp
    from path_tracer_c_tpu_torch.ops import render_physical_grad as pg

    card = card_line()
    dev = torch.device("cuda", 0)
    cam = pt.Camera.reference(dev)
    result = {"label": args.label, "tree": args.tree, "card": card,
              "package": str(Path(pt.__file__).parent)}
    t0 = time.perf_counter()
    lib = build.load_library()
    result["build_seconds"] = time.perf_counter() - t0
    kernels = (("render_fwd_kernel", "render_phys_kernel") if args.forward
               else ("render_phys_bwd",) if args.bwd
               else ("render_fused_kernel", "render_phys_fused_kernel"))
    result["ptxas"] = ptxas_lines(build, kernels)
    print(f"{args.label}: built in {result['build_seconds']:.1f} s [{card}]", flush=True)
    if args.forward or args.bwd or args.phys_fused:
        result.update(forward_times(lib, pt, rk, rp, dev, cam) if args.forward
                      else bwd_times(lib, pt, rk, rp, pg, dev, cam) if args.bwd
                      else phys_fused_times(lib, build, pt, rk, rp, pg, dev, cam))
        print(json.dumps(result), flush=True)
        return 0

    glossy = pt.demo.glossy_scene(dev)
    spheres = pt.demo.random_spheres_scene(dev)
    cornell = pt.demo.cornell_spheres_scene(dev)
    n_live = rp.live_emitter_count(glossy)
    n_live_c = rp.live_emitter_count(cornell)
    main_shape = (H, W, SPP, BOUNCES)
    alone = {
        "B2": b2_launcher(lib, rk, glossy, cam, *main_shape),
        "B2 fit shape": b2_launcher(lib, rk, spheres, cam, *FIT),
        "B4": b4_launcher(lib, rk, rp, pg, glossy, cam, *main_shape, 0),
        "B4 geometry": b4_launcher(lib, rk, rp, pg, glossy, cam, *main_shape, n_live),
        "B4 geometry fit shape": b4_launcher(lib, rk, rp, pg, cornell, cam, *FIT, n_live_c),
    }
    result["kernel_ms"] = {k: median_ms(fn, repeat=REPEAT) for k, fn in alone.items()}
    del alone
    result["call_ms"] = {
        "B2": median_ms(lambda s: rg.render_fused(glossy, cam, *main_shape, s)),
        "B2 fit shape": median_ms(lambda s: rg.render_fused(spheres, cam, *FIT, s)),
        "B4": median_ms(lambda s: pg.render_physical_fused(glossy, cam, *main_shape, s)),
        "B4 geometry": median_ms(lambda s: pg.render_physical_fused(glossy, cam, *main_shape, s,
                                                                   n_em_cap=n_live)),
    }
    torch.cuda.empty_cache()

    fit_target = rk.render_kernel(spheres, cam, *FIT, 12345)
    li = int(rp.live_emitter_mask(cornell).argmax())
    geo_target = rp.render_physical_kernel(cornell, cam, *FIT, 12345, jitter=False)
    result["fit_step_ms"] = {
        "config 4 material fit": fit_step_ms(lambda s0, n: diff.fit_materials(
            spheres, fit_target, cam, *FIT, steps=n, lr=0.05, seed0=s0)),
        "geometry fit": fit_step_ms(lambda s0, n: diff.fit_geometry(
            cornell, geo_target, cam, *FIT, sphere_indices=(li,), steps=n, lr=0.02, seed0=s0,
            engine="physical_pallas")),
    }
    result["shapes"] = {"B2, B4": f"glossy {H}x{W} {SPP}spp {BOUNCES}b, geometry n_em_cap={n_live}",
                        "fit shape": "B2: spheres32, B4: cornell (n_em_cap={}), "
                                     "{}x{} {}spp {}b".format(n_live_c, *FIT)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
