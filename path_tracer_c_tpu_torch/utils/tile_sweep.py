"""The tile sweep: the render kernels at every launch shape, and the checks
that a launch shape changes nothing but the time.

Counterpart of the JAX package's ``scripts/tile_sweep.py``, which timed its
Pallas kernels at several ``tile`` shapes (the pixels one program renders)
to choose ``DEFAULT_TILE`` and ``BWD_TILE``. Here the tile is the pixels
one block renders, one thread a pixel, with the warp footprint beside it
(``ops/render_kernel.TILES``; ``csrc/pt_sched.cuh`` ``Tile``): the timed
library holds each kernel at its default point, the sweep library the
others (``ops/build.py``).

- ``sweep``: each kernel as a user calls it (packing, zero-filled planes,
  launch) at each of its points, median of 3 by CUDA events
  (``utils/profiling.time_fn``), with its nominal rays a second (the JAX
  script's Grays/s), the kernel alone on operands packed once (median of 3
  timings of launches back to back over about 0.1 s, divided: the
  wrapper's host work would hide the tile at small shapes) and what ptxas
  gave that instantiation: at the
  headline (glossy 1024^2, 8 bounces; B1 and B3 at 64 spp, the gradient
  kernels at 16 spp, as the JAX script times its forward and backward),
  or at the shapes the defaults are compared at (``DEFAULT_SHAPES``).
- ``check_tiles``: at each point, B1-B4 equal to their default point bit
  for bit (images, every plane, thread-rounds and counted events), each
  point's warp lane-rounds equal to the twin's grouping under its
  footprint, B5 within ``BWD_RTOL`` of its twin and two launches the same
  bits; and ``fit_tile`` shrinking B2's 512-thread point at the bounce cap,
  where that point itself does not launch.
- ``code_report``: per instantiation of the timed library, ptxas's
  registers, stack and spills and the SASS loads and stores, keyed by name
  with the default tile taken out, to hold the default points' code
  against a checkout from before the tile.

Its imports are absolute: ``scripts/torch_tile_sweep.py --tree DIR`` loads
this file beside another checkout's package, and times a package without
``render_kernel.TILES`` (from before the tile) at its one launch shape.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

import path_tracer_c_tpu_torch as pt
from path_tracer_c_tpu_torch.ops import build
from path_tracer_c_tpu_torch.ops import render_grad as rg
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
from path_tracer_c_tpu_torch.utils.metrics import rays_per_render, shape_name
from path_tracer_c_tpu_torch.utils.profiling import time_fn

__all__ = ["sweep", "check_tiles", "code_report", "summarize", "points", "parse_points",
           "GROUPS",
           "HEADLINE", "DEFAULT_SHAPES", "KIND_NAMES", "BWD_RTOL", "BWD_ATOL_SCALE"]

KIND_NAMES = {"fwd": "B1", "fused": "B2", "phys": "B3", "phys_fused": "B4", "phys_bwd": "B5"}
# The JAX script's modes (fwd, bwd, both) and the port's other kernels. Its
# "bwd" is the reference tier's backward, which in the port is B2's
# Jacobian and its contraction.
GROUPS = {"fwd": ("fwd",), "bwd": ("fused",), "both": ("fwd", "fused"), "phys": ("phys",),
          "phys_fused": ("phys_fused",), "phys_bwd": ("phys_bwd",),
          "all": ("fwd", "fused", "phys", "phys_fused", "phys_bwd")}
# (height, width, spp, max_bounces) of the headline: the JAX script's.
HEADLINE = {"fwd": (1024, 1024, 64, 8), "phys": (1024, 1024, 64, 8),
            "fused": (1024, 1024, 16, 8), "phys_fused": (1024, 1024, 16, 8),
            "phys_bwd": (1024, 1024, 16, 8)}
# The shapes a default is compared at, with the kernels measured there: the
# headline as the main paths call it; config 4's fit (spheres32); the
# triangle-lit scene of the geometry-gradient asymmetry (tri_nee); the
# capacity sweep's 1024 spheres, whose tables a block stages.
DEFAULT_SHAPES = {
    "glossy 1024x1024/64spp/8b": ("glossy", (1024, 1024, 64, 8), tuple(KIND_NAMES)),
    "config 4 fit 256x256/8spp/3b": ("spheres32", (256, 256, 8, 3), ("fused", "phys_fused")),
    "triangle-lit 1024x1024/64spp/8b": ("tri_lit", (1024, 1024, 64, 8),
                                        ("phys", "phys_fused", "phys_bwd")),
    "spheres 1024 512x512/16spp/4b": ("spheres1024", (512, 512, 16, 4), ("fwd", "phys")),
}
# B5 against its twin: the JAX suite's gate between its two backward
# schemes (chip_smoke.py BWD_RTOL), with an absolute floor of a millionth
# of each leaf's largest entry.
BWD_RTOL, BWD_ATOL_SCALE = 2e-4, 1e-6
_BWD_LEAVES = (("materials", "albedo"), ("materials", "emission_color"),
               ("materials", "emission_strength"), ("materials", "transparency"),
               (None, "sky_color"), ("spheres", "center"), ("spheres", "radius"))


def has_tiles() -> bool:
    """Whether the imported package has launch shapes (a checkout from
    before them has one, and no ``tile=``)."""
    return hasattr(rk, "TILES")


def points(kind: str) -> tuple:
    """The names of ``kind``'s points, the default first; ``(None,)`` for a
    package without launch shapes."""
    if not has_tiles():
        return (None,)
    default = rk.tile_point(None, kind).name
    return (default, *(n for n in rk.KIND_TILES[kind] if n != default))


def parse_points(args) -> tuple:
    """Points written ``THxTW[/WHxWW]`` (the JAX script's ``THxTW``), as
    point names; raises ``ValueError`` for one that is no point."""
    return tuple(rk.tile_point(a).name for a in args)


def scene_named(name: str, device):
    """The scenes of ``DEFAULT_SHAPES`` and the headline."""
    from path_tracer_c_tpu_torch.utils.capacity_sweep import build_scene
    from path_tracer_c_tpu_torch.utils.geom_asym import tri_lit_scene

    return {"glossy": lambda: pt.demo.glossy_scene(device),
            "spheres32": lambda: pt.demo.random_spheres_scene(device),
            "tri_lit": lambda: tri_lit_scene(device),
            "spheres1024": lambda: build_scene(1024, 4, device)}[name]()


def _call(kind: str, scene, camera, shape, tile, tri_nee: bool):
    """``fn(seed)``: ``kind``'s kernel as a user calls it at ``shape``, at
    point ``tile`` (None: no ``tile`` argument), returning tensors that its
    work ends in. B4 with the live emitters' geometry planes, B5 with its
    cap at the live sphere emitters and a cotangent of ones."""
    h, w, spp, b = shape
    kw = {} if tile is None else {"tile": tile}
    n_em = rp.live_emitter_count(scene)
    n_tri = rp.live_tri_emitter_count(scene) if tri_nee else 0
    if kind == "fwd":
        return lambda s: rk.render_kernel(scene, camera, h, w, spp, b, s, **kw)
    if kind == "fused":
        return lambda s: rg.render_fused(scene, camera, h, w, spp, b, s, **kw)
    if kind == "phys":
        return lambda s: rp.render_physical_kernel(scene, camera, h, w, spp, b, s,
                                                   tri_nee=tri_nee, **kw)
    if kind == "phys_fused":
        return lambda s: pg.render_physical_fused(scene, camera, h, w, spp, b, s,
                                                  n_em_cap=n_em, tri_nee=tri_nee,
                                                  tri_em_cap=n_tri, **kw)
    g = torch.ones((h, w, 3), dtype=torch.float32, device=scene.device)

    def bwd(s):
        d = pg.render_physical_bwd(scene, camera, g, h, w, spp, b, s, n_em_cap=n_em,
                                   tri_nee=tri_nee, **kw)
        return (d.materials.albedo, d.sky_color)

    return bwd


# The timed kernels' sources (``render_kernel.KINDS``, which a checkout from
# before the tile lacks), and the seconds one alone timing spans.
_STEMS = {"fwd": "render_fwd", "fused": "render_fused", "phys": "render_phys",
          "phys_fused": "render_phys_fused", "phys_bwd": "render_phys_bwd"}
_ALONE_SPAN = 0.1


def _alone(kind: str, scene, camera, shape, tile, tri_nee: bool):
    """``launch(seed)``: ``kind``'s kernel alone at ``shape`` and point
    ``tile`` (None: no ``tile`` argument), on operands packed and outputs
    allocated once (planes zero-filled once; the kernel adds into them),
    with ``_call``'s arguments; returns its output. B1 and B3 through their
    ``packed_launcher``; B2, B4 and B5 through their C entry: the timed
    library's at the default point, the sweep library's elsewhere (B5's
    without a counter)."""
    h, w, spp, b = shape
    kw = {} if tile is None else {"tile": tile}
    if kind == "fwd":
        return rk.packed_launcher(scene, camera, h, w, spp, b, **kw)
    if kind == "phys":
        return rp.packed_launcher(scene, camera, h, w, spp, b, tri_nee=tri_nee, **kw)
    dev = scene.device
    t = None if tile is None else rk.tile_point(tile, kind)
    default = t is None or t == rk.tile_point(None, kind)
    entry = (getattr(build.load_library(), _STEMS[kind]) if default
             else rk._entry(_STEMS[kind], t))
    counter = (None,) if default or kind != "phys_bwd" else ()
    operands = rk._scene_operands(scene)
    par = rk._camera_params(camera, scene, h, w)
    planes = lambda n: torch.zeros((n, h, w), dtype=torch.float32, device=dev)
    img = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    keep = [operands, par, img]
    if kind == "fused":
        keep.append(planes(9 * scene.num_materials + 3))
        head = (*rk._table_args(operands), rk._ptr(par), rk._ptr(img), rk._ptr(keep[-1]),
                *counter)
        result, jitter = img, False
    else:
        ph = rp._phys_operands(scene, operands)
        em = rp._emitter_args(ph)
        n_em = rp.live_emitter_count(scene)
        n_tri = rp.live_tri_emitter_count(scene) if tri_nee else 0
        keep.append(ph)
        if kind == "phys_fused":
            jac = planes(9 * scene.num_materials + 3)
            jgeo = planes(12 * n_em) if n_em else None
            jtri = planes(27 * n_tri) if n_tri else None
            keep += [jac, jgeo, jtri]
            head = (*rk._table_args(operands), *em, rk._ptr(par), rk._ptr(img), rk._ptr(jac),
                    rk._ptr(jgeo), rk._ptr(jtri), *counter, 1, int(tri_nee), 0, n_em, n_tri)
            result = img
        else:
            g = torch.ones((h, w, 3), dtype=torch.float32, device=dev)
            eco = scene.materials.emission_color.contiguous()
            out = torch.empty((scene.num_materials + 1, 8), dtype=torch.float32, device=dev)
            geo = torch.empty((max(n_em, 1), 4), dtype=torch.float32, device=dev)
            th, tw = (8, 32) if t is None else (t.th, t.tw)
            partials = torch.empty(((out.numel() + geo.numel()) * -(-w // tw) * -(-h // th),),
                                   dtype=torch.float32, device=dev)
            keep += [g, eco, out, geo, partials]
            head = (*rk._table_args(operands), *em[:-1], rk._ptr(eco), em[-1], rk._ptr(par),
                    rk._ptr(g), rk._ptr(out), rk._ptr(geo), rk._ptr(partials), *counter, 1,
                    int(tri_nee), n_em)
            result = out
        jitter = True

    def launch(seed):
        err = entry(*head, *rk._run_args(h, w, spp, b, seed, 0, jitter, dev))
        if err != 0:
            raise RuntimeError(f"{_STEMS[kind]} at {tile}: CUDA error {err}")
        return result

    launch.keep = keep  # the pointers' tensors, kept alive
    return launch


def _same_work(kind: str, alone, called, scene, what: str) -> None:
    """Raise unless the kernel alone gave the image (B5: the albedo's
    cotangent) that the call as a user makes it gave at the same seed."""
    if kind == "phys_bwd":
        alone, called = alone[:scene.num_materials, 0:3], called[0]
    elif kind in ("fused", "phys_fused"):
        called = called[0]
    if not torch.equal(alone, called):
        raise AssertionError(f"{what}: the kernel alone differs from the call")


def _alone_seconds(launch, device) -> float:
    """Seconds a launch of ``launch`` takes: the median of 3 timings of as
    many launches back to back as span about ``_ALONE_SPAN`` seconds, by
    CUDA events, divided."""
    once = time_fn(launch, warmup=1, iters=1, seeds=(98, 99), device=device)
    reps = max(1, min(500, round(_ALONE_SPAN / once)))
    run = lambda s: [launch(s + 10 * i) for i in range(reps)][-1]
    return time_fn(run, warmup=0, iters=3, seeds=(1, 2, 3), device=device) / reps


# -- what ptxas and the SASS say -------------------------------------------


def _tools():
    """This checkout's ``ops/build.py``, loaded by its path, for its ptxas
    and SASS parsers: ``--tree`` may import a package without them."""
    path = Path(__file__).resolve().parents[1] / "ops" / "build.py"
    spec = importlib.util.spec_from_file_location("_tile_sweep_build", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_MEMORY_OPS = r"LDG|STG|LDS|STS|LDL|STL|LD|ST|ATOMS|ATOMG|RED"


# DefaultTile's template arguments, taken out of the timed library's names
# (B1's FwdTile stays in its names: B1 moved from DefaultTile).
_DEFAULT_TILE_NAME = "ptc::Tile<8,32,1,32>"


def code_report() -> dict:
    """Per instantiation of the timed library: ptxas's registers, stack and
    spills and the SASS memory operations (``_MEMORY_OPS``; all
    instructions under ``instructions``), keyed by the demangled name with
    the default tile taken out of its template arguments, so that a
    checkout from before the tile gives the same keys."""
    tools = _tools()
    ptx = tools.ptxas_entries(build.resource_usage())
    sass = tools.sass_opcodes(_MEMORY_OPS, build.library_path())
    names = tools.demangle(set(ptx) | set(sass))
    tile = _DEFAULT_TILE_NAME
    out = {}
    for mangled in set(ptx) | set(sass):
        key = names[mangled].replace("," + tile, "").replace("<" + tile + ">", "")
        out[key] = {**ptx.get(mangled, {}), **sass.get(mangled, {})}
    return dict(sorted(out.items()))


def _timed_instantiation(kind: str, tile_name) -> dict:
    """ptxas's registers and spills of ``kind``'s timed instantiation at
    point ``tile_name`` (no counter, no tri_nee or rough_grad; B1's and
    B3's with shared tables): from the timed library at the default point,
    from the sweep library at the others."""
    default = tile_name is None or tile_name == points(kind)[0]
    text = build.resource_usage() if default else build.resource_usage(rk._sweep_units())
    tools = _tools()
    found = tools.ptxas_entries(text)
    names = tools.demangle(found)
    t = rk.TILES[tile_name] if tile_name else None
    tile = f"ptc::Tile<{t.th},{t.tw},{t.wh},{t.ww}>" if t else ""
    kernel = {"fwd": "render_fwd_kernel<false,", "phys": "render_phys_kernel<false,false,",
              "fused": "render_fused_kernel<false,",
              "phys_fused": "render_phys_fused_kernel<false,false,false,",
              "phys_bwd": "render_phys_bwd_kernel<false,false,"}[kind]
    policy = {"fwd": ("Regen,ptc::SharedTables",), "phys": ("Regen,ptc::SharedTables",),
              "fused": ("SharedRecords", "PlaneAdds"),
              "phys_fused": ("LocalStores<32>", "PlaneAdds,0,4,ptc::LaneLoops,0"),
              "phys_bwd": ("LocalStores<32>", "WarpTables")}[kind]
    hits = [v for m, v in found.items()
            if all(p in names[m] for p in (kernel, tile, *policy))
            and (default or v.get("unit", "").startswith(rk.KINDS[kind] + " "))]
    if len(hits) != 1:
        raise AssertionError(f"ptxas: {len(hits)} timed instantiations of {kind} at "
                             f"{tile_name}, not one")
    return {k: hits[0].get(k) for k in ("registers", "spill_stores", "spill_loads")}


# -- the sweep ---------------------------------------------------------------


def sweep(kinds, device, point_names=None, shapes=None, log=print) -> list:
    """Time each kernel of ``kinds`` (``GROUPS``' values) at each of its
    points (``point_names``: only those) at the headline, or with
    ``shapes`` (names of ``DEFAULT_SHAPES``) at each of those where the
    kernel is measured. ``log`` gets one line a point: the kernel, the
    point, the shape, Grays/s, the median ms of 3 as called, the ms alone
    (``_alone``), and ptxas's registers and spills. Returns the lines'
    records."""
    camera = pt.Camera.reference(device)
    where = ([(n, *DEFAULT_SHAPES[n]) for n in shapes] if shapes is not None
             else [(f"glossy {shape_name(HEADLINE[k])}", "glossy", HEADLINE[k], (k,))
                   for k in kinds])
    records, scenes = [], {}
    for label, scene_name, shape, measured in where:
        if scene_name not in scenes:
            scenes[scene_name] = scene_named(scene_name, device)
        scene = scenes[scene_name]
        for kind in kinds:
            if kind not in measured:
                continue
            for name in points(kind):
                if point_names is not None and name is not None and name not in point_names:
                    continue
                tri = scene_name == "tri_lit"
                fn = _call(kind, scene, camera, shape, name, tri)
                sec = time_fn(fn, warmup=1, iters=3, seeds=(99, 1, 2, 3), device=device)
                alone = _alone(kind, scene, camera, shape, name, tri)
                _same_work(kind, alone(7), fn(7), scene, f"{KIND_NAMES[kind]} {name} {label}")
                alone_sec = _alone_seconds(alone, device)
                del alone
                rec = {"kernel": KIND_NAMES[kind], "kind": kind,
                       "point": name or "8x32/1x32 (one shape)", "shape": label,
                       "grays_per_s": rays_per_render(*shape) / sec / 1e9, "ms": sec * 1e3,
                       "alone_ms": alone_sec * 1e3}
                if has_tiles():
                    rec.update(_timed_instantiation(kind, name))
                records.append(rec)
                log(f"{rec['kernel']} ({kind}) tile={rec['point']} {label}: "
                    f"{rec['grays_per_s']:.3f} Grays/s ({rec['ms']:.3f} ms as called, "
                    f"{rec['alone_ms']:.4f} ms alone); registers "
                    f"{rec.get('registers')}, spills {rec.get('spill_stores')} / "
                    f"{rec.get('spill_loads')} bytes")
            torch.cuda.empty_cache()
    return records


def summarize(runs) -> dict:
    """The defaults' verdict from sweeps of several runs (``runs``: the JSON
    objects ``scripts/torch_tile_sweep.py`` prints, ``{"label", "sweep"}``;
    parent, this, this, parent): by kernel, shape and timing (``alone``:
    the kernel on operands packed once, what the tile changes; ``as
    called``: with the wrapper's packing and planes), each point's times
    over the runs that have it, the default's spread (the default: the first
    run's first point, the parent's; its largest time less its smallest,
    over every run, a checkout from before the tile included), and whether
    the point won there: its slowest run faster than the default's fastest
    by more than that spread. A point beats the
    default where it won alone at every shape its kernel was measured at
    (``beats_default``; ``beats_default_as_called`` the same as called)."""
    timings = {"alone": "alone_ms", "as called": "ms"}
    times = {}
    for run in runs:
        for r in run["sweep"]:
            point = r["point"].split(" ")[0]
            for timing, key in timings.items():
                if key in r:
                    times.setdefault(r["kernel"], {}).setdefault(r["shape"], {}).setdefault(
                        timing, {}).setdefault(point, []).append(r[key])
    out = {}
    for kernel, shapes in sorted(times.items()):
        table, wins = {}, {timing: {} for timing in timings}
        for shape, by_timing in shapes.items():
            table[shape] = {}
            for timing, by_point in by_timing.items():
                default = next(iter(by_point))
                base = by_point[default]
                spread = max(base) - min(base)
                entry = {"default": default, "default_ms": sorted(base), "spread_ms": spread,
                         "points": {}}
                for point, ms in by_point.items():
                    if point == default:
                        continue
                    won = min(base) - max(ms) > spread
                    entry["points"][point] = {"ms": sorted(ms), "won": won}
                    wins[timing].setdefault(point, []).append(won)
                table[shape][timing] = entry
        out[kernel] = {"shapes": table,
                       "beats_default": sorted(p for p, w in wins["alone"].items() if all(w)),
                       "beats_default_as_called": sorted(
                           p for p, w in wins["as called"].items() if all(w))}
    return out


# -- the checks --------------------------------------------------------------


def _equal(a, b, what: str) -> None:
    if not (a.shape == b.shape and torch.equal(a, b)):
        raise AssertionError(f"{what}: differs from the default point's")


def _planes(out) -> list:
    """The tensors of a wrapper's result, in order."""
    return [t for t in (out if isinstance(out, tuple) else (out,)) if isinstance(t, torch.Tensor)]


def _counts(out) -> dict:
    """The counts of a wrapper's result (an int or a dict last), or none."""
    last = out[-1] if isinstance(out, tuple) else None
    return last if isinstance(last, dict) else ({"rounds": last} if isinstance(last, int)
                                                else {})


def _compare_cotangents(a, b, what: str) -> float:
    worst = 0.0
    for table, name in _BWD_LEAVES:
        x, y = (getattr(getattr(d, table) if table else d, name) for d in (a, b))
        x, y = x.double(), y.double()
        scale = max(float(y.abs().max()), 1.0) if y.numel() else 1.0
        worst = max(worst, float((x - y).abs().max()) / scale if x.numel() else 0.0)
        torch.testing.assert_close(x, y, rtol=BWD_RTOL, atol=BWD_ATOL_SCALE * scale,
                                   msg=lambda m: f"{what} d_{name}: {m}")
    return worst


def _same_bits(a, b, what: str) -> None:
    for table, name in _BWD_LEAVES:
        x, y = (getattr(getattr(d, table) if table else d, name) for d in (a, b))
        if not torch.equal(x, y):
            raise AssertionError(f"{what} d_{name}: two launches differ")


CHECK_SHAPES = {
    # (scene, height, width, spp, max_bounces, row_start, rows)
    "glossy 48x80/4spp/8b": ("glossy", 48, 80, 4, 8, 0, None),
    "glossy 19x45/4spp/8b (ragged)": ("glossy", 19, 45, 4, 8, 0, None),
    "glossy 48x80/4spp/8b rows 11-47": ("glossy", 48, 80, 4, 8, 11, 37),
}


def check_tiles(device, shapes=None, log=print) -> dict:
    """At each shape of ``CHECK_SHAPES`` (``shapes``: those names), every
    point of B1-B4 against the default point, bit for bit: the image, every
    plane (B2's Jacobian; B4's material, sphere-emitter geometry and
    triangle-vertex planes, on the triangle-lit scene with tri_nee as well
    where the shape is glossy's), the thread-rounds and counted events;
    each point's warp lane-rounds against the twin's grouping under its
    footprint (B1 and B3 regenerating, B2 and B4 per sample); B5 at each
    point against its twin within ``BWD_RTOL`` and a second launch bit for
    bit. Then ``fit_tile`` at B2's bounce cap: its 512-thread point shrinks
    to a point that launches, equal to the default, and the point itself
    fails to launch. Raises ``AssertionError`` at the first disagreement;
    returns the points checked and B5's largest relative difference."""
    from path_tracer_c_tpu_torch.utils.geom_asym import tri_lit_scene

    camera = pt.Camera.reference(device)
    scenes = {"glossy": pt.demo.glossy_scene(device), "tri_lit": tri_lit_scene(device)}
    summary = {"points": {}, "bwd_worst": 0.0}
    for label in (shapes or CHECK_SHAPES):
        scene_name, h, w, spp, b, row_start, rows = CHECK_SHAPES[label]
        n_rows = h if rows is None else rows
        cases = [(scenes[scene_name], False, label)]
        if label == next(iter(CHECK_SHAPES)):
            cases.append((scenes["tri_lit"], True, label.replace("glossy", "triangle-lit")))
        for scene, tri_nee, what in cases:
            n_em = rp.live_emitter_count(scene)
            n_tri = rp.live_tri_emitter_count(scene) if tri_nee else 0
            run = dict(row_start=row_start, rows=rows)
            calls = {
                "fwd": lambda t: rk.render_kernel(scene, camera, h, w, spp, b, 7,
                                                  count_rounds=True, tile=t, **run),
                "fused": lambda t: rg.render_fused(scene, camera, h, w, spp, b, 7,
                                                   count_rounds=True, tile=t, **run),
                "phys": lambda t: rp.render_physical_kernel(
                    scene, camera, h, w, spp, b, 7, tri_nee=tri_nee, count_events=True,
                    tile=t, **run),
                "phys_fused": lambda t: pg.render_physical_fused(
                    scene, camera, h, w, spp, b, 7, n_em_cap=n_em, tri_nee=tri_nee,
                    tri_em_cap=n_tri, count_events=True, tile=t, **run),
            }
            rough = lambda t: pg.render_physical_fused(
                scene, camera, h, w, spp, b, 7, n_em_cap=n_em, tri_nee=tri_nee,
                tri_em_cap=n_tri, rough_grad=True, tile=t, **run)
            groupings = {
                "fwd": lambda t: (rk.render_kernel_round_counts(
                    scene, camera, h, w, spp, b, 7, tile=t, **run),
                    rk.round_groupings(rk.reference_pixel_rounds(
                        scene, camera, h, w, spp, b, 7, row_start=row_start, rows=rows),
                        rk.TILES[t].footprint), "warp_lane_rounds_regen"),
                "fused": lambda t: (rg.render_fused_round_counts(
                    scene, camera, h, w, spp, b, 7, tile=t, **run),
                    rg.render_fused_round_counts_reference(
                        scene, camera, h, w, spp, b, 7, tile=t, **run), "warp_lane_rounds"),
                "phys": lambda t: (rp.render_physical_kernel_round_counts(
                    scene, camera, h, w, spp, b, 7, tri_nee=tri_nee, tile=t, **run),
                    rp.render_physical_kernel_round_counts_reference(
                        scene, camera, h, w, spp, b, 7, tri_nee=tri_nee, tile=t, **run),
                    "warp_lane_rounds_regen"),
                "phys_fused": lambda t: (pg.render_physical_fused_round_counts(
                    scene, camera, h, w, spp, b, 7, tri_nee=tri_nee, tile=t, **run),
                    pg.render_physical_fused_round_counts_reference(
                        scene, camera, h, w, spp, b, 7, tri_nee=tri_nee, tile=t, **run),
                    "warp_lane_rounds"),
            }
            for kind, call in calls.items():
                ref = call(None)
                ref_rough = rough(None) if kind == "phys_fused" else None
                done = set()
                for name in points(kind):
                    got = call(name)
                    for i, (x, y) in enumerate(zip(_planes(got), _planes(ref))):
                        _equal(x, y, f"{KIND_NAMES[kind]} {name} {what} output {i}")
                    if _counts(got) != _counts(ref):
                        raise AssertionError(f"{KIND_NAMES[kind]} {name} {what}: counts "
                                             f"{_counts(got)} against {_counts(ref)}")
                    if ref_rough is not None:
                        for i, (x, y) in enumerate(zip(_planes(rough(name)),
                                                       _planes(ref_rough))):
                            _equal(x, y, f"B4 {name} {what} rough_grad output {i}")
                    fp = rk.TILES[name].footprint
                    if fp not in done:
                        done.add(fp)
                        card, twin, key = groupings[kind](name)
                        if card["thread_rounds"] != twin["thread_rounds"] or card[key] != twin[key]:
                            raise AssertionError(
                                f"{KIND_NAMES[kind]} {name} {what}: rounds {card} against "
                                f"the twin's {twin} (footprint {fp})")
                    summary["points"].setdefault(KIND_NAMES[kind], set()).add(name)
                log(f"  tiles {KIND_NAMES[kind]} {what}: {len(points(kind))} points equal "
                    f"to the default bit for bit, warp lane-rounds the twin's")
            g = torch.rand((n_rows, w, 3), generator=torch.Generator().manual_seed(3)).to(device)
            bwd = lambda t: pg.render_physical_bwd(scene, camera, g, h, w, spp, b, 7,
                                                   n_em_cap=n_em, tri_nee=tri_nee, tile=t,
                                                   **run)
            twin = pg.render_physical_bwd_reference(scene, camera, g, h, w, spp, b, 7,
                                                    n_em_cap=n_em, tri_nee=tri_nee, **run)
            for name in points("phys_bwd"):
                first = bwd(name)
                _same_bits(first, bwd(name), f"B5 {name} {what}")
                summary["bwd_worst"] = max(summary["bwd_worst"], _compare_cotangents(
                    first, twin, f"B5 {name} {what}"))
                summary["points"].setdefault("B5", set()).add(name)
            log(f"  tiles B5 {what}: {len(points('phys_bwd'))} points within rtol {BWD_RTOL} "
                f"of the twin, two launches the same bits")
    # B2 at its bounce cap: the 512-thread point's records pass a block's limit.
    glossy = scenes["glossy"]
    cap = rg.MAX_BOUNCES
    big = rk.TILES["16x32/1x32"]
    fitted = rg.fused_tile(glossy, 37, 45, cap, big.name)
    if fitted.threads >= big.threads or fitted.footprint != big.footprint:
        raise AssertionError(f"fit_tile kept {fitted.name} at {cap} bounces")
    ref = rg.render_fused(glossy, camera, 37, 45, 2, cap, 5)
    for x, y in zip(rg.render_fused(glossy, camera, 37, 45, 2, cap, 5, tile=big.name), ref):
        _equal(x, y, f"B2 {big.name} fitted to {fitted.name} at {cap} bounces")
    try:
        rg._launch(glossy, camera, 37, 45, 2, cap, 5, 0, False, False, tile=big)
    except RuntimeError:
        pass
    else:
        raise AssertionError(f"B2 at {big.name} launched {cap} bounces of records "
                             f"({rk.block_smem('fused', big, glossy, cap)} bytes a block)")
    log(f"  tiles B2 at {cap} bounces: {big.name} ({rk.block_smem('fused', big, glossy, cap)} "
        f"bytes of records) fitted to {fitted.name}, equal to the default; unfitted it "
        f"does not launch")
    summary["fit"] = {"asked": big.name, "fitted": fitted.name, "max_bounces": cap}
    summary["points"] = {k: sorted(v) for k, v in summary["points"].items()}
    return summary
