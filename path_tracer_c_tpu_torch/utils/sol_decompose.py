"""Where the forward kernels' time goes, against their speed of light.

The counterpart of ``scripts/sol_decompose.py`` for the hand kernel B1
(``csrc/render_fwd.cu``), on the same workload (the glossy scene, 1024^2,
64 spp, 8 bounces; ``small``: 256^2, 8 spp, 4 bounces), and, with
``kind="physical"``, for B3 (``csrc/render_phys.cu``) on config 3's (the
same, jitter on). A kernel's operations (``utils/flops``) over the
per-class rates that kernel B6 measures give the time it would take if it
issued nothing but its counted operations, with no lane idle; four probes
account for the rest:

(a) fixed cost: B7 (``ops/sol_probes.sol_null``) on B1's exact launch
    does nothing but store the image. Called as B1 is called, its time is
    what a render call costs beside its rounds (the operand packing, the
    launch, the blocks' start and end, the store); launched on operands
    packed once, back to back, its time is the kernel's alone, and over
    the blocks it prices a block's start and end.
(b) table loads: B8 (``sol_micro``) with the table's scalars loaded at every
    object and hoisted; the difference prices one load, and the kernel's
    loads turn it into a share of its time: a round's scan (5 floats a
    sphere test, 10 a triangle test) and the 9 of the hit's material row
    (B3: and its emission strength), and B3's shadow scans (a scan each) and
    light samples (the pick list, the sphere and its radiance: 8 words).
(c) divergence: the thread-rounds the kernel runs against the rounds its
    warps run under the timed kernel's schedule
    (``render_kernel_round_counts``, ``render_physical_kernel_round_counts``):
    the share ``1 - thread / warp lane-rounds`` of the lane slots is idle.
    B1's counted operations are inflated by the ratio; B3's are counted again
    on the warps' events (its rounds, and the rounds in which some lane
    computes a light sample and runs a shadow scan, ``WARP_EVENTS``), the
    difference being divergence. Beside it (B1), the share of the useful
    rounds (rays alive: hits and misses of ``render_bounce_stats``) that B1
    never runs because it stops a path at zero throughput.
(d) the remainder: 1 less the counted operations' share, the divergence
    that inflates them, (a) and (b).

Beside them, the price of each policy of the timed kernel
(``csrc/pt_sched.cuh``): the kernel against itself under the other schedule
or the other table placement, the measurement instantiations of
``render_kernel.VARIANTS``, as called (``vs_<variant>_fraction``: how much
longer that instantiation takes, as a share of the kernel's time).

``fused_decompose`` does the same for the two fused primal + Jacobian
kernels, B2 (``csrc/render_fused.cu``) and B4 (``csrc/render_phys_fused.cu``,
with the live emitters' geometry planes), on the same workload. The parts
that no counter gives are priced on the kernel's measurement
instantiations (``render_grad.VARIANTS``, ``render_physical_grad.VARIANTS``):
the kernel's own body under another policy (``csrc/pt_fused.cuh``), so that
each price is the kernel against itself:

(a) the counted operations at B6's rates, and divergence from the counting
    instantiation's warp lane-rounds, as for B1;
(b) the planes' read-modify-writes: the kernel against its ``sink``
    instantiation, which adds the same values into one register;
(c) B4's geometry adjoint: ``sink`` with the geometry planes against it
    without them;
(d) the fixed cost: B7's call at the same shape (operand packing, launch,
    blocks) and the wrapper's zero-fill of the planes;
(e) the remainder.

Beside them, for B4, each of its own policies (its loops, its registers'
block budget, where its pixel-constant planes live) as the kernel against
its instantiation one policy away (``vs_<variant>_fraction``), and its
plane adds by family from its counting instantiation, with the share of
them whose planes depend on the pixel and the sampled emitter alone
(``pixel_constant_adds_share``: the geometry families' and the sampled
emitters' emission adds, which slots holding every tracked ordinal and
emitter material take off device memory; the hit's own emission on an
emitter material, also theirs, is not counted apart, so the share is a
floor), with the geometry planes and without them
(``pixel_constant_adds_share_no_geometry``: the same paths, since the
planes change no path).

Beside them, not among the parts: the per-bounce records, as the kernel
against its ``registers`` instantiation at 256^2, 8 spp, 3 bounces (records
fit registers only at a small bounce budget, and that instantiation is
built for one block a multiprocessor, so the reading mixes the records'
traffic with the register budget's); and the kernel against its records in
the other memory (B2: local, B4: shared) at the main shape.

With ``kind="physical_bwd"`` it decomposes the two-pass oracle B5
(``csrc/render_phys_bwd.cu``, the live emitters' geometry cotangents, an
image cotangent made from a seed) on its instantiations
(``render_physical_grad.BWD_VARIANTS``): (b) is the reduction, the kernel
against its ``sink``; (c) the sinks with and without the geometry; (d) B7's
call at the same shape; beside them the records in
shared memory against the kernel, and the counting instantiation's counts
of the add sites (``count_sites``) with the adds they make
(``bwd_atomics``).

Every number is measured on the card; without a CUDA device this raises.
"""

from __future__ import annotations

import statistics

import torch

from . import flops
from .metrics import rays_per_render
from ..models.integrator import render_bounce_stats
from ..ops import render_grad as rg
from ..ops import render_physical as rp
from ..ops import render_physical_grad as pg
from ..ops.camera import Camera
from ..ops import render_kernel as rk
from ..ops.render_kernel import render_kernel, render_kernel_round_counts
from ..ops.sol_probes import (MICRO_NOBJ, MICRO_REPS, micro_table, sol_micro, sol_null,
                              sol_null_launcher)
from ..scene import demo

__all__ = ["sol_decompose", "fused_decompose", "table_loads_per_round"]


def table_loads_per_round(scene) -> int:
    """Scene-table words a round of B1 loads: ``sphere_t`` reads 5 floats of
    each sphere, ``triangle_t`` 10 of each triangle, and a hit round's
    ``fetch_material`` the 9 floats of one material row (the winners'
    material indices and triangle normals come on top)."""
    return 5 * scene.num_spheres + 10 * scene.num_triangles + 9


def _table_loads(scene, kind: str, events: dict) -> int:
    """Table words a render loads: B1's rounds (``table_loads_per_round``),
    or B3's rounds (and the emission strength), shadow scans and light
    samples (see the module docstring)."""
    rounds = events["rounds"]
    if kind == "forward":
        return rounds * table_loads_per_round(scene)
    scan = 5 * scene.num_spheres + 10 * scene.num_triangles
    return (rounds * (table_loads_per_round(scene) + 1) + events["shadow_scans"] * scan
            + events["light_samples"] * 8)


def _median_seconds(fn, seeds=(1, 2, 3), warm=100, repeat: int = 1) -> float:
    """Median device time of ``fn(seed)`` by CUDA events, after one warm
    call; with ``repeat``, of ``repeat`` calls back to back, divided."""
    fn(warm)
    times = []
    for seed in seeds:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(repeat):
            fn(seed)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e-3 / repeat)
    return statistics.median(times)


def sol_decompose(device="cuda", small: bool = False, rates: dict | None = None,
                  kind: str = "forward", variant: str | None = None) -> dict:
    """B1's (``kind`` "forward") or B3's ("physical") time at the bench
    workload, decomposed; one flat dict of numbers (keys as
    ``scripts/sol_decompose.py`` where the meaning carries over).
    ``rates``: the per-class rates of ``flops.measure_op_rates`` (measured
    here if not given). ``variant``: decompose that measurement
    instantiation (``render_kernel.VARIANTS``) in place of the timed
    kernel; the policies' prices come with the timed kernel only."""
    if kind not in ("forward", "physical"):
        raise ValueError(f"kind must be 'forward' or 'physical', not {kind!r}")
    device = flops._cuda_device(device)
    height = width = 256 if small else 1024
    spp, bounces = (8, 4) if small else (64, 8)
    scene, cam = demo.glossy_scene(device), Camera.reference(device)
    shape = (scene, cam, height, width, spp, bounces)
    tile = rk.tile_point(None)  # B7's launch: B1's default tile
    n_blocks = -(-width // tile.tw) * -(-height // tile.th)
    nominal = rays_per_render(height, width, spp, bounces)
    warp_key = rk._warp_key(variant)
    suffix = warp_key[len("warp_lane_rounds"):]

    if kind == "forward":
        run = lambda s, v=None: (render_kernel(*shape, s) if v is None
                                 else rk.render_kernel_variant(*shape, s, v))
        rounds = render_kernel_round_counts(*shape, 1, variant=variant)
        events = {"rounds": rounds["thread_rounds"]}
    else:
        run = lambda s, v=None: (rp.render_physical_kernel(*shape, s) if v is None
                                 else rp.render_physical_kernel_variant(*shape, s, v))
        rounds = rp.render_physical_kernel_round_counts(*shape, 1, variant=variant)
        events = rp.render_physical_kernel(*shape, 1, count_events=True)[1]
    fwd_s = _median_seconds(lambda s: run(s, variant))
    thread_rounds, warp_rounds = rounds["thread_rounds"], rounds[warp_key]

    # (a) the fixed cost of a B1 call, and of its kernel's blocks
    null_s = _median_seconds(lambda s: sol_null(scene, cam, height, width))
    launch = sol_null_launcher(scene, cam, height, width)
    null_kernel_s = _median_seconds(lambda s: launch(), repeat=20)

    # (b) a table load
    table = micro_table(device)
    seed = lambda s: torch.tensor([[s]], dtype=torch.int32, device=device)
    reload_s = _median_seconds(lambda s: sol_micro(table, seed(s), height, width, hoisted=False))
    hoisted_s = _median_seconds(lambda s: sol_micro(table, seed(s), height, width, hoisted=True))
    thread_loads = MICRO_REPS * MICRO_NOBJ * 5 * height * width
    per_load_ns = max(reload_s - hoisted_s, 0.0) / thread_loads * 1e9
    table_words = _table_loads(scene, kind, events)
    table_load_s = table_words * per_load_ns * 1e-9

    # (c) divergence, and (B1) the exit at zero throughput
    divergence = 1.0 - thread_rounds / warp_rounds

    # (d) the counted operations at the measured rates, and what is left
    if rates is None:
        rates = flops.measure_op_rates(device)
    transc = {c: rates[c] for c in flops.CLASSES[1:]}
    report = flops.sol_report(kind, scene, height, width, spp, bounces, fwd_s, events,
                              alu_rate=rates["alu"], transc_rate=transc)
    sol_fraction = report["sol_fraction"]
    if kind == "forward":
        divergence_of_fwd = report["sol_seconds"] * (warp_rounds / thread_rounds - 1.0) / fwd_s
    else:
        warp_events = {"rounds": warp_rounds,
                       "diffuse_vertices": events["diffuse_vertices"] * warp_rounds / thread_rounds,
                       "light_samples": rounds["light_warp_lane_rounds" + suffix],
                       "shadow_scans": rounds["shadow_warp_lane_rounds" + suffix]}
        warp_report = flops.sol_report(kind, scene, height, width, spp, bounces, fwd_s,
                                       warp_events, alu_rate=rates["alu"], transc_rate=transc)
        divergence_of_fwd = (warp_report["sol_seconds"] - report["sol_seconds"]) / fwd_s
    startup = null_s / fwd_s
    table_fraction = table_load_s / fwd_s
    out = {
        "kernel": "B1 render_fwd" if kind == "forward" else "B3 render_phys",
        "workload": (f"{height}x{width}/{spp}spp/{bounces}b glossy, "
                     f"tile {rk.tile_point(None, flops._TILE_KINDS[kind]).name}")
                    + (", jitter on" if kind == "physical" else ""),
        "device": torch.cuda.get_device_name(device),
        "kernel_policy": rk.policy(variant),
        "fwd_seconds": fwd_s,
        "nominal_rounds": nominal,
        "executed_round_fraction": thread_rounds / nominal,
        "null_call_seconds": null_s,
        "null_kernel_seconds": null_kernel_s,
        "blocks": n_blocks,
        "per_block_startup_us": null_kernel_s / n_blocks * 1e6,
        "startup_fraction_of_fwd": startup,
        "block_startup_fraction_of_fwd": null_kernel_s / fwd_s,
        "micro_reload_seconds": reload_s,
        "micro_hoisted_seconds": hoisted_s,
        "per_table_load_ns": per_load_ns,
        "fwd_table_loads_per_round": table_words / thread_rounds,
        "table_load_fraction_of_fwd": table_fraction,
        "executed_thread_rounds": thread_rounds,
        "warp_lane_rounds": warp_rounds,
        "divergence_loss_fraction": divergence,
        "measured_rates": rates,
        "sol_seconds": report["sol_seconds"],
        "sol_fraction": sol_fraction,
        "divergence_fraction_of_fwd": divergence_of_fwd,
        "remainder_fraction_of_fwd": 1.0 - sol_fraction - divergence_of_fwd - startup
                                     - table_fraction,
    }
    if kind == "forward":
        stats = render_bounce_stats(scene, cam, height, width, spp, bounces, 1)
        useful = int((stats["hits"] + stats["misses"]).sum())
        out.update(useful_thread_rounds=useful,
                   zero_exit_saving_fraction=1.0 - thread_rounds / useful)
    else:
        out.update(events=events, **{k: v for k, v in rounds.items() if k != "thread_rounds"})
    for v in rk.VARIANTS if variant is None else ():
        t_v = _median_seconds(lambda s: run(s, v))
        out[f"{v}_seconds"] = t_v
        out[f"vs_{v}_fraction"] = (t_v - fwd_s) / fwd_s
    return out


# The shape of fused_decompose's records-in-registers reading: that
# instantiation takes at most 3 bounces.
RECORDS_SHAPE = (256, 256, 8, 3)


def fused_decompose(kind: str = "fused", device="cuda", small: bool = False,
                    rates: dict | None = None, twin_counts: dict | None = None) -> dict:
    """B2's (``kind`` "fused"), B4's ("physical_fused") or B5's
    ("physical_bwd") time at the bench
    workload, decomposed (module docstring); one flat dict of numbers. B4 is
    timed with the live emitters' geometry planes (its gradient headline),
    and without them beside it. ``rates``: as ``sol_decompose``'s.
    ``twin_counts``: ``round_groupings`` of the twin's rounds at this shape
    (``on_sample`` of ``render_fused_reference`` or
    ``render_physical_fused_reference``, seed 1), if the caller has them:
    they must agree with the kernel's counts, and add the warp lane-rounds
    that path regeneration would run. For B5, ``twin_counts`` is the twin's
    ``count_sites`` at this shape (seed 1), which must equal the kernel's."""
    if kind == "physical_bwd":
        return _bwd_decompose(device, small, rates, twin_counts)
    if kind not in ("fused", "physical_fused"):
        raise ValueError(f"kind must be 'fused', 'physical_fused' or 'physical_bwd', not {kind!r}")
    device = flops._cuda_device(device)
    height = width = 256 if small else 1024
    spp, bounces = (8, 4) if small else (64, 8)
    scene, cam = demo.glossy_scene(device), Camera.reference(device)
    shape = (scene, cam, height, width, spp, bounces)
    records_shape = (scene, cam, *RECORDS_SHAPE)
    if kind == "fused":
        geo = {}
        timed = lambda s, *a: rg.render_fused(*(a or shape), s)
        variant = lambda s, v, *a: rg.render_fused_variant(*(a or shape), s, v)
        moved = "local_records"
        rounds = rg.render_fused_round_counts(*shape, 1)
        events, op_kw, flops_kind = {"rounds": rounds["thread_rounds"]}, {}, "fused"
        n_planes = 9 * scene.num_materials + 3
    else:
        n_live = rp.live_emitter_count(scene)
        geo = {"n_em_cap": n_live}
        timed = lambda s, *a, **kw: pg.render_physical_fused(*(a or shape), s, **{**geo, **kw})
        variant = lambda s, v, *a, **kw: pg.render_physical_fused_variant(
            *(a or shape), s, v, **{**geo, **kw})
        moved = "shared_records"
        rounds = pg.render_physical_fused_round_counts(*shape, 1)
        events = pg.render_physical_fused(*shape, 1, count_events=True, **geo)[-1]
        fwd_events = rp.render_physical_kernel(*shape, 1, count_events=True)[1]
        op_kw, flops_kind = dict(fwd_events=fwd_events, **geo), "physical_fused_geom"
        n_planes = 9 * scene.num_materials + 3 + 12 * n_live
    thread_rounds, warp_rounds = rounds["thread_rounds"], rounds["warp_lane_rounds"]

    t = _median_seconds(timed)
    sink_s = _median_seconds(lambda s: variant(s, "sink"))
    moved_s = _median_seconds(lambda s: variant(s, moved))
    records_kernel = _median_seconds(lambda s: timed(s, *records_shape))
    records_regs = _median_seconds(lambda s: variant(s, "registers", *records_shape))
    null_s = _median_seconds(lambda s: sol_null(scene, cam, height, width))
    zero_fill_s = _median_seconds(lambda s: torch.zeros((n_planes, height, width),
                                                        dtype=torch.float32, device=device))
    if rates is None:
        rates = flops.measure_op_rates(device)
    report = flops.sol_report(flops_kind, scene, height, width, spp, bounces, t, events,
                              **op_kw, alu_rate=rates["alu"],
                              transc_rate={c: rates[c] for c in flops.CLASSES[1:]})
    sol_s = report["sol_seconds"]
    parts = {
        "sol_fraction": report["sol_fraction"],
        "divergence_fraction": sol_s * (warp_rounds / thread_rounds - 1.0) / t,
        "planes_fraction": (t - sink_s) / t,
        "fixed_fraction": (null_s + zero_fill_s) / t,
    }
    out = {
        "kernel": "B2 render_fused" if kind == "fused" else "B4 render_phys_fused",
        "workload": (f"{height}x{width}/{spp}spp/{bounces}b glossy, "
                     f"tile {rk.tile_point(None, flops._TILE_KINDS[kind]).name}")
                    + (f", geometry planes n_em_cap={geo['n_em_cap']}" if geo else ""),
        "device": torch.cuda.get_device_name(device),
        "seconds": t,
        "executed_thread_rounds": thread_rounds,
        "warp_lane_rounds": warp_rounds,
        "divergence_loss_fraction": 1.0 - thread_rounds / warp_rounds,
        "measured_rates": rates,
        "sol_seconds": sol_s,
        "sink_seconds": sink_s,
        f"{moved}_seconds": moved_s,
        "records_shape": "{}x{}/{}spp/{}b glossy".format(*RECORDS_SHAPE),
        "records_shape_seconds": records_kernel,
        "records_registers_seconds": records_regs,
        "records_share_at_records_shape": (records_kernel - records_regs) / records_kernel,
        "null_call_seconds": null_s,
        "zero_fill_seconds": zero_fill_s,
    }
    if geo:
        no_geo = _median_seconds(lambda s: timed(s, n_em_cap=0))
        sink_no_geo = _median_seconds(lambda s: variant(s, "sink", n_em_cap=0))
        parts["geometry_adjoint_fraction"] = (sink_s - sink_no_geo) / t
        out.update(no_geometry_seconds=no_geo, no_geometry_sink_seconds=sink_no_geo,
                   events=events)
    if kind == "physical_fused":
        # Each of B4's own policies, the kernel against itself; the plane adds
        # by family, and the share of them into pixel-constant planes.
        for v in pg.POLICY_VARIANTS:
            t_v = _median_seconds(lambda s: variant(s, v))
            out[f"{v}_seconds"] = t_v
            out[f"vs_{v}_fraction"] = (t_v - t) / t
        adds = {k: events[k] for k in pg.EVENTS if k.startswith("adds_")}
        geometry = adds["adds_sphere_geometry"] + adds["adds_triangle_geometry"]
        emitter, total = adds["adds_emitter_emission"], sum(adds.values())
        out.update(kernel_policy=pg.policy(), plane_adds=adds,
                   pixel_constant_adds_share=(emitter + geometry) / max(total, 1),
                   pixel_constant_adds_share_no_geometry=emitter / max(total - geometry, 1))
    if twin_counts is not None:
        if {k: twin_counts[k] for k in rounds} != rounds:
            raise AssertionError(f"the twin's rounds {twin_counts} are not the kernel's {rounds}")
        regen = twin_counts["warp_lane_rounds_regen"]
        out.update(warp_lane_rounds_regen=regen,
                   regen_divergence_loss_fraction=1.0 - thread_rounds / regen)
    parts["remainder_fraction"] = 1.0 - sum(parts.values())
    return {**out, **parts}


def _bwd_decompose(device, small: bool, rates: dict | None, twin_counts: dict | None) -> dict:
    """``fused_decompose(kind="physical_bwd")``: B5 at the bench workload."""
    device = flops._cuda_device(device)
    height = width = 256 if small else 1024
    spp, bounces = (8, 4) if small else (64, 8)
    scene, cam = demo.glossy_scene(device), Camera.reference(device)
    shape = (scene, cam, height, width, spp, bounces)
    n_live = rp.live_emitter_count(scene)
    g = torch.randn((height, width, 3), generator=torch.Generator().manual_seed(2)).to(device)
    # the Scene's leaves read back, so that a call's work is done when timed
    leaves = lambda d: pg._grad_leaves(d)[:8]
    timed = lambda s: leaves(pg.render_physical_bwd(
        scene, cam, g, height, width, spp, bounces, s, n_em_cap=n_live))
    variant = lambda s, v, cap=n_live: leaves(pg.render_physical_bwd_variant(
        scene, cam, g, height, width, spp, bounces, s, v, n_em_cap=cap))
    _, counts = pg.render_physical_bwd(*shape[:2], g, *shape[2:], 1, n_em_cap=n_live,
                                       count_sites=True)
    if twin_counts is not None and twin_counts != counts:
        raise AssertionError(f"the twin's counts {twin_counts} are not the kernel's {counts}")
    events = pg.render_physical_fused(*shape, 1, count_events=True, n_em_cap=n_live)[-1]
    fwd_events = rp.render_physical_kernel(*shape, 1, count_events=True)[1]
    thread_rounds, warp_rounds = counts["fwd_thread_rounds"], counts["fwd_warp_lane_rounds"]

    t = _median_seconds(timed)
    sink_s = _median_seconds(lambda s: variant(s, "sink"))
    sink_no_geo = _median_seconds(lambda s: variant(s, "sink", 0))
    shared_s = _median_seconds(lambda s: variant(s, "shared_records"))
    null_s = _median_seconds(lambda s: sol_null(scene, cam, height, width))
    if rates is None:
        rates = flops.measure_op_rates(device)
    report = flops.sol_report("physical_bwd", scene, height, width, spp, bounces, t, events,
                              fwd_events=fwd_events, n_em_cap=n_live, alu_rate=rates["alu"],
                              transc_rate={c: rates[c] for c in flops.CLASSES[1:]})
    sol_s = report["sol_seconds"]
    parts = {
        "sol_fraction": report["sol_fraction"],
        "divergence_fraction": sol_s * (warp_rounds / thread_rounds - 1.0) / t,
        "reduction_fraction": (t - sink_s) / t,
        "geometry_adjoint_fraction": (sink_s - sink_no_geo) / t,
        "fixed_fraction": null_s / t,
    }
    parts["remainder_fraction"] = 1.0 - sum(parts.values())
    out = {
        "kernel": "B5 render_phys_bwd",
        "workload": f"{height}x{width}/{spp}spp/{bounces}b glossy, "
                    f"tile {rk.tile_point(None, 'phys_bwd').name}, "
                    f"n_em_cap={n_live}",
        "device": torch.cuda.get_device_name(device),
        "seconds": t,
        "executed_thread_rounds": thread_rounds,
        "warp_lane_rounds": warp_rounds,
        "divergence_loss_fraction": 1.0 - thread_rounds / warp_rounds,
        "measured_rates": rates,
        "sol_seconds": sol_s,
        "sink_seconds": sink_s,
        "no_geometry_sink_seconds": sink_no_geo,
        "shared_records_seconds": shared_s,
        "vs_shared_records_fraction": (shared_s - t) / t,
        "null_call_seconds": null_s,
        "counts": counts,
        "atomics": pg.bwd_atomics(counts),
        "events": events,
    }
    return {**out, **parts}
