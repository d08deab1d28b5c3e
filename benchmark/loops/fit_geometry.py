"""The ``fit_geometry`` loop: back-to-back fits of a light's centre and
radius.

A unit is one fit of ``steps`` steps of the first live sphere emitter (the
sphere the command line's geometry fit picks: the first whose material
emits), from its centre moved by ``shift``, through the traffic mix's entry
and engine, as the command line's ``fit --mode geometry`` calls it without
``--metrics``. Before the window, set-up renders the target with
``target_entry`` without jitter and drives fit 0's first steps through the
entry (fits of one, two and three steps on variables of their own), which
the check reads: the first gradient as Adam read it, and the variables
before each step and after the third. Every optimizer step of the window is
timed by the benchmark's own clock (``adam_step_s``, the mean of a fit's
steps).

``numbers``: the reference (``reference/physical_fused.follow``) takes fit
0's three steps, each from the variables the program had before it: the
loss is rough in the light's position, so a last-place difference in the
variables moves a later loss by tenths, and two runs are compared at the
same points. ``loss_gap``, ``grad_gap`` and ``change_gap`` as
``harness/check.fit_gaps``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import check
from harness import window as _w
from loops.fit_materials import _StepClock
from reference import physical_fused as ref_pf
from reference import scenes


def _light(tables: dict) -> int:
    """The first sphere in the emitter pool: active, its material's
    emission strength above zero."""
    sp = tables["spheres"]
    strength = tables["materials"]["emission_strength"][sp["material"]]
    live = np.asarray(sp["active"], bool) & (strength > 0.0)
    if not live.any():
        raise ValueError("the geometry fit needs a scene with an emissive sphere")
    return int(np.argmax(live))


def _start(cell) -> tuple:
    """``(true tables, the fit's starting tables, the fitted sphere)``."""
    tables = scenes.scene(cell.config["scene"])
    light = _light(tables)
    center = tables["spheres"]["center"].copy()
    center[light] += np.asarray(cell.traffic["shift"], center.dtype)
    return tables, {**tables, "spheres": {**tables["spheres"], "center": center}}, light


def count_at(cell, seed: int) -> dict:
    """The inputs at which the kernel's events are counted: fit 0's first
    step, from the moved light, without jitter."""
    _, init, _ = _start(cell)
    return {"tables": init, "camera": scenes.camera(cell.config["fov_deg"]),
            "seed": (seed + 1) & _w.MASK, "jitter": False}


def _target_seed(cell, seed: int) -> int:
    return (seed + int(cell.traffic["target_seed_offset"])) & _w.MASK


def run(run: _w.Run) -> _w.Window:
    tr = run.cell.traffic
    H, W, spp, B = run.shape
    entry, make_vars = _w.resolve(tr["entry"]), _w.resolve(tr["variables"])
    tables, init_tables, light = _start(run.cell)
    cam = scenes.camera(run.cell.config["fov_deg"])
    true_scene, camera = _w.port_inputs(run, tables, cam)
    init, _ = _w.port_inputs(run, init_tables, cam)
    target_seed = _target_seed(run.cell, run.seed)
    target = _w.resolve(tr["target_entry"])(true_scene, camera, H, W, spp, B, target_seed,
                                            jitter=False)
    _w.sync(run.device)
    run.mark("inputs")
    steps, lr, engine = int(tr["steps"]), float(tr["lr"]), tr["engine"]
    stride = int(tr["seed_stride"])
    tri_nee = True if tr["tri_nee"] else None  # as the command line passes it

    def run_fit(i, n, variables=None):
        return entry(init, target, camera, H, W, spp, B, sphere_indices=(light,), steps=n, lr=lr,
                     seed0=(run.seed + stride * i) & _w.MASK, engine=engine, tri_nee=tri_nee,
                     params=variables)

    # Fit 0's first steps, through the entry on variables of the benchmark's:
    # the first gradient as Adam reads it, and the variables before each step.
    host = lambda d: {k: v.detach().double().cpu() for k, v in d.items()}
    path, grad = [host(make_vars(init, (light,)))], None
    for n in (1, 2, 3):
        variables = make_vars(init, (light,))
        run_fit(0, n, variables)
        if grad is None:
            grad = {k: (torch.zeros_like(v) if v.grad is None else v.grad).detach().double().cpu()
                    for k, v in variables.items()}
        path.append(host(variables))
    _w.sync(run.device)
    out = _w.Window(setup_s=time.perf_counter() - run.t0,
                    tables={"scene": tables, "init": init_tables, "camera": cam,
                            "target_seed": target_seed, "light": light})
    losses0, fits = [], []

    with _StepClock() as clock:
        def unit(i):
            clock.fits.append([])
            _, losses = run_fit(i, steps)
            if i == 0:
                losses0.extend(losses[:3])

        out.units, out.window_s, out.prof, out.traced_units = _w.drive(
            run, _w.timed(unit, fits), tr["trace_seconds"])
    out.spans = {"fit_s": fits,
                 "adam_step_s": [sum(f) / len(f) if f else 0.0 for f in clock.fits]}
    out.attempted = out.units * steps
    out.e2e = {"fit_step_ms": out.window_s / (out.units * steps) * 1e3}
    out.kept = {"losses": losses0, "grad": grad, "start": path[0], "end": path[-1],
                "path": path[:-1]}
    return out


def numbers(run: _w.Run, window: _w.Window) -> dict:
    t = window.tables
    ref = ref_pf.follow(t["scene"], t["init"], t["camera"], run.shape, run.seed & _w.MASK,
                        t["target_seed"], sphere=t["light"], steps=3,
                        lr=float(run.cell.traffic["lr"]), device=run.device,
                        path=window.kept["path"])
    return check.fit_gaps(window.kept, ref)


def controls(cell, seed: int, device, what: set) -> list:
    """The reference put in the program's place, judged by the cell's
    numbers against the float32 reference at fit 0's first steps, each
    step from the float32 reference's variables: ``control`` computed in
    bfloat16; with ``faults``, ``half_batch`` (the loss and its gradient
    over every other row, the mean over those), ``answer_altered`` (every
    step's render drawn at the next step's seed) and
    ``radius_chain_dropped`` (the radius held in the cone weight). A step
    that leaves the variables unchanged reads 1 on ``change_gap`` by its
    definition and is not run."""
    cfg, tr = cell.config, cell.traffic
    shape = (cfg["height"], cfg["width"], cfg["spp"], cfg["max_bounces"])
    tables, init, light = _start(cell)
    cam = scenes.camera(cfg["fov_deg"])
    seed &= _w.MASK

    def follow(seed0=seed, **kw):
        return ref_pf.follow(tables, init, cam, shape, seed0, _target_seed(cell, seed),
                             sphere=light, steps=3, lr=float(tr["lr"]), device=device, **kw)

    ref = follow()
    out = []
    if "control" in what:
        out.append({"reading": "control",
                    **check.fit_gaps(follow(dt=torch.bfloat16, path=ref["path"]), ref)})
    if "faults" in what:
        for name, kw in (("half_batch", {"row_step": 2}), ("answer_altered", {"seed0": seed + 1}),
                         ("radius_chain_dropped", {"radius_chain": False})):
            out.append({"reading": f"fault {name}",
                        **check.fit_gaps(follow(path=ref["path"], **kw), ref)})
    return out
