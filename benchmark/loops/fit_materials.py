"""The ``fit_materials`` loop: back-to-back material fits.

A unit is one fit of ``steps`` steps from the corrupted materials
(``init``), as the command line's ``fit`` calls the entry without
``--metrics``. Before the window, set-up renders the target with
``target_entry`` and drives the first steps of fit 0 through the entry
(``steps=1`` and ``steps=3`` on variables of its own), which the check
reads. Every optimizer step of the window is timed by the benchmark's own
clock (``adam_step_s``, the mean of a fit's steps).

``numbers``: the reference (``reference/fit.follow``) follows fit 0's
first three steps. ``loss_gap``: the largest relative gap of those steps'
losses; ``grad_gap``: the first gradient as Adam read it; ``change_gap``:
the variables' change over the three steps (``harness/check.fit_gaps``).
"""

from __future__ import annotations

import time

import torch
from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                   register_optimizer_step_pre_hook)

from harness import check
from harness import window as _w
from reference import fit as ref_fit
from reference import scenes


def count_at(cell, seed: int) -> dict:
    """The inputs at which the kernel's events are counted: fit 0's first
    step, from the corrupted materials, without jitter."""
    cfg = cell.config
    tables = scenes.with_materials(scenes.scene(cfg["scene"]), **cell.traffic["init"])
    return {"tables": tables, "camera": scenes.camera(cfg["fov_deg"]),
            "seed": (seed + 1) & _w.MASK, "jitter": False}


def _target_seed(cell, seed: int) -> int:
    return (seed + int(cell.traffic["target_seed_offset"])) & _w.MASK


class _StepClock:
    """The host time of every optimizer step, by the benchmark's clock,
    through torch's global step hooks; ``fits`` holds one list a fit."""

    def __init__(self):
        self.fits, self._t0 = [], 0.0

    def __enter__(self):
        def pre(opt, args, kwargs):
            self._t0 = time.perf_counter()

        def post(opt, args, kwargs):
            if self.fits:
                self.fits[-1].append(time.perf_counter() - self._t0)

        self._hooks = (register_optimizer_step_pre_hook(pre),
                       register_optimizer_step_post_hook(post))
        return self

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()


def run(run: _w.Run) -> _w.Window:
    tr = run.cell.traffic
    H, W, spp, B = run.shape
    entry, make_vars = _w.resolve(tr["entry"]), _w.resolve(tr["variables"])
    cfg = run.cell.config
    tables, cam = scenes.scene(cfg["scene"]), scenes.camera(cfg["fov_deg"])
    init_tables = count_at(run.cell, run.seed)["tables"]
    true_scene, camera = _w.port_inputs(run, tables, cam)
    init, _ = _w.port_inputs(run, init_tables, cam)
    target_seed = _target_seed(run.cell, run.seed)
    target = _w.resolve(tr["target_entry"])(true_scene, camera, H, W, spp, B, target_seed)
    _w.sync(run.device)
    run.mark("inputs")
    steps, lr, engine = int(tr["steps"]), float(tr["lr"]), tr["engine"]
    stride = int(tr["seed_stride"])

    def run_fit(i, n, variables=None):
        return entry(init, target, camera, H, W, spp, B, steps=n, lr=lr,
                     seed0=(run.seed + stride * i) & _w.MASK, engine=engine, params=variables)

    # Fit 0's first steps, through the entry on variables of the benchmark's:
    # the first gradient as Adam reads it, and the variables after three steps.
    first = make_vars(init)
    run_fit(0, 1, first)
    grad = {k: (torch.zeros_like(v) if v.grad is None else v.grad).detach().double().cpu()
            for k, v in first.items()}
    three = make_vars(init)
    start = {k: v.detach().double().cpu() for k, v in three.items()}
    run_fit(0, 3, three)
    end = {k: v.detach().double().cpu() for k, v in three.items()}
    _w.sync(run.device)
    out = _w.Window(setup_s=time.perf_counter() - run.t0,
                    tables={"scene": tables, "init": init_tables, "camera": cam,
                            "target_seed": target_seed})
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
    out.kept = {"losses": losses0, "grad": grad, "start": start, "end": end}
    return out


def numbers(run: _w.Run, window: _w.Window) -> dict:
    t = window.tables
    ref = ref_fit.follow(t["scene"], t["init"], t["camera"], run.shape, run.seed & _w.MASK,
                         t["target_seed"], steps=3, lr=float(run.cell.traffic["lr"]),
                         device=run.device)
    return check.fit_gaps(window.kept, ref)


def controls(cell, seed: int, device, what: set) -> list:
    """The reference put in the program's place, judged by the cell's
    numbers against the float32 reference at fit 0's first steps:
    ``control`` computed in bfloat16; with ``faults``, ``half_batch`` (the
    loss and its gradient over every other row, the mean over those) and
    ``answer_altered`` (every step's render drawn at the next step's seed).
    A step that leaves the variables unchanged reads 1 on ``change_gap`` by
    its definition and is not run."""
    cfg, tr = cell.config, cell.traffic
    shape = (cfg["height"], cfg["width"], cfg["spp"], cfg["max_bounces"])
    tables, cam = scenes.scene(cfg["scene"]), scenes.camera(cfg["fov_deg"])
    init = count_at(cell, seed)["tables"]
    seed &= _w.MASK

    def follow(seed0=seed, **kw):
        return ref_fit.follow(tables, init, cam, shape, seed0, _target_seed(cell, seed),
                              steps=3, lr=float(tr["lr"]), device=device, **kw)

    ref = follow()
    out = []
    if "control" in what:
        out.append({"reading": "control", **check.fit_gaps(follow(dt=torch.bfloat16), ref)})
    if "faults" in what:
        half = lambda img, target: torch.mean((img[::2] - target[::2]) ** 2)
        out.append({"reading": "fault half_batch", **check.fit_gaps(follow(loss=half), ref)})
        out.append({"reading": "fault answer_altered",
                    **check.fit_gaps(follow(seed0=seed + 1), ref)})
    return out
