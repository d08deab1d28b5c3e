"""What every loop shares: a run, the window it hands on, and the drive
that runs whole units of work back to back.

A traffic mix (``traffic/<name>.json``) names its ``loop``, a file of its
own (``loops/<loop>.py``), and the program's ``entry`` (``module:function``
of the port), with the loop's parameters. A loop builds the program's
inputs from the benchmark's own tables (``reference/scenes.py``, handed
over through ``scene_from_arrays`` and ``Camera.from_arrays``), warms up
every shape it uses, then calls ``drive``: whole units of work back to
back, each after the last has ended, until ``seconds`` have passed; the
window ends with the last unit. In a traced run the units of the window's
first ``trace_seconds`` run under the profiler, and at least one unit runs
after it, so that the benchmark's own spans can be read without the
profiler's host cost.
"""

from __future__ import annotations

import contextlib
import importlib
import random
import time
from dataclasses import dataclass, field

import torch

from . import trace as _trace

MASK = 0xFFFFFFFF
PORT = "path_tracer_c_tpu_torch"
REFERENCE = "reference"


def _resolve(name: str, top: str):
    module, _, fn = name.partition(":")
    if module.split(".")[0] != top:
        raise ValueError(f"{name!r} is not a function of {top}")
    return getattr(importlib.import_module(module), fn)


def resolve(name: str):
    """The port's function ``module:function``; nothing outside the port."""
    return _resolve(name, PORT)


def reference(name: str):
    """The plain reference's function ``module:function`` (``reference.*``)."""
    return _resolve(name, REFERENCE)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Run:
    """One run of one cell."""

    cell: object
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    t0: float  # the process's start, on ``time.perf_counter``
    marks: dict = field(default_factory=dict)  # set-up's phases, seconds from ``t0``

    def mark(self, phase: str):
        self.marks[phase] = time.perf_counter() - self.t0

    @property
    def shape(self):
        c = self.cell.config
        return c["height"], c["width"], c["spp"], c["max_bounces"]


@dataclass
class Window:
    """What a loop hands on: its end-to-end numbers, the kept answers, its
    spans (one entry a unit, in order) and its trace."""

    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0
    attempted: int = 0
    e2e: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    kept: dict = field(default_factory=dict)
    prof: object = None
    traced_units: int = 0
    tables: dict = field(default_factory=dict)  # the benchmark's inputs, for the reference


def drive(run: Run, unit, trace_seconds: float) -> tuple:
    """Units ``unit(i)`` back to back for ``run.seconds``, the first
    ``trace_seconds`` of them under the profiler where the run is traced:
    ``(units, window seconds, profiler or None, units traced)``."""
    trace_s = min(trace_seconds, run.seconds)
    i = 0
    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(_trace.profiled(run.traced))
        if prof is not None:
            stack.enter_context(torch.profiler.record_function(_trace.WINDOW))
        w0 = time.perf_counter()
        while True:
            unit(i)
            i += 1
            done = time.perf_counter() - w0
            if done >= run.seconds or (prof is not None and done >= trace_s):
                break
    traced = i if prof is not None else 0
    while time.perf_counter() - w0 < run.seconds or (traced and i == traced):
        unit(i)
        i += 1
    return i, time.perf_counter() - w0, prof, traced


def timed(unit, record: list):
    """``unit`` that appends each call's seconds to ``record``."""
    def call(i):
        t0 = time.perf_counter()
        unit(i)
        record.append(time.perf_counter() - t0)
    return call


class Reservoir:
    """A uniform sample of ``k`` answers, drawn from the seed as they come."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), {}, 0

    def offer(self, index, value):
        if len(self.items) < self.k:
            self.items[index] = value
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                del self.items[sorted(self.items)[j]]
                self.items[index] = value
        self.seen += 1


def port_inputs(run: Run, tables: dict, cam: dict):
    """The port's scene and camera made from the benchmark's tables."""
    from path_tracer_c_tpu_torch.ops.camera import Camera
    from path_tracer_c_tpu_torch.scene.io import scene_from_arrays

    return scene_from_arrays(tables, run.device), Camera.from_arrays(cam, run.device)
