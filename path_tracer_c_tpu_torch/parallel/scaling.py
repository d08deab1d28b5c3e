"""The scaling harness: rays/s against mesh size.

Counterpart of the JAX package's ``scripts/scaling_bench.py``: the glossy
scene rendered through ``render_sharded`` on growing ``tile x spp`` meshes
over the first 1, 2, 4, ... of a list of devices, with each mesh's
efficiency against the one-device point (``rays_per_sec / (n *
rays_per_sec_1)``). The devices are every visible card by default. A list
that names one device more than once (``cuda:0`` four times, or CPU slots,
the counterpart of the JAX rehearsal on fake CPU devices) runs the same
meshes on fewer devices: its lines say ``"repeated": true``, and their
efficiency measures the parallel layer's cost, not scaling.

``scripts/torch_scaling_bench.py`` prints ``scaling``'s lines.
"""

from __future__ import annotations

import torch

from ..ops.camera import Camera
from ..scene import demo
from ..utils.metrics import rays_per_render, shape_name
from ..utils.profiling import card_line, time_fn
from .mesh import make_mesh
from .render import render_sharded

__all__ = ["mesh_shapes", "scaling", "ENGINES", "SHAPE", "SMALL_SHAPE"]

# The JAX script's engines (scripts/scaling_bench.py:32-33), all names that
# render_sharded takes.
ENGINES = ("pallas", "core", "physical", "physical_pallas")
# (height, width, spp, bounces): the JAX script's TPU shape and its small
# one (:46-51).
SHAPE = (1024, 1024, 64, 8)
SMALL_SHAPE = (256, 256, 8, 4)
WARM_SEED = 99


def mesh_shapes(n_dev: int, spp_axis: int, spp: int, height: int) -> list:
    """``(tile, spp)`` of each mesh the harness runs on ``n_dev`` devices:
    1, 2, 4, ... devices, at most ``spp_axis`` of them on the spp axis, each
    mesh one whose axes divide the samples and the rows
    (``scripts/scaling_bench.py:58-64``)."""
    shapes, n = [], 1
    while n <= n_dev:
        spp_ax = min(spp_axis, n)
        if n % spp_ax == 0 and spp % spp_ax == 0 and height % (n // spp_ax) == 0:
            shapes.append((n // spp_ax, spp_ax))
        n *= 2
    return shapes


def scaling(devices, shape=SHAPE, engine: str = "pallas", spp_axis: int = 1, reps: int = 3):
    """``(line, image)`` for each mesh of ``mesh_shapes`` over ``devices``
    (a list of ``torch.device``; each mesh takes the first ``tile * spp``):
    the scene and camera on the first device (``render_sharded`` replicates
    them onto the mesh's other devices in each call), one warm-up render at seed
    ``WARM_SEED`` (the ``image`` returned), then the median of ``reps``
    renders by ``time_fn``. The line holds the JAX script's fields
    (``devices``, ``mesh``, ``rays_per_sec``, ``seconds``, ``efficiency``)
    and the engine, shape, device list, whether a device repeats, and the
    card's name and power limit."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {', '.join(ENGINES)}")
    devices = [torch.device(d) for d in devices]
    first = devices[0]
    scene, cam = demo.glossy_scene(first), Camera.reference(first)
    h, w, spp, bounces = shape
    rays = rays_per_render(h, w, spp, bounces)
    card = card_line(first)
    base = None
    for tile_ax, spp_ax in mesh_shapes(len(devices), spp_axis, spp, h):
        n = tile_ax * spp_ax
        mesh = make_mesh(tile=tile_ax, spp=spp_ax, devices=devices[:n])
        run = lambda seed: render_sharded(scene, cam, h, w, spp, bounces, seed, mesh,
                                          engine=engine)
        image = run(WARM_SEED)
        seconds = time_fn(run, warmup=0, iters=reps, seeds=range(1, reps + 1), device=first)
        rps = rays / seconds
        base = rps if base is None else base
        line = {
            "devices": n, "mesh": {"tile": tile_ax, "spp": spp_ax},
            "rays_per_sec": rps, "seconds": seconds, "efficiency": rps / (n * base),
            "repeated": len(set(devices[:n])) < n,
            "engine": engine, "shape": shape_name(shape),
            "device_list": [str(d) for d in devices[:n]], "card": card,
        }
        yield line, image
