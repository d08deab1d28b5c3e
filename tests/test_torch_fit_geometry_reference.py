"""PyTorch port: the emitter-geometry fit through B4, held against the
benchmark's plain reference of B4's light-sample chain.

``benchmark/reference/physical_fused.py`` (loaded by path, with the
benchmark's folder on ``sys.path`` as the benchmark puts it) is written from
B4's contract in plain PyTorch and imports neither JAX nor the port. On
seeded random scenes with one or two sphere emitters,
``fit_geometry(engine="physical_pallas")``, whose kernel runs here as its
plain twin, must follow the reference's first three steps: the losses, the
first gradient and the variables' change. The reference's events must be
the program's counters', and the benchmark's frozen operation and byte
counts of B4 the port's ``utils/flops.py``. The reference computed in
bfloat16 must fail the same tolerances.
"""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from path_tracer_c_tpu_torch.grad import diff
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.ops import render_physical_grad as rpg
from path_tracer_c_tpu_torch.ops.camera import Camera
from path_tracer_c_tpu_torch.scene.io import scene_from_arrays
from path_tracer_c_tpu_torch.utils.flops import kernel_op_counts

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
SHAPE = (24, 32, 4, 3)  # height, width, spp, bounces
SEEDS = (11, 2**31 + 5, 907)
LR = 0.05

# Tolerances, each relative, element by element. Over 14 seeded scenes
# (seven seeds, one and two emitters) the largest gaps read: losses 0 (B4's
# image is B3's, value for value, in the port and the reference alike, and
# the loss the same float32 mean; a later step's variables could differ by
# the gradients' rounding, which would move a loss in its last places);
# first gradient 7.7e-7 (the chain's adjoint summed over every valid light
# sample, by hand in the program and by autograd in the reference, in
# other orders: float32 rounding of sums of thousands of terms); the change
# over three steps 3.1e-6 (Adam divides the gradient by its running scale,
# so a small component carries that rounding and the moments'). Each
# tolerance is about six times its reading.
LOSS_RTOL = 1e-6
GRAD_RTOL = 5e-6
CHANGE_RTOL = 2e-5


@pytest.fixture(scope="module")
def bench():
    """The reference, the benchmark's B4 counts and its scene tables."""
    sys.path.insert(0, str(BENCH))
    try:
        from harness import spec

        pf = importlib.import_module("reference.physical_fused")
        scenes = importlib.import_module("reference.scenes")
        counts = spec.load_module(BENCH / "counts" / "b4.py", "test_counts_b4")
    finally:
        sys.path.remove(str(BENCH))
    return pf, scenes, counts


def _tables(scenes, seed: int, emitters: int) -> dict:
    """A ground of two triangles, four spheres of random albedo and
    roughness, and ``emitters`` emissive spheres above them."""
    rng = np.random.default_rng(seed)
    b = scenes._Builder((0.1, 0.12, 0.15))
    ground = b.material(albedo=tuple(rng.uniform(0.3, 0.8, 3)), roughness=0.9)
    b.triangle((-50, -1, -50), (50, -1, -50), (50, -1, 50), ground)
    b.triangle((-50, -1, -50), (-50, -1, 50), (50, -1, 50), ground)
    for i in range(emitters):
        m = b.material(albedo=(1.0, 1.0, 1.0), emission_color=tuple(rng.uniform(0.6, 1.0, 3)),
                       emission_strength=float(rng.uniform(8.0, 20.0)))
        b.sphere((float(rng.uniform(-3, 3)), float(rng.uniform(3, 5)),
                  float(rng.uniform(4, 8))), float(rng.uniform(0.5, 1.2)), m)
    for i in range(4):
        m = b.material(albedo=tuple(rng.uniform(0.2, 0.9, 3)),
                       roughness=float(rng.uniform(0.3, 1.0)))
        b.sphere((-2.4 + 1.6 * i, float(rng.uniform(-0.6, 0.2)), float(rng.uniform(5, 8))),
                 0.6, m)
    return b.build()


def _moved(tables, sphere):
    center = tables["spheres"]["center"].copy()
    center[sphere] += np.asarray([0.3, -0.2, 0.25], np.float32)
    return {**tables, "spheres": {**tables["spheres"], "center": center}}


def _program(true_tables, init_tables, cam, sphere, seed0, target_seed):
    """The port's geometry fit through B4's twin: fit 0's first gradient,
    its first three losses, and the variables before each step and after
    the third (fits of one, two and three steps)."""
    H, W, spp, B = SHAPE
    camera = Camera.from_arrays(cam, "cpu")
    target = rp.render_physical_kernel(scene_from_arrays(true_tables, "cpu"), camera, H, W, spp,
                                       B, target_seed, jitter=False)
    init = scene_from_arrays(init_tables, "cpu")

    def fit(steps, params):
        return diff.fit_geometry(init, target, camera, H, W, spp, B, sphere_indices=(sphere,),
                                 steps=steps, lr=LR, seed0=seed0, engine="physical_pallas",
                                 params=params)[1]

    host = lambda d: {k: v.detach().double() for k, v in d.items()}
    path, grad, losses = [host(diff.make_geometry_params(init, (sphere,)))], None, None
    for n in (1, 2, 3):
        variables = diff.make_geometry_params(init, (sphere,))
        losses = fit(n, variables)
        grad = grad or {k: v.grad.double() for k, v in variables.items()}
        path.append(host(variables))
    return {"losses": losses, "grad": grad, "start": path[0], "end": path[-1],
            "path": path[:-1]}


def _held(prog, ref):
    """Whether ``prog`` follows ``ref`` within the tolerances above."""
    close = lambda a, b, rtol: bool(torch.allclose(torch.as_tensor(a, dtype=torch.float64),
                                                   torch.as_tensor(b, dtype=torch.float64),
                                                   rtol=rtol, atol=0.0))
    change = lambda r, k: r["end"][k] - r["start"][k]
    return (close(prog["losses"], ref["losses"], LOSS_RTOL)
            and all(close(prog["grad"][k], ref["grad"][k], GRAD_RTOL) for k in ref["grad"])
            and all(close(change(prog, k), change(ref, k), CHANGE_RTOL) for k in ref["end"]))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("emitters", [1, 2])
def test_the_fit_follows_the_reference(bench, seed, emitters):
    pf, scenes, _ = bench
    tables = _tables(scenes, seed, emitters)
    sphere = emitters - 1  # the last emitter: with two, the pick covers both
    init = _moved(tables, sphere)
    cam = scenes.camera(90.0)
    seed0, target_seed = seed + 1000, seed + 12345
    prog = _program(tables, init, cam, sphere, seed0, target_seed)
    own = pf.follow(tables, init, cam, SHAPE, seed0, target_seed, sphere=sphere, block_rows=10)
    ref = pf.follow(tables, init, cam, SHAPE, seed0, target_seed, sphere=sphere, block_rows=10,
                    path=prog["path"])
    assert prog["losses"][0] == ref["losses"][0]
    for k in ("center", "radius_raw"):
        assert float(ref["grad"][k].abs().max()) > 0.0, k
    # Along the program's steps, as a check at config 3's size must take
    # them, and along its own: on these scenes a step does not yet reach
    # the loss's roughness.
    assert _held(prog, ref) and _held(prog, own), (prog, ref, own)


def test_the_bfloat16_control_fails(bench):
    """The reference in bfloat16, held as the program is: against the
    float32 reference along the bfloat16 run's steps."""
    pf, scenes, _ = bench
    tables = _tables(scenes, SEEDS[0], 1)
    init, cam = _moved(tables, 0), scenes.camera(90.0)
    args = (tables, init, cam, SHAPE, 17, 12345)
    control = pf.follow(*args, dt=torch.bfloat16)
    assert not _held(control, pf.follow(*args, path=control["path"]))


def test_the_reference_loads_neither_jax_nor_the_port():
    """Imported alone, with the benchmark's folder on the path as the
    benchmark puts it, the reference and the B4 counts load no module whose
    top-level name is ``jax``, ``jaxlib``, ``flax``, the JAX package or the
    port (names compared whole)."""
    probe = (f"import json, sys; sys.path.insert(0, {str(BENCH)!r}); "
             "import reference.physical_fused; from harness import spec; "
             f"spec.load_module(__import__('pathlib').Path({str(BENCH / 'counts' / 'b4.py')!r}), "
             "'b4'); print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "path_tracer_c_tpu", "path_tracer_c_tpu_torch"}


@pytest.mark.parametrize("emitters", [1, 2])
def test_the_events_and_counts_are_the_programs(bench, emitters):
    """The reference counts B3's four events and B4's valid light samples
    as the program's counting launches do; the benchmark's frozen counts of
    B4 equal ``utils/flops.py``'s at those events and one tracked emitter."""
    pf, scenes, counts = bench
    H, W, spp, B = SHAPE
    tables, cam = _tables(scenes, 5, emitters), scenes.camera(90.0)
    seed = 2**31 + 99
    ref_scene = pf.tracer.tensors(tables, "cpu")
    _, events = pf.render_physical_fused(ref_scene, pf.tracer.camera_tensors(cam, "cpu"), H, W,
                                         spp, B, seed, count=True)
    scene, camera = scene_from_arrays(tables, "cpu"), Camera.from_arrays(cam, "cpu")
    fwd = rp.render_physical_kernel(scene, camera, H, W, spp, B, seed, jitter=False,
                                    count_events=True)[1]
    own = rpg.render_physical_fused(scene, camera, H, W, spp, B, seed, jitter=False,
                                    n_em_cap=emitters, count_events=True)[-1]
    assert events == {**fwd, "valid_samples": own["valid_samples"]}
    assert events["rounds"] == own["rounds"] and events["valid_samples"] > 0
    assert counts.program_events(scene, camera, H, W, spp, B, seed, False) == events

    dims = {"spheres": scene.num_spheres, "triangles": scene.num_triangles,
            "materials": scene.num_materials}
    mine = counts.counts(dims, H, W, spp, events)
    port = kernel_op_counts("physical_fused_geom", scene, H, W, spp, B,
                            {"rounds": events["rounds"], "valid_samples": events["valid_samples"]},
                            fwd_events=fwd, n_em_cap=counts.EMITTER_CAP)
    assert mine == {k: port[k] for k in ("alu", "sqrt", "bytes")}
