"""PyTorch port: the three measurement scripts' modules on the CPU.

- ``utils/capacity_sweep.py`` (``scripts/torch_capacity_sweep.py``): its
  scenes against the JAX script's ``build_scene`` leaf for leaf, the table
  bytes and placement at the sweep's points, B1's and B3's twins on the
  sweep's scenes against the Pallas kernels in interpret mode, the CLI's
  lines;
- ``utils/geom_asym.py`` (``scripts/torch_geom_asym_bench.py``): the
  triangle-lit scene against the JAX script's construction, the CLI's line;
- ``parallel/scaling.py`` (``scripts/torch_scaling_bench.py``): the mesh
  shapes against the JAX script's loop, a run on four CPU slots;
- each CLI's refusal without a card; ``utils/profiling.time_fn``'s seeds;
  the packed launchers' refusal of CPU tensors.

Tolerances: B1's twin against Pallas as tests/test_torch_render_kernel.py
holds it (0.999-quantile of |delta| < 1e-4, mean < 1e-5), B3's as
tests/test_torch_render_physical.py does (0.99-quantile < 1e-4, share above
1e-3 < 1%, means within 2e-3); sharded images against the one-slot image as
tests/test_torch_parallel.py holds them (bit for bit with no spp split,
rtol/atol 1e-6 with one).
"""

import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.ops.pallas_kernels import render_pallas
from path_tracer_c_tpu.ops.pallas_physical import render_physical_pallas
from path_tracer_c_tpu.scene import demo as jdemo
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.parallel import scaling as sc
from path_tracer_c_tpu_torch.scene.io import scene_from_arrays
from path_tracer_c_tpu_torch.utils import capacity_sweep as cs
from path_tracer_c_tpu_torch.utils import geom_asym as ga
from path_tracer_c_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_SWEEP = load_script("capacity_sweep")  # its main is guarded


def arrays(x):
    """A dataclass tree as nested numpy dicts under its field names."""
    if dataclasses.is_dataclass(x):
        return {f.name: arrays(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def assert_same_scene(port, jax_scene):
    """Every leaf of the port's scene equals the JAX scene's carried over
    through ``scene_from_arrays``: values, dtypes and shapes."""
    want = scene_from_arrays(arrays(jax_scene), "cpu")
    for table in ("materials", "spheres", "triangles"):
        for f in dataclasses.fields(getattr(want, table)):
            a, b = getattr(getattr(port, table), f.name), getattr(getattr(want, table), f.name)
            assert a.dtype == b.dtype and torch.equal(a, b), f"{table}.{f.name}"
    assert torch.equal(port.sky_color, want.sky_color)


# -- A17: the capacity sweep ------------------------------------------------------


@pytest.mark.parametrize("n_sph, n_mat", [(5, 4), (16, 15), (200, 4), (16, 1536)])
def test_sweep_scene_equals_the_jax_scripts(n_sph, n_mat):
    assert_same_scene(cs.build_scene(n_sph, n_mat, "cpu"), JAX_SWEEP.build_scene(n_sph, n_mat))


# (sweep, n): B1's and B3's table bytes (render_kernel.table_bytes); a table
# fits shared memory at or below the 49,152-byte budget.
TABLES = {
    ("spheres", 200): (5120, 8416), ("materials", 200): (7760, 8896),
    ("spheres", 1024): (24896, 41376), ("materials", 1024): (37424, 41856),
    ("spheres", 1536): (37184, 61856), ("materials", 1536): (55856, 62336),
    ("spheres", 2048): (49472, 82336), ("materials", 2048): (74288, 82816),
}


@pytest.mark.parametrize("sweep, n", list(TABLES))
def test_table_bytes_and_placement_at_the_sweep_points(sweep, n):
    scene = cs.sweep_scene(sweep, n, "cpu")
    b1, b3 = TABLES[sweep, n]
    assert (rk.table_bytes(scene), rk.table_bytes(scene, physical=True)) == (b1, b3)
    assert rk.SHARED_TABLE_BUDGET == 49152
    assert rk.tables_in_shared(scene) == (b1 <= 49152)
    assert rk.tables_in_shared(scene, physical=True) == (b3 <= 49152)


def test_the_sweep_points_straddle_the_budget():
    """Every JAX point fits the budget for both kernels; at 1536 spheres B3
    is over it and B1 under; at 2048 both are over; on the materials side
    1024 is under and 1536 over for both."""
    placed = {(s, n): (rk.tables_in_shared(cs.sweep_scene(s, n, "cpu")),
                       rk.tables_in_shared(cs.sweep_scene(s, n, "cpu"), physical=True))
              for s in cs.SWEEPS for n in cs.POINTS}
    assert all(placed[s, n] == (True, True) for s in cs.SWEEPS for n in (5, 15, 64, 200, 1024))
    assert placed["spheres", 1536] == (True, False)
    assert placed["spheres", 2048] == (False, False)
    assert placed["materials", 1536] == placed["materials", 2048] == (False, False)


def assert_forward_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b)
    assert np.quantile(err, 0.999) < 1e-4, np.quantile(err, 0.999)
    assert err.mean() < 1e-5, err.mean()


def assert_physical_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.all(np.isfinite(a))
    err = np.abs(a - b)
    assert np.quantile(err, 0.99) < 1e-4, np.quantile(err, 0.99)
    assert (err > 1e-3).mean() < 0.01, (err > 1e-3).mean()
    assert abs(a.mean() - b.mean()) < 2e-3, (a.mean(), b.mean())


@pytest.mark.parametrize("n_sph, n_mat", [(64, 4), (16, 64)])
@pytest.mark.parametrize("physical", [False, True], ids=["B1", "B3"])
def test_twins_match_pallas_interpret_on_sweep_scenes(n_sph, n_mat, physical):
    jscene = JAX_SWEEP.build_scene(n_sph, n_mat)
    scene = scene_from_arrays(arrays(jscene), "cpu")
    h, w, spp, bounces, seed = 8, 128, 1, 2, 7
    jcam, cam = J.Camera.reference(), P.Camera.reference("cpu")
    if physical:
        want = render_physical_pallas(jscene, jcam, h, w, spp, bounces, jnp.uint32(seed),
                                      tile=(8, 128), interpret=True)
        got = rp.render_physical_kernel_reference(scene, cam, h, w, spp, bounces, seed)
        assert_physical_close(got.numpy(), want)
    else:
        want = render_pallas(jscene, jcam, h, w, spp, bounces, jnp.uint32(seed),
                             tile=(8, 128), interpret=True)
        got = rk.render_kernel_reference(scene, cam, h, w, spp, bounces, seed)
        assert_forward_close(got.numpy(), want)


JAX_SWEEP_KEYS = ("sweep", "n", "n_spheres", "n_materials", "fwd_seconds", "fwd_rays_per_sec",
                  "physical_seconds", "physical_rays_per_sec", "shape")


def test_capacity_cli_on_the_cpu(monkeypatch, capsys):
    """``--cpu``: a line for each point of each sweep, in order, with the JAX
    script's keys, the shape it ran, each kernel's table bytes and placement,
    and no card-only time."""
    monkeypatch.setattr(cs, "SMALL_SHAPE", (8, 8, 1, 1))
    assert load_script("torch_capacity_sweep").main(["--cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [(d["sweep"], d["n"]) for d in lines] == [(s, n) for s in cs.SWEEPS
                                                     for n in cs.POINTS]
    for d in lines:
        assert all(k in d for k in JAX_SWEEP_KEYS)
        assert d["shape"] == "8x8/1spp/1b" and d["card"] == "cpu"
        assert d["fwd_rays_per_sec"] == 8 * 8 * 2 / d["fwd_seconds"]
        for key, physical in (("fwd", False), ("physical", True)):
            scene = cs.sweep_scene(d["sweep"], d["n"], "cpu")
            assert d[f"{key}_table_bytes"] == rk.table_bytes(scene, physical)
            assert d[f"{key}_tables"] == ("shared" if rk.tables_in_shared(scene, physical)
                                          else "global")
            for field in ("alone", "global_tables"):
                assert d[f"{key}_{field}_seconds"] is None
    assert lines[-1]["n_materials"] == 2049 and lines[6]["n_spheres"] == 2048


# -- A16: the geometry gradient, fused against eager -----------------------------


def jax_tri_lit_scene():
    """The JAX script's triangle-lit scene, transcribed from
    scripts/geom_asym_bench.py:119-152."""
    tri_scene = jdemo.glossy_scene()
    lampm = tri_scene.num_materials
    mats = jax.tree_util.tree_map(lambda a: jnp.concatenate([a, a[-1:]]), tri_scene.materials)
    mats = dataclasses.replace(
        mats,
        albedo=mats.albedo.at[lampm].set(jnp.zeros(3)),
        emission_color=mats.emission_color.at[lampm].set(jnp.asarray([1.0, 0.9, 0.7])),
        emission_strength=mats.emission_strength.at[lampm].set(18.0),
        transparency=mats.transparency.at[lampm].set(0.0),
        roughness=mats.roughness.at[lampm].set(1.0),
    )
    tri = tri_scene.triangles
    v0n = jnp.concatenate([tri.v0, jnp.asarray([[-1.5, 4.0, 5.0], [-1.5, 4.0, 7.0]], jnp.float32)])
    v1n = jnp.concatenate([tri.v1, jnp.asarray([[1.5, 4.0, 5.0], [1.5, 4.0, 7.0]], jnp.float32)])
    v2n = jnp.concatenate([tri.v2, jnp.asarray([[1.5, 4.0, 7.0], [-1.5, 4.0, 5.0]], jnp.float32)])
    trin = dataclasses.replace(
        tri, v0=v0n, v1=v1n, v2=v2n,
        material=jnp.concatenate([tri.material, jnp.asarray([lampm, lampm], jnp.int32)]),
        active=jnp.concatenate([tri.active, jnp.ones(2, tri.active.dtype)]),
    )
    return dataclasses.replace(tri_scene, materials=mats, triangles=trin)


def test_tri_lit_scene_equals_the_jax_scripts():
    scene = ga.tri_lit_scene("cpu")
    assert_same_scene(scene, jax_tri_lit_scene())
    assert (rp.live_emitter_count(scene), rp.live_tri_emitter_count(scene)) == (1, 2)


JAX_ASYM_KEYS = ("workload", "fused_geom_seconds", "fused_geom_rays_per_sec", "core_ad_seconds",
                 "core_ad_rays_per_sec", "ratio", "rays_nominal", "tri_workload",
                 "tri_geom_fused_seconds", "tri_geom_fused_rays_per_sec", "backend")


def test_geom_asym_cli_on_the_cpu(monkeypatch, capsys):
    """``--cpu`` (its shapes cut to 8x8, 1 spp, 1 bounce here): one line with
    every key of the JAX script's, finite, the pair with both sides run, and
    finite fused gradients."""
    monkeypatch.setattr(ga, "SHAPE", (8, 8, 1, 1))
    monkeypatch.setattr(ga, "SMALL_HEADLINE", (8, 8, 1, 1))
    assert load_script("torch_geom_asym_bench").main(["--cpu"]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    d = json.loads(line)
    for key in JAX_ASYM_KEYS:
        assert key in d
        if key not in ("workload", "tri_workload", "backend"):
            assert math.isfinite(d[key]) and d[key] > 0, key
    assert d["backend"] == "cpu" and d["rays_nominal"] == 8 * 8 * 2
    assert d["workload"] == "8x8/1spp/1b glossy (1 emitter)"
    assert d["tri_workload"] == "8x8/1spp/1b glossy+quad-lamp (1 sph + 2 tri emitters)"
    assert d["pair_workload"] == "8x8/1spp/1b glossy (1 emitter)"
    assert d["pair_core_ad_outcome"] == "ok" and d["pair_ratio"] > 0
    assert d["fused_grads_finite"] is True
    assert d["pair_core_ad_peak_bytes"] is None and d["card"] == "cpu"


def test_both_sides_reach_the_emitter_geometry():
    """The fused side's gradient reaches the emitter sphere's centre, as the
    eager side's does; both are finite."""
    scene, cam, shape = P.demo.glossy_scene("cpu"), P.Camera.reference("cpu"), (8, 8, 1, 2)
    target = rp.render_physical_kernel(scene, cam, *shape, 99)
    fused = ga.fused_grad(scene, cam, shape, target)(1)
    eager = ga.eager_grad(scene, cam, shape, target)(1)
    names = [(tb, nm) for tb, nm, _ in P.diff._float_leaves(scene)]
    center = names.index(("spheres", "center"))
    emitter = int(np.flatnonzero(rp.live_emitter_mask(scene))[0])
    for grads in (fused, eager):
        assert all(bool(torch.isfinite(g).all()) for g in grads if g is not None)
        assert float(grads[center][emitter].abs().sum()) > 0


# -- A18: the scaling harness ----------------------------------------------------


def jax_mesh_shapes(n_dev, spp_axis, spp, height):
    """scripts/scaling_bench.py:58-64, transcribed."""
    shapes = []
    n = 1
    while n <= n_dev:
        spp_ax = min(spp_axis, n)
        if n % spp_ax == 0 and spp % spp_ax == 0 and height % (n // spp_ax) == 0:
            shapes.append((n // spp_ax, spp_ax))
        n *= 2
    return shapes


@pytest.mark.parametrize("spp_axis", [1, 2])
@pytest.mark.parametrize("spp", [1, 8])
def test_mesh_shapes_match_the_jax_loop(spp_axis, spp):
    for n_dev in range(1, 9):
        for height in (1024, 12, 6):
            assert sc.mesh_shapes(n_dev, spp_axis, spp, height) == \
                jax_mesh_shapes(n_dev, spp_axis, spp, height)


@pytest.mark.parametrize("spp_axis", [1, 2])
def test_scaling_on_four_cpu_slots(spp_axis):
    """One line a mesh (1, 2, 4 slots); each image the one-slot image, bit
    for bit without an spp split."""
    lines = list(sc.scaling([torch.device("cpu")] * 4, (16, 16, 2, 2), spp_axis=spp_axis))
    shapes = [(d["mesh"]["tile"], d["mesh"]["spp"]) for d, _ in lines]
    assert shapes == sc.mesh_shapes(4, spp_axis, 2, 16) and len(shapes) == 3
    single = lines[0][1]
    assert single.shape == (16, 16, 3)
    for d, image in lines:
        assert d["devices"] == d["mesh"]["tile"] * d["mesh"]["spp"]
        assert d["repeated"] == (d["devices"] > 1)
        assert d["shape"] == "16x16/2spp/2b" and d["engine"] == "pallas"
        assert d["rays_per_sec"] == 16 * 16 * 2 * 3 / d["seconds"]
        if d["mesh"]["spp"] == 1:
            assert torch.equal(image, single)
        else:
            np.testing.assert_allclose(image.numpy(), single.numpy(), rtol=1e-6, atol=1e-6)
    assert lines[0][0]["efficiency"] == 1.0


def test_scaling_cli_prints_a_line_a_mesh(monkeypatch, capsys):
    monkeypatch.setattr(sc, "SMALL_SHAPE", (16, 16, 2, 2))
    main = load_script("torch_scaling_bench").main
    assert main(["--cpu", "--devices", "cpu,cpu,cpu,cpu", "--engine", "physical_pallas"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [d["devices"] for d in lines] == [1, 2, 4]
    for d in lines:
        assert {"devices", "mesh", "rays_per_sec", "seconds", "efficiency"} <= set(d)
        assert d["engine"] == "physical_pallas" and d["device_list"] == ["cpu"] * d["devices"]
    with pytest.raises(SystemExit, match="--devices must name CPU slots"):
        main(["--cpu", "--devices", "cuda:0"])


# -- refusals without a card -----------------------------------------------------


@pytest.mark.parametrize("script", ["torch_capacity_sweep", "torch_geom_asym_bench",
                                    "torch_scaling_bench"])
def test_cli_without_a_card_raises(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        load_script(script).main([])


def test_geom_asym_takes_one_eager_call_at_the_pair_where_asked(monkeypatch):
    """``pair_eager_reps=1``: the eager side at the pair's shape is one call
    with no warm-up, and the line says so."""
    calls = []
    real = ga.eager_grad

    def counted(scene, cam, shape, target):
        fn = real(scene, cam, shape, target)
        return lambda seed: calls.append((shape, seed)) or fn(seed)

    monkeypatch.setattr(ga, "eager_grad", counted)
    d = ga.geom_asym("cpu", (8, 8, 1, 1), (8, 8, 1, 1), (8, 16, 1, 1), reps=2,
                     pair_eager_reps=1)
    assert [seed for shape, seed in calls if shape == (8, 16, 1, 1)] == [1]
    assert [seed for shape, seed in calls if shape == (8, 8, 1, 1)] == [100, 1, 2]
    assert d["pair_core_ad_reps"] == 1 and d["reps"] == 2


def test_time_fn_gives_each_call_its_seed():
    seen = []
    t = profiling.time_fn(lambda x, s: seen.append(s) or {"y": x * s, "n": None},
                                  torch.ones(4), warmup=1, iters=3, seeds=(99, 1, 2, 3))
    assert seen == [99, 1, 2, 3] and t >= 0
    with pytest.raises(ValueError, match="seeds"):
        profiling.time_fn(lambda s: torch.ones(1), iters=3, seeds=(1, 2, 3))


@pytest.mark.parametrize("module", [rk, rp])
def test_packed_launchers_are_for_the_card_only(module):
    scene, cam = cs.build_scene(5, 4, "cpu"), P.Camera.reference("cpu")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        module.packed_launcher(scene, cam, 8, 8, 1, 1)
