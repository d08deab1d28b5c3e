"""PyTorch port: the physical kernel's plain twin
(``ops/render_physical.py``) against the JAX package's Pallas kernel
(interpret mode on the CPU) and its core ``render_physical``, the wrapper's
device and input rules, the emitter tables, and the physical engines of
the CLI. The CUDA kernel itself is tested in test_torch_cuda.py, which runs
without JAX on a machine with a card.

Tolerance (tests/test_pallas_physical.py's, for two compilations of one
estimator on the same RNG streams): the 0.99-quantile of |delta| below
1e-4, the share of |delta| > 1e-3 below 1%, the image means within 2e-3. A
rounding difference can flip a grazing path or a shadow ray at a cone's
rim: rare, large per pixel, zero in expectation.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.models.physical import render_physical as j_render_physical
from path_tracer_c_tpu.ops import pallas_physical as jpp
from path_tracer_c_tpu.scene import demo as jdemo
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.app import main as app
from path_tracer_c_tpu_torch.models import physical as pphys
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.scene.io import scene_from_arrays
from path_tracer_c_tpu_torch.utils import tracing

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
JCAM = J.Camera.reference()
PCAM = P.Camera.reference("cpu")


def tri_light_mixed_scene():
    """A triangle ceiling light, a sphere light and diffuse content: the
    mixed emitter pool of tests/test_pallas_physical.py."""
    b = J.SceneBuilder(sky_color=(0.01, 0.01, 0.02))
    ground = b.add_material(albedo=(0.6, 0.55, 0.5), roughness=1.0)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.9, 0.7),
                          emission_strength=20.0)
    slamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(0.8, 0.9, 1.0),
                           emission_strength=8.0)
    ball = b.add_material(albedo=(0.7, 0.3, 0.3), roughness=1.0)
    b.add_triangle(v0=(-40, -1, -40), v1=(40, -1, -40), v2=(40, -1, 40), material=ground)
    b.add_triangle(v0=(-40, -1, -40), v1=(-40, -1, 40), v2=(40, -1, 40), material=ground)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(1.0, 3.0, 4.0), v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(-1.0, 3.0, 6.0), v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_sphere(center=(0.0, -0.3, 5.0), radius=0.7, material=ball)
    b.add_sphere(center=(2.0, 2.0, 3.5), radius=0.4, material=slamp)
    return b.build()


SCENES = {
    "cornell": jdemo.cornell_spheres_scene, "glossy": jdemo.glossy_scene,
    "diffuse": jdemo.diffuse_sphere_scene, "tri_light": tri_light_mixed_scene,
}


def arrays(x):
    """A JAX dataclass tree as nested numpy dicts under its field names."""
    if dataclasses.is_dataclass(x):
        return {f.name: arrays(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def carry(jscene):
    return scene_from_arrays(arrays(jscene), "cpu")


def assert_images_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.all(np.isfinite(a))
    err = np.abs(a - b)
    assert np.quantile(err, 0.99) < 1e-4, np.quantile(err, 0.99)
    assert (err > 1e-3).mean() < 0.01, (err > 1e-3).mean()
    assert abs(a.mean() - b.mean()) < 2e-3, (a.mean(), b.mean())


# The JAX suite's own cases and shapes (tile (8, 128)), plus a sample offset.
CASES = [
    ("cornell", 16, 128, 2, 3, 7, {}),
    ("glossy", 16, 128, 2, 4, 11, {}),
    ("cornell", 8, 128, 2, 3, 3, dict(jitter=False)),
    ("cornell", 8, 128, 2, 3, 5, dict(nee=False)),
    ("diffuse", 8, 128, 2, 2, 9, {}),  # no emitter
    ("tri_light", 16, 128, 2, 3, 7, dict(jitter=False, tri_nee=True)),
    ("glossy", 8, 128, 1, 3, 2, dict(sample_offset=64)),
]


# -- (b) the twin against the Pallas kernel and the JAX core path ---------------


@pytest.mark.parametrize("name, h, w, spp, bounces, seed, kw", CASES)
def test_twin_matches_pallas_interpret(name, h, w, spp, bounces, seed, kw):
    jscene = SCENES[name]()
    want = jpp.render_physical_pallas(jscene, JCAM, h, w, spp, bounces, jnp.uint32(seed),
                                      tile=(8, 128), interpret=True, **kw)
    got = rp.render_physical_kernel_reference(carry(jscene), PCAM, h, w, spp, bounces, seed, **kw)
    assert got.shape == (h, w, 3) and got.dtype == torch.float32
    assert_images_close(got.numpy(), want)


@pytest.mark.parametrize("name, h, w, spp, bounces, seed, kw", CASES)
def test_twin_matches_jax_core(name, h, w, spp, bounces, seed, kw):
    jscene = SCENES[name]()
    want = j_render_physical(jscene, JCAM, h, w, spp, bounces, jnp.uint32(seed), **kw)
    got = rp.render_physical_kernel_reference(carry(jscene), PCAM, h, w, spp, bounces, seed, **kw)
    assert_images_close(got.numpy(), want)


@pytest.mark.parametrize("name, kw", [
    ("cornell", {}), ("tri_light", dict(tri_nee=True)), ("diffuse", dict(jitter=False)),
])
def test_twin_matches_eager_tier_at_a_ragged_size(name, kw):
    """No divisibility rule: 20x36 against the port's own eager tier."""
    pscene = carry(SCENES[name]())
    got = rp.render_physical_kernel_reference(pscene, PCAM, 20, 36, 2, 3, 4, **kw)
    assert_images_close(got.numpy(), pphys.render_physical(pscene, PCAM, 20, 36, 2, 3, 4, **kw).numpy())


# -- (c) executed rounds ---------------------------------------------------------


@pytest.mark.parametrize("name, kw", [
    ("cornell", {}), ("glossy", dict(jitter=False)), ("tri_light", dict(tri_nee=True)),
])
def test_count_rounds_matches_the_eager_tier(name, kw):
    """The rounds a kernel thread runs (those a path begins with nonzero
    throughput), counted by the twin and by the eager tier from its alive
    mask and throughput. A flipped path may move the count by a few
    rounds; the image is the uncounted one."""
    pscene = carry(SCENES[name]())
    args = (pscene, PCAM, 16, 64, 2, 4, 3)
    img, n = rp.render_physical_kernel(*args, count_rounds=True, **kw)
    _, n_eager = pphys.render_physical(*args, count_rounds=True, **kw)
    assert torch.equal(img, rp.render_physical_kernel_reference(*args, **kw))
    nominal = 16 * 64 * 2 * 5
    assert 16 * 64 * 2 <= n < nominal  # every sample runs a round; the sky ends many
    assert abs(n - n_eager) <= 0.002 * nominal, (n, n_eager)


def test_count_events_nest_and_follow_the_flags():
    """rounds >= diffuse vertices >= light samples >= shadow scans; without
    NEE, and without an emitter, no light sample is computed."""
    args = (carry(jdemo.glossy_scene()), PCAM, 16, 64, 2, 4, 3)
    img, ev = rp.render_physical_kernel(*args, count_events=True)
    assert tuple(ev) == rp.EVENTS
    assert ev["rounds"] == rp.render_physical_kernel(*args, count_rounds=True)[1]
    assert ev["rounds"] > ev["diffuse_vertices"] == ev["light_samples"] > ev["shadow_scans"] > 0
    assert torch.equal(img, rp.render_physical_kernel(*args))
    off = rp.render_physical_kernel(*args, count_events=True, nee=False)[1]
    assert off == {**ev, "light_samples": 0, "shadow_scans": 0}
    dark = rp.render_physical_kernel(carry(jdemo.diffuse_sphere_scene()), *args[1:],
                                     count_events=True)[1]
    assert dark["diffuse_vertices"] > 0 and dark["light_samples"] == dark["shadow_scans"] == 0


# -- the emitter tables ----------------------------------------------------------


def test_emitter_operands_match_jax():
    jscene = tri_light_mixed_scene()
    pscene = carry(jscene)
    em_cum, le_sph, n_em = rp._emitter_operands(pscene)
    j_cum, j_le, j_n = jpp._emitter_operands(jscene)
    np.testing.assert_array_equal(em_cum.numpy(), np.asarray(j_cum)[:, 0])
    np.testing.assert_array_equal(le_sph.numpy(), np.asarray(j_le))
    assert int(n_em) == int(j_n) == rp.live_emitter_count(pscene) == 1
    tri_cum, le_tri, area, n_em_t = rp._tri_emitter_operands(pscene)
    j_cum, j_le, j_area, j_n = jpp._tri_emitter_operands(jscene)
    np.testing.assert_array_equal(tri_cum.numpy(), np.asarray(j_cum)[:, 0])
    np.testing.assert_array_equal(le_tri.numpy(), np.asarray(j_le))
    np.testing.assert_allclose(area.numpy(), np.asarray(j_area)[:, 0], rtol=1e-6)
    assert int(n_em_t) == int(j_n) == rp.live_tri_emitter_count(pscene) == 2
    np.testing.assert_array_equal(rp.live_emitter_mask(pscene), jpp.live_emitter_mask(jscene))
    np.testing.assert_array_equal(rp.live_tri_emitter_mask(pscene),
                                  jpp.live_tri_emitter_mask(jscene))


@pytest.mark.parametrize("mask", [
    [0, 1, 0, 1, 1, 0], [0, 0, 0], [1, 1], [0], [1], [1, 0, 0, 0],
])
def test_pick_list_is_the_count_over_the_table(mask):
    """Entry k of the pick list is the TPU kernel's e_idx for ordinal k:
    the number of rows with cum <= k, clipped to the last row; so is
    searchsorted(cum, k + 1, left). Padding and inactive rows included."""
    cum = torch.cumsum(torch.tensor(mask, dtype=torch.int32), 0).to(torch.int32)
    rows = len(mask)
    got = rp._pick_list(cum).tolist()
    want = [min(sum(1 for c in cum.tolist() if c <= k), rows - 1) for k in range(rows)]
    assert got == want
    assert got == pphys._pick(cum.long(), torch.arange(rows), rows).tolist()
    n_em = sum(mask)
    assert [i for i, m in enumerate(mask) if m] == got[:n_em]  # the k-th emitter's row


def test_inactive_and_padded_emitters_are_not_sampled():
    """An emissive sphere that is inactive, and capacity padding, stay out
    of the pool: the render equals the one of the scene without them."""
    b = J.SceneBuilder(sky_color=(0.05, 0.05, 0.1))
    floor = b.add_material(albedo=(0.6, 0.6, 0.6), roughness=1.0)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 1.0, 1.0),
                          emission_strength=5.0)
    b.add_sphere(center=(0.0, -101.0, 5.0), radius=100.0, material=floor)
    b.add_sphere(center=(0.0, 2.0, 5.0), radius=0.5, material=lamp)
    plain = carry(b.build())
    padded = carry(b.build(sphere_capacity=5))
    sp = padded.spheres
    ghost = dataclasses.replace(padded, spheres=dataclasses.replace(
        sp, material=sp.material.clone().index_fill_(0, torch.tensor([3]), lamp)))
    assert rp.live_emitter_count(ghost) == 1
    args = (PCAM, 8, 32, 2, 3, 5)
    want = rp.render_physical_kernel_reference(plain, *args)
    assert torch.equal(rp.render_physical_kernel_reference(padded, *args), want)
    assert torch.equal(rp.render_physical_kernel_reference(ghost, *args), want)


# -- the wrapper -----------------------------------------------------------------


def test_cpu_tensors_take_the_twin():
    pscene = carry(jdemo.cornell_spheres_scene())
    launches = tracing.counters()
    a = rp.render_physical_kernel(pscene, PCAM, 12, 20, 2, 3, 6, sample_offset=1)
    b = rp.render_physical_kernel_reference(pscene, PCAM, 12, 20, 2, 3, 6, sample_offset=1)
    assert torch.equal(a, b)
    assert (tracing.counters() - launches)["launch.render_phys"] == 0  # no card here


def test_empty_triangle_table():
    """A scene with no triangle slots renders like one with an inactive
    triangle, tri_nee on or off."""
    b = P.SceneBuilder(sky_color=(0.3, 0.4, 0.5))
    m = b.add_material(albedo=(0.9, 0.5, 0.2), roughness=0.5)
    e = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 1.0, 1.0),
                       emission_strength=4.0)
    b.add_sphere(center=(0.0, 0.0, 3.0), radius=1.0, material=m)
    b.add_sphere(center=(2.0, 2.0, 3.0), radius=0.5, material=e)
    padded = b.build("cpu")
    tris = padded.triangles
    empty = dataclasses.replace(padded, triangles=dataclasses.replace(
        tris, **{f.name: getattr(tris, f.name)[:0] for f in dataclasses.fields(tris)}))
    assert empty.num_triangles == 0
    for tri_nee in (False, True):
        assert torch.equal(rp.render_physical_kernel(empty, PCAM, 8, 12, 2, 2, 1, tri_nee=tri_nee),
                           rp.render_physical_kernel(padded, PCAM, 8, 12, 2, 2, 1, tri_nee=tri_nee))


def test_wrapper_rejects_bad_inputs():
    scene = carry(jdemo.cornell_spheres_scene())
    with pytest.raises(TypeError):
        bad = dataclasses.replace(scene, sky_color=scene.sky_color.double())
        rp.render_physical_kernel(bad, PCAM, 8, 8, 1, 1, 0)
    with pytest.raises(ValueError):
        rp.render_physical_kernel(scene, PCAM, 8, 8, 1, 1, 2**32)
    with pytest.raises(ValueError):
        rp.render_physical_kernel(scene, PCAM, 8, 8, 0, 1, 0)
    with pytest.raises(ValueError):
        rp.render_physical_kernel(scene, P.Camera.reference("meta"), 8, 8, 1, 1, 0)
    with pytest.raises(ValueError):
        rp.render_physical_kernel(P.demo.cornell_spheres_scene("meta"),
                                  P.Camera.reference("meta"), 8, 8, 1, 1, 0)


# -- (e) the CLI -----------------------------------------------------------------


@pytest.fixture
def spies(monkeypatch):
    """Record the calls that reach the physical twin and the eager tier."""
    calls = {"twin": [], "eager": []}
    twin, eager = rp.render_physical_kernel_reference, pphys.render_physical

    def spy_twin(scene, camera, height, width, *args, **kw):
        calls["twin"].append((height, width, kw.get("tri_nee"), kw.get("jitter")))
        return twin(scene, camera, height, width, *args, **kw)

    def spy_eager(scene, camera, height, width, *args, **kw):
        calls["eager"].append((height, width, kw.get("tri_nee"), kw.get("jitter")))
        return eager(scene, camera, height, width, *args, **kw)

    monkeypatch.setattr(rp, "render_physical_kernel_reference", spy_twin)
    monkeypatch.setattr(pphys, "render_physical", spy_eager)
    return calls


@pytest.mark.parametrize("engine", ["physical", "physical_pallas"])
def test_cli_physical_engine_reaches_the_kernel_path_at_a_ragged_size(tmp_path, spies, engine):
    """--engine physical on the CPU runs the kernel's twin, at 100x36 too
    (the kernel masks the ragged edge), never the eager tier; the JAX
    package's name for its kernel engine means the same."""
    out, metrics = tmp_path / "r.bmp", tmp_path / "m.jsonl"
    app.main(["render", "--device", "cpu", "--engine", engine, "--scene", "cornell",
              "--width", "36", "--height", "100", "--spp", "1", "--max-bounces", "2",
              "--seed", "3", "--out", str(out), "--metrics", str(metrics)])
    assert spies == {"twin": [(100, 36, False, False)], "eager": []}
    want = rp.render_physical_kernel(P.demo.cornell_spheres_scene("cpu"), PCAM, 100, 36, 1, 2, 3,
                                     jitter=False)
    assert out.read_bytes() == P.bitmap_bytes(P.render_image_u8(want).numpy())
    rec = json.loads(metrics.read_text().splitlines()[0])
    assert rec["kind"] == "render" and rec["engine"] == "physical" and rec["device"] == "cpu"


def test_cli_physical_core_runs_the_eager_tier(tmp_path, spies):
    app.main(["render", "--device", "cpu", "--engine", "physical_core", "--scene", "diffuse",
              "--width", "16", "--height", "8", "--spp", "1", "--max-bounces", "1",
              "--out", str(tmp_path / "c.bmp")])
    assert spies == {"twin": [], "eager": [(8, 16, False, False)]}
    assert (tmp_path / "c.bmp").exists()


@pytest.mark.parametrize("engine, key", [("physical", "twin"), ("physical_core", "eager")])
@pytest.mark.parametrize("how", ["flag", "config"])
def test_cli_honours_tri_nee(tmp_path, spies, engine, key, how):
    cfg = {"width": 16, "height": 8, "spp": 1, "max_bounces": 1, "scene": "diffuse",
           "engine": engine, "jitter": True, "output": str(tmp_path / "t.bmp")}
    argv = []
    if how == "flag":
        argv = ["--tri-nee"]
    else:
        cfg["tri_nee"] = True
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    app.main(["render", "--device", "cpu", "--config", str(tmp_path / "c.json")] + argv)
    assert spies[key] == [(8, 16, True, True)]
    assert (tmp_path / "t.bmp").exists()


def test_cli_config3_loads_and_renders_through_the_kernel_path(tmp_path, spies):
    """configs/config3_glossy_1024.json as it stands (engine "physical"),
    cut to 24x16 and 1 spp from the command line."""
    cfg = REPO / "configs" / "config3_glossy_1024.json"
    assert json.loads(cfg.read_text())["engine"] == "physical"
    out = tmp_path / "g.bmp"
    app.main(["render", "--device", "cpu", "--config", str(cfg), "--width", "24",
              "--height", "16", "--spp", "1", "--out", str(out)])
    assert [c[:2] for c in spies["twin"]] == [(16, 24)] and spies["eager"] == []
    assert len(out.read_bytes()) == 54 + 24 * 3 * 16


def test_cli_device_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        app.main(["render", "--engine", "physical", "--scene", "cornell", "--width", "8",
                  "--height", "8", "--spp", "1", "--out", str(tmp_path / "x.bmp")])
    assert not (tmp_path / "x.bmp").exists()
