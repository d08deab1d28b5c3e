"""PyTorch port: the per-bounce event histograms of both tiers against the
JAX package's, and the ``render --bounce-stats`` CLI.

Tolerance: none. The two packages draw the same PCG streams and take the
same discrete decisions (hit or miss, branch, lobe, total internal
reflection, light-sample visibility), and the port's renders agree with the
JAX package's to float32 rounding, so every bin must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.models.integrator import render_bounce_stats as j_stats
from path_tracer_c_tpu.models.physical import render_bounce_stats_physical as j_stats_phys
from path_tracer_c_tpu.scene import demo as jdemo
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.app import main as app
from path_tracer_c_tpu_torch.models.integrator import render_bounce_stats
from path_tracer_c_tpu_torch.models.physical import render_bounce_stats_physical
from path_tracer_c_tpu_torch.scene import demo as pdemo
from path_tracer_c_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)

JCAM, PCAM = J.Camera.reference(), P.Camera.reference("cpu")


def assert_equal_bins(jax_stats, torch_stats):
    assert set(jax_stats) == set(torch_stats)
    for k, v in torch_stats.items():
        assert v.dtype == torch.int64
        np.testing.assert_array_equal(np.asarray(jax_stats[k]), v.numpy(), err_msg=k)


@pytest.mark.parametrize("name, seed", [("demo_scene", 3), ("glossy_scene", 1)])
def test_render_bounce_stats_matches_jax(name, seed):
    """16x32, 4 spp, 5 bounces: every bin equal to the JAX package's."""
    j = j_stats(getattr(jdemo, name)(), JCAM, 16, 32, 4, 5, jnp.uint32(seed))
    p = render_bounce_stats(getattr(pdemo, name)("cpu"), PCAM, 16, 32, 4, 5, seed)
    assert_equal_bins(j, p)
    assert p["hits"].shape == (6,)


def test_bounce_stats_conservation():
    """Every ray at bounce b hits or misses, and the rays that reach bounce
    b + 1 are bounce b's hits less its deaths by total internal reflection
    (the counterpart of tests/test_integrator_golden.py's test)."""
    h, w, spp, bounces = 16, 32, 4, 5
    st = render_bounce_stats(pdemo.demo_scene("cpu"), PCAM, h, w, spp, bounces, 3)
    hits, misses, tir = (st[k].numpy() for k in ("hits", "misses", "tir_deaths"))
    assert hits.shape == (bounces + 1,)
    assert hits[0] + misses[0] == h * w * spp
    for b in range(1, bounces + 1):
        assert hits[b] + misses[b] == hits[b - 1] - tir[b - 1], b
    assert (tir <= hits).all()


def glass_scene(scene_class):
    """A glass sphere (total internal reflection), a diffuse sphere light
    and a diffuse ground of triangles: every event the histogram counts."""
    b = scene_class(sky_color=(0.2, 0.3, 0.5))
    light = b.add_material(albedo=(0.9, 0.8, 0.7), roughness=1.0,
                           emission_color=(1.0, 0.8, 0.6), emission_strength=3.0)
    glass = b.add_material(albedo=(0.9, 0.95, 1.0), roughness=0.1, transparency=0.9,
                           refractive_index=1.8)
    ground = b.add_material(albedo=(0.6, 0.3, 0.2), roughness=1.0)
    b.add_sphere(center=(0, 2.5, 6), radius=1.0, material=light)
    b.add_sphere(center=(0, 0, 4), radius=1.5, material=glass)
    b.add_triangle(v0=(-50, -1.2, -50), v1=(50, -1.2, -50), v2=(50, -1.2, 50), material=ground)
    b.add_triangle(v0=(-50, -1.2, -50), v1=(-50, -1.2, 50), v2=(50, -1.2, 50), material=ground)
    return b


@pytest.mark.parametrize("nee, jitter", [(True, False), (False, False), (True, True)])
def test_render_bounce_stats_physical_matches_jax(nee, jitter):
    """8x16, 2 spp, 3 bounces on a scene with glass, a light and diffuse
    triangles: every bin, the light samples' included, equal to the JAX
    package's, with next-event estimation on and off and with jitter."""
    jscene = glass_scene(J.SceneBuilder).build()
    pscene = glass_scene(P.SceneBuilder).build("cpu")
    j = j_stats_phys(jscene, JCAM, 8, 16, 2, 3, jnp.uint32(5), nee, jitter)
    p = render_bounce_stats_physical(pscene, PCAM, 8, 16, 2, 3, 5, nee=nee, jitter=jitter)
    assert_equal_bins(j, p)
    assert int(p["hits"].sum()) > 0
    assert int(p["tir_deaths"].sum()) > 0 or jitter  # the jittered rays miss the one death
    if nee:
        assert int(p["nee_candidates"].sum()) >= int(p["nee_visible"].sum()) > 0


def test_render_bounce_stats_metrics(tmp_path):
    """The counterpart of tests/test_app.py's test: one bounce_histogram
    record, with the histogram's spp and engine."""
    mpath = tmp_path / "m.jsonl"
    app.main(["render", "--device", "cpu", "--scene", "demo", "--width", "32", "--height", "16",
              "--spp", "2", "--max-bounces", "3", "--engine", "core",
              "--out", str(tmp_path / "out.bmp"), "--metrics", str(mpath), "--bounce-stats"])
    recs = [r for r in MetricsLogger.read(mpath) if r["kind"] == "bounce_histogram"]
    assert len(recs) == 1
    assert len(recs[0]["hits"]) == 4
    assert sum(recs[0]["hits"]) > 0
    assert recs[0]["spp"] == 2 and recs[0]["engine"] == "core"
    assert (tmp_path / "out.bmp").exists()


@pytest.mark.parametrize("engine", ["physical", "physical_core", "physical_pallas"])
def test_render_bounce_stats_physical_engine(tmp_path, capsys, engine):
    """Every physical engine logs the physical histogram with the light
    samples' counts; the record equals render_bounce_stats_physical's at the
    CLI's seed and jitter, and its spp is capped at 4. physical_pallas is
    the render CLI's alias of the physical kernel engine, and the record
    carries the engine that rendered: "physical" (the JAX CLI logs the
    reference tier's histogram under "physical_pallas")."""
    mpath = tmp_path / "m.jsonl"
    app.main(["render", "--device", "cpu", "--scene", "demo", "--width", "16", "--height", "8",
              "--spp", "6", "--max-bounces", "2", "--engine", engine,
              "--out", str(tmp_path / "out.bmp"), "--metrics", str(mpath), "--bounce-stats"])
    (rec,) = [r for r in MetricsLogger.read(mpath) if r["kind"] == "bounce_histogram"]
    assert rec["engine"] == {"physical_pallas": "physical"}.get(engine, engine)
    assert rec["spp"] == 4
    assert len(rec["nee_candidates"]) == 3
    assert sum(rec["nee_candidates"]) >= sum(rec["nee_visible"])
    assert sum(rec["nee_candidates"]) > 0  # the demo scene has a sun sphere
    want = render_bounce_stats_physical(pdemo.demo_scene("cpu"), PCAM, 8, 16, 4, 2, 0)
    assert {k: v.tolist() for k, v in want.items()} == {k: rec[k] for k in want}
    assert "bounce histogram (4 spp, per bounce)" in capsys.readouterr().out


# -- tri_nee: the histogram of the estimator the image is rendered with ----------


def jax_tri_nee_stats(jscene, h, w, spp, bounces, seed):
    """JAX's trace_paths_physical(..., tri_nee=True, collect_stats=True)
    summed over samples, on the rays render_bounce_stats_physical draws
    (no jitter): JAX's histogram itself takes no tri_nee."""
    from path_tracer_c_tpu.models.physical import trace_paths_physical
    from path_tracer_c_tpu.ops import rng as jrng
    from path_tracer_c_tpu.ops.camera import pixel_indices, primary_rays

    pix = pixel_indices(h, w, 0, h)
    o, d = primary_rays(JCAM, h, w)
    acc = None
    for s in range(spp):
        st = jrng.seed_state(pix, jnp.int32(s), jnp.uint32(seed))
        stats = trace_paths_physical(jscene, o, d, st, bounces, nee=True, collect_stats=True,
                                     tri_nee=True)[-1]
        acc = stats if acc is None else {k: acc[k] + stats[k] for k in acc}
    return acc


def test_render_bounce_stats_physical_tri_nee():
    """On a scene lit by triangles and a sphere, 16x24, 2 spp, 3 bounces:
    without tri_nee every bin equals JAX's render_bounce_stats_physical;
    with it, JAX's trace_paths_physical(tri_nee=True) summed over samples,
    and the light samples' bins differ from the estimator without it."""
    from torch_physical_scenes import carry, tri_light_mixed_scene

    jscene = tri_light_mixed_scene()
    pscene = carry(jscene)
    off = render_bounce_stats_physical(pscene, PCAM, 16, 24, 2, 3, 0)
    assert_equal_bins(j_stats_phys(jscene, JCAM, 16, 24, 2, 3, jnp.uint32(0), True, False), off)
    on = render_bounce_stats_physical(pscene, PCAM, 16, 24, 2, 3, 0, tri_nee=True)
    assert_equal_bins(jax_tri_nee_stats(jscene, 16, 24, 2, 3, 0), on)
    assert not torch.equal(on["nee_candidates"], off["nee_candidates"])
    assert torch.equal(on["hits"][0], off["hits"][0])  # the primary rays are the same


def test_render_bounce_stats_cli_passes_tri_nee(tmp_path):
    """`render --tri-nee --bounce-stats` logs the histogram of the tri_nee
    estimator it renders with."""
    from path_tracer_c_tpu_torch.scene.io import save_scene
    from torch_physical_scenes import carry, tri_light_mixed_scene

    pscene = carry(tri_light_mixed_scene())
    scene_path, mpath = tmp_path / "tri.json", tmp_path / "m.jsonl"
    save_scene(scene_path, pscene)
    app.main(["render", "--device", "cpu", "--scene", str(scene_path), "--width", "24",
              "--height", "16", "--spp", "2", "--max-bounces", "3", "--engine", "physical",
              "--tri-nee", "--out", str(tmp_path / "out.bmp"), "--metrics", str(mpath),
              "--bounce-stats"])
    (rec,) = [r for r in MetricsLogger.read(mpath) if r["kind"] == "bounce_histogram"]
    want = render_bounce_stats_physical(pscene, PCAM, 16, 24, 2, 3, 0, tri_nee=True)
    assert {k: v.tolist() for k, v in want.items()} == {k: rec[k] for k in want}
