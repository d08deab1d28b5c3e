"""PyTorch port: the physical tier's fits (``grad/diff.py``: ``fit_geometry``,
``fit_camera``, ``fit_materials`` with ``rough_grad`` and the physical
engines) held step by step against the JAX package's fits, and the ``fit``
command's physical modes.

Each fit starts in both packages from the same scene, target, variables and
per-step seeds (``seed0 + i + 1``) and takes a few Adam steps; the losses
must agree step by step to rtol 2e-3 and the fitted variables to 2e-3
absolute (a tenth of one step of Adam at these learning rates). Adam's
first steps move every variable by about ``lr`` whatever the gradient's
size, and a later step by the ratio of the gradient to its running scale,
so agreement over several steps holds the gradients' signs and their
relative sizes from step to step; their absolute sizes are held in
test_torch_physical_vjp.py. Convergence is not tested here: the JAX suite's
own descent gates sit near their thresholds.
"""

import dataclasses
import json
import re
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.grad import diff as jdiff
from path_tracer_c_tpu.models.physical import render_physical as j_render_physical
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.app import main as app
from path_tracer_c_tpu_torch.grad import diff as pdiff
from path_tracer_c_tpu_torch.models import physical as pphys
from path_tracer_c_tpu_torch.ops import render_physical as rp
import torch_physical_scenes as S
from torch_physical_scenes import JCAM, PCAM

torch.set_num_threads(1)

H = W = 16
LOSS_RTOL, PARAM_ATOL = 2e-3, 2e-3


def j_target(jscene, spp, bounces, **kw):
    return np.asarray(j_render_physical(jscene, JCAM, H, W, spp, bounces, jnp.uint32(1234),
                                        jitter=False, **kw))


def moved_light(jscene, index=0):
    sph = jscene.spheres
    shift = jnp.zeros_like(sph.center).at[index].add(jnp.asarray([0.3, -0.2, 0.25], jnp.float32))
    return dataclasses.replace(jscene, spheres=dataclasses.replace(sph, center=sph.center + shift))


def moved_triangles(jscene, rows=(2, 3)):
    tri = jscene.triangles
    d = jnp.zeros_like(tri.v0).at[jnp.asarray(rows)].add(jnp.asarray([0.4, -0.35, 0.3], jnp.float32))
    return dataclasses.replace(jscene, triangles=dataclasses.replace(
        tri, v0=tri.v0 + d, v1=tri.v1 + d, v2=tri.v2 + d))


def assert_fits_agree(jl, pl, pairs):
    assert len(jl) == len(pl) and np.all(np.isfinite(pl))
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    for a, b in pairs:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=PARAM_ATOL)


# -- geometry -----------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["physical", "physical_pallas"])
def test_fit_geometry_sphere_light_follows_jax(engine):
    jtrue = S.light_fit_scene()
    target = j_target(jtrue, 32, 2)
    jinit = moved_light(jtrue)
    kw = dict(sphere_indices=(0,), steps=4, lr=0.05, seed0=7, engine=engine)
    jfit, jl = jdiff.fit_geometry(jinit, jnp.asarray(target), JCAM, H, W, 8, 2, **kw)
    pfit, pl = pdiff.fit_geometry(S.carry(jinit), torch.tensor(target), PCAM, H, W, 8, 2, **kw)
    assert_fits_agree(jl, pl, [(pfit.spheres.center, jfit.spheres.center),
                               (pfit.spheres.radius, jfit.spheres.radius)])
    moved = np.abs(pfit.spheres.center.numpy() - np.asarray(jinit.spheres.center))
    assert moved[0].min() > 0.05 and not moved[1:].any()  # 4 steps of 0.05, the light only
    assert len(set(pl)) == 4


@pytest.mark.parametrize("engine", ["physical", "physical_pallas"])
def test_fit_geometry_triangle_light_follows_jax(engine):
    """18 raw vertex variables of the two lamp triangles; ``tri_nee``
    defaults to on because triangles are fitted."""
    jtrue = S.tri_light_fit_scene()
    target = j_target(jtrue, 32, 2, tri_nee=True)
    jinit = moved_triangles(jtrue)
    kw = dict(sphere_indices=(), triangle_indices=(2, 3), steps=4, lr=0.05, seed0=7, engine=engine)
    jfit, jl = jdiff.fit_geometry(jinit, jnp.asarray(target), JCAM, H, W, 8, 2, **kw)
    pfit, pl = pdiff.fit_geometry(S.carry(jinit), torch.tensor(target), PCAM, H, W, 8, 2, **kw)
    assert_fits_agree(jl, pl, [(getattr(pfit.triangles, v), getattr(jfit.triangles, v))
                               for v in ("v0", "v1", "v2")])
    moved = np.abs(pfit.triangles.v0.numpy() - np.asarray(jinit.triangles.v0))
    assert moved[2:].max() > 0.05 and not moved[:2].any()  # the lamp's triangles only
    assert torch.equal(pfit.spheres.center, S.carry(jinit).spheres.center)


def test_geometry_params_cross_over_and_apply():
    jscene = S.tri_light_mixed_scene()
    pscene = S.carry(jscene)
    jp = jdiff.make_geometry_params(jscene, (1,), (2, 3))
    pp = pdiff.make_geometry_params(pscene, (i for i in (1,)), (i for i in (2, 3)))  # generators
    assert set(pp) == set(jp) == {"center", "radius_raw", "tri_v"}
    for k in jp:
        assert pp[k].requires_grad and pp[k].shape == jp[k].shape
        np.testing.assert_allclose(pp[k].detach().numpy(), np.asarray(jp[k]), atol=2e-6)
    crossed = pdiff.geometry_params_from_arrays({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    for k, v in pdiff.geometry_params_to_arrays(crossed).items():
        np.testing.assert_array_equal(v, np.asarray(jp[k]))
    bumped = {k: v + 0.25 for k, v in jp.items()}
    want = jdiff.apply_geometry_params(jscene, bumped, (1,), (2, 3))
    got = pdiff.apply_geometry_params(
        pscene, {k: torch.tensor(np.asarray(v)) for k, v in bumped.items()}, (1,), (2, 3))
    for tb, nm in (("spheres", "center"), ("spheres", "radius"), ("triangles", "v0"),
                   ("triangles", "v1"), ("triangles", "v2")):
        np.testing.assert_allclose(S.leaf(got, tb, nm), S.leaf(want, tb, nm), atol=2e-6)
    assert pdiff.make_geometry_params(pscene, ()) == {}
    # a gradient reaches the variables through the mapping
    pp["center"].grad = None
    live = pdiff.apply_geometry_params(pscene, pp, (1,), (2, 3))
    (live.spheres.center.sum() + live.spheres.radius.sum() + live.triangles.v1.sum()).backward()
    assert all(pp[k].grad is not None and pp[k].grad.any() for k in pp)


def test_fit_geometry_builds_its_indices_once(monkeypatch):
    """A geometry fit maps its variables onto the scene with the same index
    tensors every step, built once on the scene's device: building them
    from host ints each step copies from pageable memory, which waits for
    the device. Tensor indices map as the ints do."""
    pscene = S.carry(S.tri_light_mixed_scene())
    seen, sound = [], pdiff.apply_geometry_params

    def spy(scene, params, sphere_indices, triangle_indices=()):
        seen.append((sphere_indices, triangle_indices))
        return sound(scene, params, sphere_indices, triangle_indices)

    monkeypatch.setattr(pdiff, "apply_geometry_params", spy)
    target = torch.zeros((4, 4, 3))
    pdiff.fit_geometry(pscene, target, PCAM, 4, 4, 1, 1, sphere_indices=(1,),
                       triangle_indices=(2, 3), steps=3, engine="physical")
    assert len(seen) == 4  # three steps and the fitted scene
    sph, tri = seen[0]
    assert all(s is sph and t is tri for s, t in seen[:3])
    assert isinstance(sph, torch.Tensor) and sph.dtype == torch.long
    assert sph.device == tri.device == pscene.device
    assert sph.tolist() == [1] and tri.tolist() == [2, 3]

    params = {k: v.detach() + 0.25 for k, v in
              pdiff.make_geometry_params(pscene, (1,), (2, 3)).items()}
    by_ints = sound(pscene, params, (1,), (2, 3))
    by_tensors = sound(pscene, params, torch.tensor([1]), torch.tensor([2, 3], dtype=torch.int32))
    for tb, nm in (("spheres", "center"), ("spheres", "radius"), ("triangles", "v0"),
                   ("triangles", "v1"), ("triangles", "v2")):
        assert torch.equal(getattr(getattr(by_ints, tb), nm), getattr(getattr(by_tensors, tb), nm))


def test_fit_geometry_warns_for_geometry_that_is_no_emitter():
    pscene = S.carry(S.tri_light_mixed_scene())  # sphere 1 and triangles 2, 3 emit
    target = torch.zeros(8, 8, 3)
    with pytest.warns(UserWarning, match=r"spheres \[0\] and triangles \[0\] are not"):
        fitted, _ = pdiff.fit_geometry(pscene, target, PCAM, 8, 8, 1, 1, sphere_indices=(0, 1),
                                       triangle_indices=(0, 2), steps=1, engine="physical_pallas")
    assert torch.equal(fitted.spheres.center[0], pscene.spheres.center[0])  # it did not move
    assert not torch.equal(fitted.spheres.center[1], pscene.spheres.center[1])
    with pytest.warns(UserWarning, match=r"triangles \[2\] \(tri_nee is off\)"):
        pdiff.fit_geometry(pscene, target, PCAM, 8, 8, 1, 1, sphere_indices=(1,),
                           triangle_indices=(2,), tri_nee=False, steps=1, engine="physical_pallas")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the eager engine moves anything; emitters need no warning
        pdiff.fit_geometry(pscene, target, PCAM, 8, 8, 1, 1, sphere_indices=(0,), steps=1)
        pdiff.fit_geometry(pscene, target, PCAM, 8, 8, 1, 1, sphere_indices=(1,),
                           triangle_indices=(2, 3), steps=1, engine="physical_pallas")
    with pytest.raises(ValueError, match="physical engine"):
        pdiff.fit_geometry(pscene, target, PCAM, 8, 8, 1, 1, engine="cuda")


# -- materials and roughness ----------------------------------------------------------


@pytest.mark.parametrize("engine, rough_grad", [
    ("physical_pallas", True), ("physical", True), ("physical_pallas", False),
])
def test_fit_materials_physical_engines_follow_jax(engine, rough_grad):
    jtrue = S.lobe_scene()
    target = j_target(jtrue, 32, 2)
    mats = jtrue.materials
    jinit = dataclasses.replace(jtrue, materials=dataclasses.replace(
        mats, roughness=mats.roughness.at[0].set(0.15), albedo=jnp.full_like(mats.albedo, 0.5)))
    kw = dict(steps=4, lr=0.05, seed0=3, engine=engine, rough_grad=rough_grad)
    jfit, jl = jdiff.fit_materials(jinit, jnp.asarray(target), JCAM, H, W, 8, 2, **kw)
    pfit, pl = pdiff.fit_materials(S.carry(jinit), torch.tensor(target), PCAM, H, W, 8, 2, **kw)
    assert_fits_agree(jl, pl, [(getattr(pfit.materials, nm), getattr(jfit.materials, nm))
                               for nm in ("albedo", "roughness", "emission_strength")])
    moved = abs(float(pfit.materials.roughness[0]) - 0.15) > 1e-3
    assert moved == rough_grad


def test_roughness_params_and_refusals():
    pscene = S.carry(S.lobe_scene())
    jp = jdiff.make_material_params(S.lobe_scene(), include_roughness=True)
    pp = pdiff.make_material_params(pscene, include_roughness=True)
    assert set(pp) == set(jp) and "roughness_logit" in pp
    np.testing.assert_allclose(pp["roughness_logit"].detach().numpy(),
                               np.asarray(jp["roughness_logit"]), atol=2e-5)
    assert "roughness_logit" not in pdiff.make_material_params(pscene)
    back = pdiff.apply_material_params(pscene, pp).materials.roughness
    np.testing.assert_allclose(back.detach().numpy(), pscene.materials.roughness.numpy(), atol=2e-6)
    for engine in ("cuda", "core", "auto"):
        with pytest.raises(ValueError, match="requires a physical engine"):
            pdiff.fit_materials(pscene, torch.zeros(8, 8, 3), PCAM, 8, 8, 1, 1, steps=1,
                                engine=engine, rough_grad=True)


# -- the camera -------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["physical", "physical_fd"])
def test_fit_camera_follows_jax(engine):
    jscene = S.nee_light_scene(0.8)
    pscene = S.carry(jscene)
    jcam0 = J.Camera.look_at((0.0, 0.5, -1.0), (0.0, 0.0, 5.0), fov_deg=70.0)
    target = np.asarray(j_render_physical(jscene, jcam0, H, W, 32, 2, jnp.uint32(1234), jitter=False))
    jcam = J.Camera.look_at((0.25, 0.35, -0.8), (0.1, 0.1, 5.0), fov_deg=70.0)
    pcam = P.Camera.from_arrays(S.arrays(jcam), "cpu")
    kw = dict(steps=4, lr=0.02, seed0=11, engine=engine)
    if engine == "physical_fd":
        # A difference quotient of a render sees every path that flips inside
        # its step, and the two packages do not flip alike: a wide step (5e-2
        # against the default 1e-3) keeps the smooth part on top.
        kw.update(steps=3, fd_eps=5e-2)
    jfit, jl = jdiff.fit_camera(jscene, jnp.asarray(target), jcam, H, W, 8, 2, **kw)
    pfit, pl = pdiff.fit_camera(pscene, torch.tensor(target), pcam, H, W, 8, 2, **kw)
    assert_fits_agree(jl, pl, [(getattr(pfit, nm), getattr(jfit, nm))
                               for nm in ("origin", "right", "up", "forward")])
    assert float(pfit.fov) == pytest.approx(float(jfit.fov), rel=1e-6)  # from camera_init, not 90
    assert float(pfit.fov) == pytest.approx(np.deg2rad(70.0), rel=1e-6)


def test_fit_camera_keeps_the_best_pose_and_refuses_the_fused_engine():
    jscene = S.nee_light_scene(0.8)
    pscene = S.carry(jscene)
    target = pphys.render_physical(pscene, PCAM, 8, 8, 4, 1, 5, jitter=False)
    # at the target's own pose the first loss is the least: a big step then
    # overshoots, and the pose returned is the first, not the last
    cam, losses = pdiff.fit_camera(pscene, target, PCAM, 8, 8, 4, 1, steps=3, lr=0.5, seed0=4)
    assert losses[0] == min(losses)
    np.testing.assert_allclose(cam.origin.numpy(), PCAM.origin.numpy(), atol=1e-6)
    np.testing.assert_allclose(cam.forward.numpy(), PCAM.forward.numpy(), atol=1e-6)
    for diff_mod, cam0, tgt, scene in ((pdiff, PCAM, target, pscene),
                                       (jdiff, JCAM, jnp.asarray(target.numpy()), jscene)):
        with pytest.raises(ValueError, match="silently not move"):
            diff_mod.fit_camera(scene, tgt, cam0, 8, 8, 1, 1, steps=1, engine="physical_pallas")
        with pytest.raises(ValueError, match="unknown fit_camera engine"):
            diff_mod.fit_camera(scene, tgt, cam0, 8, 8, 1, 1, steps=1, engine="cuda")


def test_fit_camera_fd_renders_through_the_forward_kernel(monkeypatch):
    """13 renders a step, through ``render_physical_kernel`` (the forward
    kernel on a card, its twin here), none through the eager tier."""
    calls = []
    kernel = rp.render_physical_kernel
    monkeypatch.setattr(pdiff, "render_physical_kernel",
                        lambda *a, **kw: calls.append(kw) or kernel(*a, **kw))
    monkeypatch.setattr(pdiff, "render_physical", None)
    pscene = S.carry(S.nee_light_scene(0.8))
    pdiff.fit_camera(pscene, torch.zeros(8, 8, 3), PCAM, 8, 8, 1, 1, steps=2, engine="physical_fd")
    assert len(calls) == 26 and all(kw == {"jitter": False} for kw in calls)


# -- the command line ----------------------------------------------------------------------


def fit_config(tmp_path, render=None, **top):
    cfg = {"render": {"width": 16, "height": 16, "spp": 2, "max_bounces": 2, "scene": "cornell",
                      **(render or {})}, "steps": 2, "lr": 0.05, **top}
    path = tmp_path / "fit.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture
def spies(monkeypatch):
    """Count the calls that reach the fused path and the eager tier from
    ``grad/diff.py``, and the forward kernel from the command."""
    calls = {"fused": [], "eager": [], "forward": []}
    fused, eager, forward = pdiff.render_physical_kernel_vjp, pdiff.render_physical, rp.render_physical_kernel
    monkeypatch.setattr(pdiff, "render_physical_kernel_vjp",
                        lambda *a, **kw: calls["fused"].append(kw) or fused(*a, **kw))
    monkeypatch.setattr(pdiff, "render_physical",
                        lambda *a, **kw: calls["eager"].append(kw) or eager(*a, **kw))
    monkeypatch.setattr(rp, "render_physical_kernel",
                        lambda *a, **kw: calls["forward"].append(kw) or forward(*a, **kw))
    return calls


LINES = {
    "geometry": r"geometry fit \({e}\): 2 steps in [\d.]+s, loss [\d.e+-]+ -> [\d.e+-]+, "
                r"max light-center err [\d.]+$",
    "roughness": r"roughness fit \({e}, score-function\): 2 steps in [\d.]+s, loss [\d.e+-]+ -> "
                 r"[\d.e+-]+, max roughness err [\d.]+$",
    "materials": r"fit: 2 steps in [\d.]+s, loss [\d.e+-]+ -> [\d.e+-]+, max albedo err [\d.]+$",
}


@pytest.mark.parametrize("mode", ["geometry", "roughness", "materials"])
@pytest.mark.parametrize("engine", ["physical_pallas", "physical"])
def test_fit_cli_physical_modes(tmp_path, capsys, spies, mode, engine):
    app.main(["fit", "--device", "cpu", "--config", fit_config(tmp_path), "--mode", mode,
              "--engine", engine])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.match(LINES[mode].format(e=engine), line), line
    key, other = ("fused", "eager") if engine == "physical_pallas" else ("eager", "fused")
    assert len(spies[key]) == 2 and not spies[other]
    assert spies["forward"] == [dict(jitter=False, tri_nee=False)]  # the target
    if engine == "physical_pallas":
        want = {"geometry": dict(n_em_cap=1, tri_nee=False, tri_em_cap=0, nee=True, jitter=False),
                "roughness": dict(geom=False, rough_grad=True, jitter=False),
                "materials": dict(geom=False, rough_grad=False, jitter=False)}[mode]
        assert spies["fused"][0] == want


def test_fit_cli_modes_default_to_the_eager_physical_engine(tmp_path, capsys, spies):
    app.main(["fit", "--device", "cpu", "--config", fit_config(tmp_path, mode="geometry")])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("geometry fit (physical): 2 steps in ")
    assert len(spies["eager"]) == 2 and not spies["fused"]


@pytest.mark.parametrize("how", ["flag", "config"])
@pytest.mark.parametrize("named", ["cuda", "core", "pallas", "auto"])
def test_fit_cli_refuses_a_reference_engine_named_with_a_physical_mode(tmp_path, how, named):
    """The JAX command replaces such an engine by "physical" without a word
    (its app/main.py, ``engine = cfg.engine if cfg.engine in (...) else
    "physical"``); this one says what is wrong."""
    argv = ["--engine", named] if how == "flag" else []
    render = {"engine": named} if how == "config" else None
    with pytest.raises(SystemExit, match=f"needs a physical engine.*engine '{named}'"):
        app.main(["fit", "--device", "cpu", "--config", fit_config(tmp_path, render),
                  "--mode", "roughness"] + argv)


def test_fit_cli_tri_nee_reaches_the_target_and_the_geometry_fit(tmp_path, capsys, spies):
    app.main(["fit", "--device", "cpu", "--config", fit_config(tmp_path, {"tri_nee": True}),
              "--mode", "geometry", "--engine", "physical_pallas"])
    assert spies["forward"] == [dict(jitter=False, tri_nee=True)]
    assert spies["fused"][0]["tri_nee"] is True
    app.main(["fit", "--device", "cpu", "--config", fit_config(tmp_path), "--tri-nee",
              "--engine", "physical_pallas"])
    assert spies["forward"][-1] == dict(jitter=False, tri_nee=True)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("fit: 2 steps in ")


def test_fit_cli_geometry_needs_an_emissive_sphere_and_a_known_mode(tmp_path):
    with pytest.raises(SystemExit, match="needs a scene with an emissive sphere"):
        app.main(["fit", "--device", "cpu", "--config", fit_config(tmp_path, {"scene": "diffuse"}),
                  "--mode", "geometry"])
    with pytest.raises(SystemExit, match="unknown mode 'camera'"):
        app.main(["fit", "--device", "cpu", "--config", fit_config(tmp_path, mode="camera")])
    with pytest.raises(SystemExit, match="unknown engine 'physical_fd'"):
        app.main(["fit", "--device", "cpu", "--config", fit_config(tmp_path),
                  "--engine", "physical_fd"])
