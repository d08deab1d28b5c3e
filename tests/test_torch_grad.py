"""PyTorch port: ``grad/diff.py`` against the JAX package's (the material
parameterization, the loss, Adam steps of ``fit_materials`` from the same
variables), a miniature recovery, and the ``fit`` CLI with its refusals."""

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.grad import diff as jdiff
from path_tracer_c_tpu.scene import demo as jdemo
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.app import main as app
from path_tracer_c_tpu_torch.grad import diff as pdiff
from path_tracer_c_tpu_torch.ops import render_grad as rg
from path_tracer_c_tpu_torch.scene import demo as pdemo
from path_tracer_c_tpu_torch.utils.config import FitConfig, load

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
JCAM = J.Camera.reference()
PCAM = P.Camera.reference("cpu")


def corrupt(mod, scene, full_like):
    mats = scene.materials
    return dataclasses.replace(scene, materials=dataclasses.replace(
        mats, albedo=full_like(mats.albedo, 0.5)))


# -- (i) parameterization, loss and Adam steps against JAX ------------------


@pytest.mark.parametrize("name", ["glossy_scene", "cornell_spheres_scene"])
def test_material_params_match_jax_and_round_trip(name):
    jscene, pscene = getattr(jdemo, name)(), getattr(pdemo, name)("cpu")
    jp, pp = jdiff.make_material_params(jscene), pdiff.make_material_params(pscene)
    assert set(jp) == set(pp)
    for k in jp:
        assert pp[k].requires_grad and pp[k].is_leaf
        np.testing.assert_allclose(pp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
    # apply(make(scene)) is the scene, up to the 1e-6 clamps of the logits
    back, jback = pdiff.apply_material_params(pscene, pp), jdiff.apply_material_params(jscene, jp)
    for leaf in ("albedo", "emission_color", "emission_strength"):
        got = getattr(back.materials, leaf).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jback.materials, leaf)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, getattr(pscene.materials, leaf).numpy(), atol=2e-6)
    # the variables cross over as numpy arrays, both ways
    crossed = pdiff.material_params_from_arrays({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    for k, v in pdiff.material_params_to_arrays(crossed).items():
        np.testing.assert_array_equal(v, np.asarray(jp[k]))
        assert crossed[k].requires_grad


def test_mse_and_render_loss_engines_agree():
    pscene = pdemo.demo_scene("cpu")
    a, b = torch.rand(4, 5, 3, generator=torch.Generator().manual_seed(1)), torch.zeros(4, 5, 3)
    assert float(pdiff.mse_loss(a, b)) == pytest.approx(
        float(jdiff.mse_loss(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))), rel=1e-6)
    target = torch.zeros(8, 16, 3)
    losses = [float(pdiff.render_loss(pscene, target, PCAM, 8, 16, 2, 3, 5, engine=e))
              for e in ("cuda", "core", "auto", "pallas")]
    assert losses[0] == losses[2] == losses[3]
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    # the physical tier is another estimator of the same scene: its two
    # engines agree with each other, and its score-function roughness
    # gradient exists there only
    phys = [float(pdiff.render_loss(pscene, target, PCAM, 8, 16, 2, 3, 5, engine=e))
            for e in ("physical", "physical_pallas")]
    assert np.isfinite(phys).all() and phys[0] == pytest.approx(phys[1], rel=1e-5)
    assert phys[0] != losses[0]
    with pytest.raises(ValueError, match="rough_grad requires a physical engine"):
        pdiff.render_loss(pscene, target, PCAM, 8, 16, 2, 3, 5, rough_grad=True)
    with pytest.raises(ValueError):
        pdiff.render_loss(pscene, target, PCAM, 8, 16, 2, 3, 5, engine="nope")


def test_loss_and_grad_cuda_engine_matches_core():
    pscene = pdemo.demo_scene("cpu")
    target = P.render_radiance(pscene, PCAM, 8, 16, 2, 3, 99)
    la, da = pdiff.loss_and_grad(pscene, target, PCAM, 8, 16, 2, 3, 5, engine="cuda")
    lb, db = pdiff.loss_and_grad(pscene, target, PCAM, 8, 16, 2, 3, 5, engine="core")
    assert float(la) == pytest.approx(float(lb), rel=1e-5)
    for a, b in zip(rg._grad_leaves(da), rg._grad_leaves(db)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3, atol=1e-7)
    assert not pscene.materials.albedo.requires_grad  # the caller's scene is untouched


@pytest.mark.parametrize("engine", ["core", "cuda"])
def test_five_adam_steps_match_jax(engine):
    """fit_materials from the same variables, target and per-step seeds as
    the JAX fit: the five losses agree to rtol 1e-3 (Adam's first steps
    move every variable by about lr, whatever the gradient's size, so a
    sign is all a step needs; the loss then depends on the render only)."""
    h, w, spp, bounces, steps = 8, 16, 4, 2, 5
    jtrue = jdemo.diffuse_sphere_scene()
    jinit = corrupt(J, jtrue, jnp.full_like)
    jtarget = J.render_radiance(jtrue, JCAM, h, w, spp, bounces, jnp.uint32(999))
    _, jlosses = jdiff.fit_materials(jinit, jtarget, JCAM, h, w, spp, bounces, steps=steps,
                                     lr=0.1, seed0=3, engine="core")
    pinit = corrupt(P, pdemo.diffuse_sphere_scene("cpu"), torch.full_like)
    params = pdiff.material_params_from_arrays(
        {k: np.asarray(v) for k, v in jdiff.make_material_params(jinit).items()}, "cpu")
    seen = []
    fitted, plosses = pdiff.fit_materials(
        pinit, torch.from_numpy(np.array(jtarget)), PCAM, h, w, spp, bounces, steps=steps,
        lr=0.1, seed0=3, engine=engine, params=params, callback=lambda i, l: seen.append(i))
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-3)
    assert seen == list(range(steps))
    assert not fitted.materials.albedo.requires_grad


# -- (j) a miniature recovery -------------------------------------------------


def test_inverse_rendering_recovers_albedo():
    """A corrupted albedo comes back from a 16x16 target (the miniature of
    tests/test_grad.py, through the fused path's twin)."""
    true_scene = pdemo.diffuse_sphere_scene("cpu")
    target = P.render_radiance(true_scene, PCAM, 16, 16, 8, 2, 999)
    wrong = corrupt(P, true_scene, torch.full_like)
    fitted, losses = pdiff.fit_materials(wrong, target, PCAM, 16, 16, 8, 2, steps=40, lr=0.1,
                                         engine="cuda")
    assert len(losses) == 40 and all(isinstance(x, float) for x in losses)
    # The loss bottoms out at the fresh-seed Monte-Carlo noise floor, so
    # the sharp check is the recovered parameter.
    assert losses[-1] < losses[0], f"loss {losses[0]} -> {losses[-1]}"
    got, want = fitted.materials.albedo[0].numpy(), true_scene.materials.albedo[0].numpy()
    assert np.abs(got - want).max() < 0.1, f"{got} vs {want}"


# -- (k) the fit CLI ----------------------------------------------------------


def fit_config(tmp_path, render=None, **top):
    """A config file in the layout of configs/config4_inverse_spheres32.json."""
    cfg = json.loads((REPO / "configs" / "config4_inverse_spheres32.json").read_text())
    cfg["render"].update({"width": 16, "height": 16, "spp": 2, "max_bounces": 2,
                          "scene": "diffuse", **(render or {})})
    cfg.update({"steps": 4, **top})
    path = tmp_path / "fit.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_config4_loads_unchanged():
    fcfg = load(REPO / "configs" / "config4_inverse_spheres32.json", FitConfig)
    r = fcfg.render
    assert (fcfg.steps, fcfg.lr, fcfg.target, fcfg.mode) == (200, 0.05, "", "materials")
    assert (r.width, r.height, r.spp, r.max_bounces, r.scene, r.engine) == (
        256, 256, 8, 3, "spheres32", "pallas")
    assert (r.mesh.tile, r.mesh.spp) == (1, 1)


@pytest.mark.parametrize("engine", [None, "core"])
def test_fit_cli_on_cpu(tmp_path, capsys, monkeypatch, engine):
    """The config's "pallas" engine runs the fused path (its twin on the
    CPU), once per step; an explicit --engine is honoured."""
    twin = rg.render_fused_reference
    counted = []

    def spy(*a, **k):
        counted.append(1)
        return twin(*a, **k)

    monkeypatch.setattr(rg, "render_fused_reference", spy)
    metrics = tmp_path / "m.jsonl"
    argv = ["fit", "--device", "cpu", "--config", fit_config(tmp_path),
            "--metrics", str(metrics)]
    app.main(argv + (["--engine", engine] if engine else []))
    assert len(counted) == (0 if engine == "core" else 4)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("fit: 4 steps in ") and "max albedo err" in line
    first, last = (float(x) for x in line.split("loss ")[1].split(",")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)
    recs = [json.loads(l) for l in metrics.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    assert all(r["engine"] == (engine or "cuda") for r in recs)


def test_fit_cli_reads_a_target_file_and_steps_override(tmp_path, capsys):
    target = P.render_radiance(pdemo.diffuse_sphere_scene("cpu"), PCAM, 16, 16, 2, 2, 12345)
    np.save(tmp_path / "t.npy", target.numpy())
    app.main(["fit", "--device", "cpu", "--steps", "2",
              "--config", fit_config(tmp_path, target=str(tmp_path / "t.npy"))])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("fit: 2 steps in ")


@pytest.mark.parametrize("argv, render, top, item", [
    (["--mode", "geometry", "--engine", "physical_pallas"], {"scene": "cornell"}, {},
     "geometry fit (physical_pallas): 4 steps in "),
    (["--mode", "roughness", "--engine", "physical"], None, {},
     "roughness fit (physical, score-function): 4 steps in "),
    ([], {"scene": "cornell", "engine": "physical"}, {"mode": "geometry"},
     "geometry fit (physical): 4 steps in "),
    (["--engine", "physical"], None, {}, "fit: 4 steps in "),
    ([], {"engine": "physical_pallas"}, {}, "fit: 4 steps in "),
    ([], {"mesh": {"tile": 2, "spp": 1}}, {}, "A11"),
    ([], None, {"checkpoint_path": "fit.ckpt"}, "A12"),
    ([], None, {"checkpoint_every": 5}, "A12"),
])
def test_fit_cli_refuses_what_is_not_ported(tmp_path, capsys, argv, render, top, item):
    """What is still to be ported is refused by ROADMAP item; the physical
    tier's modes and engines, refused until its gradient was ported, run
    and print their result line."""
    argv = ["fit", "--device", "cpu", "--config", fit_config(tmp_path, render, **top)] + argv
    if item in ("A11", "A12"):
        with pytest.raises(SystemExit, match=f"ROADMAP.md {item}"):
            app.main(argv)
        return
    app.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(item), line
    m = re.search(r"loss ([\d.e+-]+) -> ([\d.e+-]+), max [a-z -]+ err ([\d.]+)$", line)
    assert m and all(np.isfinite(float(x)) for x in m.groups()), line


def test_fit_cli_device_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        app.main(["fit", "--config", fit_config(tmp_path)])
