"""PyTorch port: resumable renders and fits against the JAX package.

The accumulator's arithmetic and file are the JAX package's, so the
accumulators agree bit for bit on the same radiance and a checkpoint
written by either package loads in the other. A render interrupted and
resumed writes the bytes of the uninterrupted render with the same chunks;
a fit interrupted and resumed ends with the parameters and losses of the
uninterrupted fit, bit for bit. Across the two packages the renders differ
by float32 rounding only, held to ``tests/test_torch_integrator.py``'s
tolerance.
"""

import dataclasses
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from path_tracer_c_tpu.app import main as japp
from path_tracer_c_tpu.scene import demo as jdemo
from path_tracer_c_tpu.scene.io import save_scene as j_save_scene
from path_tracer_c_tpu.utils import checkpoint as jck
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.app import main as app
from path_tracer_c_tpu_torch.grad import diff
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.utils import bitmap
from path_tracer_c_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)

CAM = P.Camera.reference("cpu")


def assert_close(a, b):
    """``tests/test_torch_integrator.py``'s tolerance between the packages."""
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.quantile(err, 0.999) < 1e-4, np.quantile(err, 0.999)
    assert err.mean() < 1e-5, err.mean()


@pytest.mark.parametrize("chunks", [(3, 5), (1, 1, 2), (7,)])
def test_accumulate_bitwise_against_jax(chunks):
    """The accumulator and its mean image, chunk after chunk, from a tensor
    here and the same values as an array there."""
    rng = np.random.default_rng(sum(chunks))
    jc = pc = None
    for n in chunks:
        rad = rng.random((8, 16, 3), dtype=np.float32) * 3
        jc = jck.accumulate(jc, rad, n, 9)
        pc = ck.accumulate(pc, torch.from_numpy(rad), n, 9)
        np.testing.assert_array_equal(jc.accum, pc.accum)
        np.testing.assert_array_equal(jc.image, pc.image)
        assert pc.accum.dtype == pc.image.dtype == np.float32
    assert pc.spp_done == sum(chunks)
    with pytest.raises(ValueError, match="seed mismatch"):
        ck.accumulate(pc, torch.zeros(8, 16, 3), 1, 10)


def _render_argv(out, engine="core", spp=4, every=2, path=None, extra=()):
    argv = ["render", "--device", "cpu", "--scene", "demo", "--engine", engine,
            "--width", "32", "--height", "16", "--spp", str(spp), "--max-bounces", "3",
            "--seed", "5", "--out", str(out), "--checkpoint-every", str(every)]
    return argv + (["--checkpoint-path", str(path)] if path else []) + list(extra)


def _jax_render(tmp_path, spp, path, out):
    cfg = {"width": 32, "height": 16, "spp": spp, "max_bounces": 3, "seed": 5, "scene": "demo",
           "engine": "core", "output": str(out), "checkpoint_every": 2,
           "checkpoint_path": str(path)}
    cfg_path = tmp_path / "jax.json"
    cfg_path.write_text(json.dumps(cfg))
    japp.main(["render", "--config", str(cfg_path)])


def test_render_checkpoints_cross_packages(tmp_path):
    """A JAX-written checkpoint (2 of 4 spp) resumes in the port, and the
    port's finished checkpoint loads in JAX's ``load_render``."""
    path = tmp_path / "r.npz"
    _jax_render(tmp_path, 2, path, tmp_path / "j.bmp")
    assert jck.load_render(path).spp_done == 2
    app.main(_render_argv(tmp_path / "p.bmp", path=path))
    resumed = jck.load_render(path)
    assert (resumed.spp_done, resumed.seed) == (4, 5)
    own = tmp_path / "own.npz"
    app.main(_render_argv(tmp_path / "own.bmp", path=own))
    assert_close(resumed.image, ck.load_render(own).image)
    mine = ck.load_render(own)
    theirs = jck.load_render(own)
    np.testing.assert_array_equal(mine.accum, theirs.accum)
    assert (mine.spp_done, mine.seed, mine.meta) == (theirs.spp_done, theirs.seed, theirs.meta)


def test_render_accumulator_close_to_jax_cli(tmp_path):
    """The port's `render` and the JAX package's, each in chunks of 2 of 4
    spp through the eager tier: the accumulators agree to the tolerance."""
    _jax_render(tmp_path, 4, tmp_path / "j.npz", tmp_path / "j.bmp")
    app.main(_render_argv(tmp_path / "p.bmp", path=tmp_path / "p.npz"))
    j, p = jck.load_render(tmp_path / "j.npz"), ck.load_render(tmp_path / "p.npz")
    assert j.spp_done == p.spp_done == 4
    assert_close(j.accum, p.accum)


class _Interrupt(Exception):
    pass


@pytest.mark.parametrize("engine", ["core", "cuda"])
def test_interrupted_render_resumes_to_the_same_bytes(tmp_path, monkeypatch, engine):
    """Chunks of 1 spp, interrupted after the second save, then resumed:
    the BMP equals the uninterrupted chunked render's, byte for byte, and
    a resume from the complete checkpoint renders nothing and writes the
    same bytes."""
    path, out, ref = tmp_path / "r.npz", tmp_path / "r.bmp", tmp_path / "ref.bmp"
    app.main(_render_argv(ref, engine, every=1))
    saves = []
    real_save = ck.save_render

    def save_then_stop(p, c):
        real_save(p, c)
        saves.append(c.spp_done)
        if len(saves) == 2:
            raise _Interrupt

    monkeypatch.setattr(ck, "save_render", save_then_stop)
    with pytest.raises(_Interrupt):
        app.main(_render_argv(out, engine, every=1, path=path))
    assert not out.exists() and ck.load_render(path).spp_done == 2
    monkeypatch.setattr(ck, "save_render", real_save)
    app.main(_render_argv(out, engine, every=1, path=path))
    assert out.read_bytes() == ref.read_bytes()
    out.unlink()
    monkeypatch.setattr(app, "_renderer",
                        lambda cfg: lambda *a, **k: pytest.fail("rendered again"))
    app.main(_render_argv(out, engine, every=1, path=path))
    assert out.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("engine", ["cuda", "core"])
def test_spp3_writes_the_accumulators_image(tmp_path, monkeypatch, engine):
    """At 3 spp the CLI encodes ``(rad * 3) / 3`` in float32, as the JAX
    CLI does, not ``rad``: the float image it encodes is the accumulator's
    mean (for the kernel's twin some values differ from ``rad`` here), and
    the bytes are that image's."""
    encoded = []
    real_u8 = app._u8
    monkeypatch.setattr(app, "_u8", lambda image: (encoded.append(image), real_u8(image))[1])
    out = tmp_path / "o.bmp"
    app.main(["render", "--device", "cpu", "--scene", "demo", "--engine", engine,
              "--width", "32", "--height", "16", "--spp", "3", "--max-bounces", "3",
              "--seed", "5", "--out", str(out)])
    render = rk.render_kernel if engine == "cuda" else P.render_radiance
    rad = render(P.demo.demo_scene("cpu"), CAM, 16, 32, 3, 3, 5)
    image = ck.accumulate(None, rad, 3, 5).image
    np.testing.assert_array_equal(image, jck.accumulate(None, rad.numpy(), 3, 5).image)
    assert len(encoded) == 1
    np.testing.assert_array_equal(encoded[0], image)
    assert out.read_bytes() == bitmap.bitmap_bytes(P.render_image_u8(torch.from_numpy(image)).numpy())
    if engine == "cuda":
        assert (image != rad.numpy()).any()


def test_progressive_rewrites_and_ends_equal(tmp_path, monkeypatch):
    """--progressive at 4 spp: chunks of 1, the output written 4 times (3
    previews and the final image), whose bytes equal the plain render's."""
    writes, real = [], bitmap.write_bitmap
    monkeypatch.setattr(bitmap, "write_bitmap",
                        lambda p, u8, **k: (writes.append(str(p)), real(p, u8, **k))[1])
    out, ref = tmp_path / "prog.bmp", tmp_path / "ref.bmp"
    base = ["render", "--device", "cpu", "--scene", "diffuse", "--engine", "cuda", "--width",
            "16", "--height", "8", "--spp", "4", "--max-bounces", "2"]
    app.main(base + ["--out", str(out), "--progressive"])
    assert writes.count(str(out)) == 4
    app.main(base + ["--out", str(ref)])
    assert out.read_bytes() == ref.read_bytes()


def test_debug_nans_raises_on_a_nan_scene(tmp_path):
    """A scene whose emission is NaN: --debug-nans raises with the count,
    seed and engine; without it the image is written. The scene is built
    with JAX's ``jax_debug_nans`` held off: the JAX CLI's ``--debug-nans``
    turns it on for the rest of the process it runs in."""
    import jax

    spath = tmp_path / "nan_scene.json"
    with jax.debug_nans(False):
        scene = jdemo.diffuse_sphere_scene()
        bad = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, emission_strength=jnp.full_like(scene.materials.emission_strength,
                                                             jnp.nan)))
        j_save_scene(spath, bad)
    argv = ["render", "--device", "cpu", "--scene", str(spath), "--width", "16", "--height", "8",
            "--spp", "1", "--max-bounces", "1", "--out", str(tmp_path / "nan.bmp")]
    with pytest.raises(FloatingPointError, match=r": \d+ values \(seed 0, engine cuda\)") as e:
        app.main(argv + ["--debug-nans"])
    assert "spp_done=0" in str(e.value)
    assert not (tmp_path / "nan.bmp").exists()
    app.main(argv)
    assert (tmp_path / "nan.bmp").exists()


# -- fits ----------------------------------------------------------------------


def _materials_fit(engine):
    scene = P.demo.diffuse_sphere_scene("cpu")
    target = P.render_radiance(scene, CAM, 8, 16, 2, 2, 12345)
    init = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, albedo=torch.full_like(scene.materials.albedo, 0.5)))

    def fit(steps, path, every):
        fitted, losses = diff.fit_materials(init, target, CAM, 8, 16, 2, 2, steps=steps,
                                            lr=0.05, seed0=3, engine=engine,
                                            checkpoint_path=path, checkpoint_every=every)
        return (fitted.materials.albedo, fitted.materials.emission_strength,
                fitted.materials.emission_color), losses

    return fit


def _geometry_fit():
    scene = P.demo.cornell_spheres_scene("cpu")
    target = P.render_physical(scene, CAM, 8, 16, 2, 2, 1, jitter=False)
    li = int(np.argmax(rp.live_emitter_mask(scene)))
    sph = scene.spheres
    center = sph.center.clone()
    center[li] += torch.tensor([0.2, -0.1, 0.1])
    init = dataclasses.replace(scene, spheres=dataclasses.replace(sph, center=center))

    def fit(steps, path, every):
        fitted, losses = diff.fit_geometry(init, target, CAM, 8, 16, 2, 2, sphere_indices=(li,),
                                           steps=steps, engine="physical_pallas",
                                           checkpoint_path=path, checkpoint_every=every)
        return (fitted.spheres.center, fitted.spheres.radius), losses

    return fit


def _camera_fit():
    scene = P.demo.cornell_spheres_scene("cpu")
    target = P.render_physical(scene, CAM, 8, 16, 2, 2, 1, jitter=False)
    cam0 = P.Camera.look_at((0.1, 0.05, 0.0), (0.0, 0.0, 1.0), "cpu")

    def fit(steps, path, every):
        cam, losses = diff.fit_camera(scene, target, cam0, 8, 16, 2, 2, steps=steps,
                                      checkpoint_path=path, checkpoint_every=every)
        return (cam.origin, cam.forward, cam.right, cam.up), losses

    return fit


@pytest.mark.parametrize("make", [
    lambda: _materials_fit("core"), lambda: _materials_fit("cuda"), _geometry_fit, _camera_fit,
], ids=["materials-core", "materials-cuda", "geometry-physical_pallas", "camera-physical"])
def test_fit_resumed_equals_uninterrupted(tmp_path, make):
    """2 steps with a checkpoint, then a resume to 4: the parameters and
    the 4 losses are those of 4 uninterrupted steps, bit for bit; a resume
    from the complete checkpoint runs no step and returns the same (the
    camera fit's best pose, not its initial one)."""
    fit = make()
    ref, ref_losses = fit(4, tmp_path / "ref.npz", 2)
    path = tmp_path / "fit.npz"
    fit(2, path, 2)
    with np.load(path) as z:
        assert int(z["step"]) == 2 and len(z["losses"]) == 2
    got, losses = fit(4, path, 2)
    assert losses == ref_losses and len(losses) == 4
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    _assert_same_checkpoint(tmp_path / "ref.npz", path)
    again, again_losses = fit(4, path, 2)
    assert again_losses == ref_losses
    assert all(torch.equal(a, b) for a, b in zip(again, ref))


def _assert_same_checkpoint(a, b):
    """Every entry of two fit checkpoints equal, shapes and dtypes too."""
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.keys()) == sorted(zb.keys())
        for k in za.keys():
            assert za[k].shape == zb[k].shape and za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k])


def test_fit_checkpoint_mismatch_raises(tmp_path):
    """A checkpoint of another parameterization refuses to load."""
    params = {"a": torch.zeros(3), "b": torch.ones(2)}
    opt = {"a.step": torch.tensor(1.0)}
    ck.save_fit(tmp_path / "f.npz", 1, params, opt, [0.5])
    step, p, o, losses = ck.load_fit(tmp_path / "f.npz", params, opt)
    assert step == 1 and losses == [0.5] and torch.equal(p["b"], params["b"])
    assert p["a"].dtype == torch.float32 and o["a.step"].dtype == torch.float32
    with pytest.raises(ValueError, match="tensors"):
        ck.load_fit(tmp_path / "f.npz", {"a": torch.zeros(3)}, opt)
    with pytest.raises(ValueError, match="are"):
        ck.load_fit(tmp_path / "f.npz", {"a": torch.zeros(3), "c": torch.ones(2)}, opt)
    with pytest.raises(ValueError, match="shape"):
        ck.load_fit(tmp_path / "f.npz", {"a": torch.zeros(4), "b": torch.ones(2)}, opt)


def test_fit_cli_checkpoint_resumes(tmp_path, capsys):
    """`fit --checkpoint-path`: 2 steps, then the same command at 4 resumes
    and ends with the uninterrupted run's saved state; the default interval
    is steps // 10 (at least 1)."""
    base = ["fit", "--device", "cpu", "--scene", "diffuse", "--width", "16", "--height", "16",
            "--spp", "2", "--max-bounces", "2"]
    app.main(base + ["--steps", "4", "--checkpoint-path", str(tmp_path / "ref.npz")])
    app.main(base + ["--steps", "2", "--checkpoint-path", str(tmp_path / "f.npz")])
    app.main(base + ["--steps", "4", "--checkpoint-path", str(tmp_path / "f.npz"),
                     "--checkpoint-every", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("fit: 4 steps in ")
    _assert_same_checkpoint(tmp_path / "ref.npz", tmp_path / "f.npz")
