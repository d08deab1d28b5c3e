"""PyTorch port: the parallel layer on CPU slots, every case of
``tests/test_parallel.py`` (whose 8 fake CPU devices become 8 CPU slots,
``make_mesh(..., devices=[cpu] * 8)``), and the port against the JAX
package's ``render_sharded`` on the same mesh.

Tolerances are the JAX suite's, case for case: rtol 1e-6 / atol 1e-6 for a
sharded render against the unsharded one (the spp mean's association
differs), bit for bit with no spp split; 1e-4 for the sharded core
gradient, 1e-3 for the kernel engine's against core, 2e-3 / 3e-6 for the
physical kernel's on the flip-free scene, 1e-4 for the psummed geometry
cotangents. Scenes are built once with the JAX package's SceneBuilder and
carried over with ``scene_from_arrays``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu import parallel as jparallel
from path_tracer_c_tpu.scene import demo as jdemo
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch import parallel
from path_tracer_c_tpu_torch.grad import diff
from path_tracer_c_tpu_torch.models.integrator import render_radiance
from path_tracer_c_tpu_torch.models.physical import render_physical
from path_tracer_c_tpu_torch.ops.render_physical_grad import render_physical_kernel_vjp
from path_tracer_c_tpu_torch.scene.io import scene_from_arrays

torch.set_num_threads(1)

CAM = P.Camera.reference("cpu")
CPU8 = [torch.device("cpu")] * 8


def arrays(x):
    if dataclasses.is_dataclass(x):
        return {f.name: arrays(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def carry(jscene):
    return scene_from_arrays(arrays(jscene), "cpu")


def mesh(tile, spp):
    return parallel.make_mesh(tile=tile, spp=spp, devices=CPU8)


def with_leaf(scene, table, name, value):
    return dataclasses.replace(scene, **{table: dataclasses.replace(
        getattr(scene, table), **{name: value})})


@pytest.fixture(scope="module")
def jscene():
    return jdemo.diffuse_sphere_scene()


@pytest.fixture(scope="module")
def scene(jscene):
    return carry(jscene)


def test_eight_cpu_slots():
    m = mesh(8, 1)
    assert m.size == 8 and m.shape == {"tile": 8, "spp": 1}
    assert all(s.device.type == "cpu" and s.rank == 0 for _, _, s in m.flat())
    assert parallel.make_mesh(tile=4, spp=2, devices="cpu").size == 8


@pytest.mark.parametrize("tile,spp_ax", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_render_bit_identical(scene, tile, spp_ax):
    h, w, spp, bounces = 16, 16, 8, 2
    single = render_radiance(scene, CAM, h, w, spp, bounces, 5)
    sharded = parallel.render_sharded(scene, CAM, h, w, spp, bounces, 5, mesh(tile, spp_ax))
    np.testing.assert_allclose(sharded.numpy(), single.numpy(), rtol=1e-6, atol=1e-6)


def test_sharded_render_exact_when_tile_only(scene):
    h, w, spp, bounces = 16, 16, 4, 2
    single = render_radiance(scene, CAM, h, w, spp, bounces, 9)
    sharded = parallel.render_sharded(scene, CAM, h, w, spp, bounces, 9, mesh(8, 1))
    assert torch.equal(sharded, single)


def test_output_sharding_layout(scene):
    """One (H, W, 3) tensor, its rows from four row blocks in tile order."""
    m = mesh(4, 2)
    img = parallel.render_sharded(scene, CAM, 16, 16, 8, 2, 0, m)
    assert img.shape == (16, 16, 3)
    assert len({ti for ti, _, _ in m.local()}) == 4
    block = render_radiance(scene, CAM, 16, 16, 8, 2, 0)[4:8]
    np.testing.assert_allclose(img[4:8].numpy(), block.numpy(), rtol=1e-6, atol=1e-6)


def test_divisibility_validation(scene, jscene):
    """The JAX package's errors, message for message."""
    for (tile, spp_ax), (h, spp) in (((8, 1), (12, 4)), ((1, 8), (16, 4))):
        with pytest.raises(ValueError) as jerr:
            jparallel.render_sharded(jscene, J.Camera.reference(), h, 16, spp, 2, jnp.uint32(0),
                                     jparallel.make_mesh(tile=tile, spp=spp_ax))
        with pytest.raises(ValueError) as perr:
            parallel.render_sharded(scene, CAM, h, 16, spp, 2, 0, mesh(tile, spp_ax))
        assert str(perr.value) == str(jerr.value)


def test_replicate_scene(scene):
    copies = parallel.replicate_scene(scene, mesh(4, 2))
    assert list(copies) == [torch.device("cpu")]
    assert torch.equal(copies[torch.device("cpu")].spheres.center, scene.spheres.center)


def test_sharded_gradient_matches_unsharded(scene):
    h, w, spp, bounces = 16, 16, 4, 2
    target = render_radiance(scene, CAM, h, w, spp, bounces, 77)
    m = mesh(4, 2)

    def grad(render):
        albedo = scene.materials.albedo.clone().requires_grad_()
        img = render(with_leaf(scene, "materials", "albedo", albedo))
        return torch.autograd.grad(torch.mean((img - target) ** 2), albedo)[0]

    g_sharded = grad(lambda sc: parallel.render_sharded(sc, CAM, h, w, spp, bounces, 3, m))
    g_single = grad(lambda sc: render_radiance(sc, CAM, h, w, spp, bounces, 3))
    np.testing.assert_allclose(g_sharded.numpy(), g_single.numpy(), rtol=1e-4, atol=1e-7)


def test_train_step_decreases_loss(scene):
    h, w, spp, bounces = 16, 16, 4, 2
    m = mesh(4, 2)
    target = parallel.render_sharded(scene, CAM, h, w, spp, bounces, 101, m)
    params = diff.make_material_params(scene)
    with torch.no_grad():
        params["albedo_logit"].zero_()
    logit0 = params["albedo_logit"].detach().clone()
    opt = diff._adam(params, 0.1)
    step = parallel.make_train_step(CAM, h, w, spp, bounces, m, diff.apply_material_params)
    losses = [float(step(params, opt, scene, target, i + 1)) for i in range(12)]
    # spp=4 keeps the Monte-Carlo noise floor high: the trend, and the albedo
    # moving toward the truth, as the JAX test checks.
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    true = scene.materials.albedo.numpy()
    err0 = np.abs(torch.sigmoid(logit0).numpy() - true)
    err1 = np.abs(torch.sigmoid(params["albedo_logit"].detach()).numpy() - true)
    assert err1[:2].mean() < err0[:2].mean(), (err0[:2].mean(), err1[:2].mean())


def test_train_step_gradient_is_the_unsharded_one(scene):
    """make_train_step leaves the summed gradient in ``.grad`` (here with an
    optimizer that takes no step): the unsharded gradient of the same
    loss, to float32 summation order."""
    h, w, spp, bounces = 16, 16, 4, 2
    target = render_radiance(scene, CAM, h, w, spp, bounces, 77)
    params = diff.make_material_params(scene)
    step = parallel.make_train_step(CAM, h, w, spp, bounces,
                                    parallel.make_mesh(tile=2, spp=2, devices="cpu"),
                                    diff.apply_material_params, engine="cuda")

    class NoStep:
        def step(self):
            pass

    step(params, NoStep(), scene, target, 3)
    probe = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    loss = diff.render_loss(diff.apply_material_params(scene, probe), target, CAM, h, w, spp,
                            bounces, 3, engine="cuda")
    for (k, v), g in zip(params.items(), torch.autograd.grad(loss, list(probe.values()),
                                                             allow_unused=True)):
        torch.testing.assert_close(v.grad, g if g is not None else torch.zeros_like(v),
                                   rtol=1e-4, atol=1e-9)


def test_health_check():
    status = parallel.distributed.health_check(mesh(8, 1))
    assert status["alive"] and status["devices"] == 8 and status["processes"] == 1
    assert parallel.distributed.health_check()["alive"]
    assert not parallel.distributed.is_multi_host()
    parallel.distributed.initialize()  # one process: a no-op
    parallel.distributed.initialize(num_processes=1)


def test_mesh_validation():
    with pytest.raises(ValueError, match=r"tile\*spp = 6 != 8 devices"):
        parallel.make_mesh(tile=3, spp=2, devices=CPU8)
    with pytest.raises(ValueError, match="8 devices not divisible by spp=3"):
        parallel.make_mesh(spp=3, devices=CPU8)


def test_default_mesh_needs_a_card(monkeypatch):
    """Without a card the default mesh raises: it never moves to the CPU by
    itself; a card index beyond the visible ones is refused by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh(tile=2)
    with pytest.raises(ValueError, match="not among the 0 visible CUDA devices"):
        parallel.make_mesh(tile=1, devices=["cuda:0"])


def test_sharded_pallas_engine_matches_core(scene):
    h, w, spp, bounces = 16, 128, 4, 2
    m = mesh(2, 4)
    core = parallel.render_sharded(scene, CAM, h, w, spp, bounces, 3, m)
    fast = parallel.render_sharded(scene, CAM, h, w, spp, bounces, 3, m, engine="pallas")
    np.testing.assert_allclose(fast.numpy(), core.numpy(), rtol=1e-5, atol=1e-5)


def test_sharded_pallas_gradient_matches_unsharded_core(scene):
    h, w, spp, bounces = 16, 128, 4, 2
    target = render_radiance(scene, CAM, h, w, spp, bounces, 77)
    m = mesh(2, 4)

    def grad(render):
        albedo = scene.materials.albedo.clone().requires_grad_()
        img = render(with_leaf(scene, "materials", "albedo", albedo))
        return torch.autograd.grad(torch.mean((img - target) ** 2), albedo)[0]

    g_fast = grad(lambda sc: parallel.render_sharded(sc, CAM, h, w, spp, bounces, 3, m,
                                                     engine="pallas"))
    g_core = grad(lambda sc: render_radiance(sc, CAM, h, w, spp, bounces, 3))
    np.testing.assert_allclose(g_fast.numpy(), g_core.numpy(), rtol=1e-3, atol=1e-7)


def _flipfree_physical_scene():
    """tests/test_parallel.py's: triangle ground, unit-scale spheres, one
    emitter, no giant wall spheres."""
    b = J.SceneBuilder(sky_color=(0.25, 0.3, 0.4))
    ground = b.add_material(albedo=(0.55, 0.45, 0.35), roughness=1.0)
    lamp = b.add_material(albedo=(0.9, 0.9, 0.9), emission_color=(1.0, 0.85, 0.6),
                          emission_strength=8.0)
    glass = b.add_material(albedo=(0.95, 0.97, 1.0), transparency=0.6, refractive_index=1.45,
                           roughness=0.2)
    mirror = b.add_material(albedo=(0.9, 0.92, 0.95), roughness=0.05)
    b.add_triangle(v0=(-60, -1, -60), v1=(60, -1, -60), v2=(60, -1, 60), material=ground)
    b.add_triangle(v0=(-60, -1, -60), v1=(-60, -1, 60), v2=(60, -1, 60), material=ground)
    b.add_sphere(center=(0.0, 2.6, 5.5), radius=0.5, material=lamp)
    b.add_sphere(center=(-1.0, -0.2, 4.5), radius=0.8, material=mirror)
    b.add_sphere(center=(1.1, -0.3, 4.0), radius=0.7, material=glass)
    b.add_sphere(center=(0.1, -0.45, 3.2), radius=0.5, material=ground)
    return carry(b.build())


def test_sharded_physical_pallas_gradient_matches_core():
    scene_l = _flipfree_physical_scene()
    h, w, spp, bounces = 16, 128, 2, 2
    target = render_physical(scene_l, CAM, h, w, spp, bounces, 77, jitter=False)
    m = mesh(2, 4)

    def grad(render):
        albedo = scene_l.materials.albedo.clone().requires_grad_()
        img = render(with_leaf(scene_l, "materials", "albedo", albedo))
        return torch.autograd.grad(torch.mean((img - target) ** 2), albedo)[0]

    g_fast = grad(lambda sc: parallel.render_sharded(sc, CAM, h, w, spp * 4, bounces, 3, m,
                                                     engine="physical_pallas", jitter=False))
    g_core = grad(lambda sc: render_physical(sc, CAM, h, w, spp * 4, bounces, 3, jitter=False))
    np.testing.assert_allclose(g_fast.numpy(), g_core.numpy(), rtol=2e-3, atol=3e-6)


def test_sharded_physical_geom_gradient_matches_unsharded():
    scene_l = _flipfree_physical_scene()
    h, w, spp, bounces = 16, 128, 4, 2
    target = torch.zeros((h, w, 3))
    m = mesh(2, 4)

    def grad(render):
        c0 = scene_l.spheres.center[0].clone().requires_grad_()
        centers = torch.cat([c0[None], scene_l.spheres.center[1:]])
        img = render(with_leaf(scene_l, "spheres", "center", centers))
        return torch.autograd.grad(torch.mean((img - target) ** 2), c0)[0]

    g_sharded = grad(lambda sc: parallel.render_sharded(
        sc, CAM, h, w, spp, bounces, 3, m, engine="physical_pallas", jitter=False, geom=True,
        n_em_cap=1))
    g_single = grad(lambda sc: render_physical_kernel_vjp(sc, CAM, h, w, spp, bounces, 3,
                                                          jitter=False, geom=True, n_em_cap=1))
    assert float(g_single.abs().max()) > 1e-8
    np.testing.assert_allclose(g_sharded.numpy(), g_single.numpy(), rtol=1e-4, atol=1e-9)


def test_sharded_physical_engine_matches_unsharded():
    h, w, spp, bounces = 16, 16, 4, 2
    scene_l = carry(jdemo.cornell_spheres_scene())
    single = render_physical(scene_l, CAM, h, w, spp, bounces, 5)
    sharded = parallel.render_sharded(scene_l, CAM, h, w, spp, bounces, 5, mesh(4, 2),
                                      engine="physical", jitter=True)
    np.testing.assert_allclose(sharded.numpy(), single.numpy(), rtol=1e-5, atol=1e-5)


def _tri_lamp_scene():
    b = J.SceneBuilder(sky_color=(0.0, 0.0, 0.0))
    ground = b.add_material(albedo=(0.6, 0.55, 0.5), roughness=1.0)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.9, 0.7),
                          emission_strength=20.0)
    ball = b.add_material(albedo=(0.7, 0.3, 0.3), roughness=1.0)
    b.add_triangle(v0=(-40, -1, -40), v1=(40, -1, -40), v2=(40, -1, 40), material=ground)
    b.add_triangle(v0=(-40, -1, -40), v1=(-40, -1, 40), v2=(40, -1, 40), material=ground)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(1.0, 3.0, 4.0), v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(-1.0, 3.0, 6.0), v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_sphere(center=(0.0, -0.3, 5.0), radius=0.7, material=ball)
    return carry(b.build())


def test_sharded_tri_nee_matches_unsharded():
    scene_t = _tri_lamp_scene()
    h, w, spp, bounces = 16, 16, 4, 2
    m = mesh(4, 2)
    single = render_physical(scene_t, CAM, h, w, spp, bounces, 5, jitter=False, tri_nee=True)
    for engine in ("physical", "physical_pallas"):
        sharded = parallel.render_sharded(scene_t, CAM, h, w, spp, bounces, 5, m, engine=engine,
                                          jitter=False, tri_nee=True)
        np.testing.assert_allclose(sharded.numpy(), single.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=engine)
    with pytest.raises(ValueError, match="tri_nee requires a physical engine"):
        parallel.render_sharded(scene_t, CAM, h, w, spp, bounces, 5, m, engine="core",
                                tri_nee=True)


def test_sharded_tri_nee_vertex_gradient_matches_unsharded():
    scene_t = _tri_lamp_scene()
    h, w, spp, bounces = 16, 16, 4, 2
    target = torch.zeros((h, w, 3))
    m = mesh(2, 4)

    def grad(render):
        v = scene_t.triangles.v0[2].clone().requires_grad_()
        v0 = torch.cat([scene_t.triangles.v0[:2], v[None], scene_t.triangles.v0[3:]])
        img = render(with_leaf(scene_t, "triangles", "v0", v0))
        return torch.autograd.grad(torch.mean((img - target) ** 2), v)[0]

    kw = dict(jitter=False, geom=True, n_em_cap=1, tri_nee=True, tri_em_cap=2)
    g_sharded = grad(lambda sc: parallel.render_sharded(sc, CAM, h, w, spp, bounces, 3, m,
                                                        engine="physical_pallas", **kw))
    g_single = grad(lambda sc: render_physical_kernel_vjp(sc, CAM, h, w, spp, bounces, 3, **kw))
    assert float(g_single.abs().max()) > 1e-10
    np.testing.assert_allclose(g_sharded.numpy(), g_single.numpy(), rtol=1e-4, atol=1e-12)


def test_sharded_rough_grad_matches_unsharded():
    scene_g = carry(jdemo.glossy_scene())
    h, w, spp, bounces = 16, 16, 4, 2
    target = torch.zeros((h, w, 3))
    m = mesh(2, 4)

    def grad(render):
        r = scene_g.materials.roughness[0].clone().requires_grad_()
        rough = torch.cat([r[None], scene_g.materials.roughness[1:]])
        img = render(with_leaf(scene_g, "materials", "roughness", rough))
        return float(torch.autograd.grad(torch.mean((img - target) ** 2), r)[0])

    g_sharded = grad(lambda sc: parallel.render_sharded(
        sc, CAM, h, w, spp, bounces, 3, m, engine="physical_pallas", jitter=False,
        rough_grad=True))
    g_single = grad(lambda sc: render_physical_kernel_vjp(sc, CAM, h, w, spp, bounces, 3,
                                                          jitter=False, geom=False,
                                                          rough_grad=True))
    assert abs(g_single) > 1e-10
    assert abs(g_sharded - g_single) <= 1e-4 * max(abs(g_single), 1e-6)
    with pytest.raises(ValueError, match="rough_grad"):
        parallel.render_sharded(scene_g, CAM, h, w, spp, bounces, 3, m, engine="pallas",
                                rough_grad=True)


@pytest.mark.parametrize("tile,spp_ax", [(8, 1), (4, 2), (1, 8)])
def test_port_matches_jax_render_sharded(jscene, scene, tile, spp_ax):
    """The port's sharded render against the JAX package's on the same mesh
    (8 fake devices against 8 CPU slots): rtol 1e-6."""
    h, w, spp, bounces = 16, 16, 8, 2
    want = np.asarray(jparallel.render_sharded(
        jscene, J.Camera.reference(), h, w, spp, bounces, jnp.uint32(5),
        jparallel.make_mesh(tile=tile, spp=spp_ax)))
    got = parallel.render_sharded(scene, CAM, h, w, spp, bounces, 5, mesh(tile, spp_ax))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_jax_suite_has_eight_fake_devices():
    """The comparison above lays the JAX mesh on the suite's 8 fake devices."""
    assert len(jax.devices()) == 8
