"""PyTorch port: the gradient of the render. The eager integrator under
``torch.autograd`` against ``jax.vjp`` of the JAX integrator, and the fused
primal + Jacobian kernel's plain twin against the JAX package's Pallas
kernel (interpret mode on the CPU), against the forward twin, and against
autograd. The CUDA kernel itself is tested in test_torch_cuda.py.

Tolerances. Gradients against an AD oracle: rtol 5e-3, atol 2e-5, the JAX
suite's own (tests/test_pallas_grad.py): the oracle takes other roots and
normalisations than the kernel's arithmetic, so a grazing path may flip.
The twin against Pallas-interpret, same arithmetic on both sides: rtol
1e-5, atol 1e-6 on the contracted cotangents.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.ops import pallas_grad as jgrad
from path_tracer_c_tpu.ops.pallas_kernels import render_pallas_vjp
from path_tracer_c_tpu.scene import demo as jdemo
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.ops import render_grad as rg
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.scene.io import scene_from_arrays
from path_tracer_c_tpu_torch.utils import tracing

torch.set_num_threads(1)

JCAM = J.Camera.reference()
PCAM = P.Camera.reference("cpu")
LEAVES = ("albedo", "emission_color", "emission_strength", "transparency", "sky_color")


def mixed_scene():
    """Every cotangent path: emission, partial transparency (the ratio
    term and total internal reflection), diffuse bounces, sky misses
    (tests/test_pallas_grad.py)."""
    b = J.SceneBuilder(sky_color=(0.2, 0.3, 0.5))
    b.add_material(albedo=(0.9, 0.8, 0.7), roughness=0.4,
                   emission_color=(1.0, 0.8, 0.6), emission_strength=3.0)
    glassy = b.add_material(albedo=(0.9, 0.95, 1.0), roughness=0.1,
                            transparency=0.5, refractive_index=1.4)
    diffuse = b.add_material(albedo=(0.6, 0.3, 0.2), roughness=1.0)
    b.add_sphere(center=(0, 2.5, 6), radius=1.5, material=0)
    b.add_sphere(center=(0.5, -0.2, 4), radius=1.0, material=glassy)
    b.add_triangle(v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50), material=diffuse)
    b.add_triangle(v0=(-50, -1, -50), v1=(-50, -1, 50), v2=(50, -1, 50), material=diffuse)
    return b.build()


def black_albedo_scene():
    """The camera inside an exactly black sphere: throughput is zero after
    bounce 0, yet d_albedo there needs the rounds after it."""
    b = J.SceneBuilder(sky_color=(0.8, 0.6, 0.4))
    black = b.add_material(albedo=(0.0, 0.0, 0.0), roughness=0.7,
                           emission_color=(1.0, 0.9, 0.8), emission_strength=0.5)
    b.add_sphere(center=(0.0, 0.0, 0.0), radius=5.0, material=black)
    return b.build()


def black_albedo_mixed_scene():
    scene = mixed_scene()
    mats = scene.materials
    return dataclasses.replace(scene, materials=dataclasses.replace(
        mats, albedo=mats.albedo.at[2].set(0.0)))


SCENES = {
    "mixed": mixed_scene, "demo": jdemo.demo_scene,
    "cornell": jdemo.cornell_spheres_scene, "black": black_albedo_scene,
    "black_mixed": black_albedo_mixed_scene,
}


def arrays(x):
    """A JAX dataclass tree as nested numpy dicts under its field names."""
    if dataclasses.is_dataclass(x):
        return {f.name: arrays(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def carry(jscene):
    return scene_from_arrays(arrays(jscene), "cpu")


def cotangent(h, w, gseed):
    return np.random.default_rng(gseed).standard_normal((h, w, 3)).astype(np.float32)


def five(d_scene):
    """The five gradient-carrying leaves of a Scene-shaped cotangent (JAX
    or PyTorch) as numpy arrays."""
    m = d_scene.materials
    return [np.asarray(x) for x in (m.albedo, m.emission_color, m.emission_strength,
                                    m.transparency, d_scene.sky_color)]


def autograd_eager(pscene, g, h, w, spp, bounces, seed, jitter=False):
    leaves = [t.clone().requires_grad_() for t in rg._grad_leaves(pscene)]
    out = P.render_radiance(rg._with_leaves(pscene, leaves), PCAM, h, w, spp, bounces,
                            seed, jitter=jitter)
    return [x.numpy() for x in torch.autograd.grad(out, leaves, torch.from_numpy(g))]


def assert_leaves_close(got, want, rtol, atol):
    for name, a, b in zip(LEAVES, got, want):
        assert np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


# -- (a) the eager integrator as AD oracle ----------------------------------


def test_eager_gradient_matches_jax_vjp_transparency_included():
    """autograd through the eager integrator equals jax.vjp of the JAX one,
    and the transparency gradient (1/t on refraction, -1/(1-t) on
    reflection, through the detached-ratio form) is there."""
    jscene = mixed_scene()
    h, w, spp, bounces, seed = 16, 128, 3, 4, 7
    g = cotangent(h, w, 0)
    _, vjp = jax.vjp(
        lambda sc: J.render_radiance(sc, JCAM, h, w, spp, bounces, jnp.uint32(seed)), jscene)
    want = five(vjp(jnp.asarray(g))[0])
    got = autograd_eager(carry(jscene), g, h, w, spp, bounces, seed)
    assert_leaves_close(got, want, rtol=5e-3, atol=2e-5)
    assert np.abs(got[3][1]) > 1.0  # the glass material's d_transparency
    assert np.all(got[3] != 0.0)  # the opaque ones too: -1/(1-t) where they reflected


def test_eager_gradient_is_finite_on_every_float_leaf():
    """No NaN from an untaken branch (a sqrt of a clamped value under a
    where, the offset's root on miss lanes): every float leaf may require
    a gradient; those outside the five get exact zeros."""
    pscene = carry(jdemo.demo_scene())
    target = torch.zeros(8, 16, 3)
    loss, d = P.loss_and_grad(pscene, target, PCAM, 8, 16, 2, 3, 5, engine="core")
    assert np.isfinite(float(loss))
    for tab in (d.materials, d.spheres, d.triangles):
        for f in dataclasses.fields(tab):
            assert bool(torch.isfinite(getattr(tab, f.name).float()).all()), f.name
    assert bool(d.materials.albedo.any()) and bool(d.sky_color.any())
    for t in (d.materials.roughness, d.materials.refractive_index, d.spheres.center,
              d.spheres.radius, d.triangles.v0):
        assert not bool(t.any())


# -- (b) the fused twin's image is the forward twin's -----------------------


@pytest.mark.parametrize("name, jitter", [("mixed", False), ("demo", True), ("black", False),
                                          ("black_mixed", True)])
def test_fused_twin_image_equals_forward_twin(name, jitter):
    pscene = carry(SCENES[name]())
    args = (pscene, PCAM, 16, 128, 3, 4, 21)
    img, jac = rg.render_fused(*args, sample_offset=2, jitter=jitter)
    assert torch.equal(img, rk.render_kernel_reference(*args, sample_offset=2, jitter=jitter))
    assert jac.shape == (9 * pscene.num_materials + 3, 16, 128) and jac.dtype == torch.float32
    assert bool(torch.isfinite(jac).all())


# -- (c) the fused twin against Pallas in interpret mode --------------------


@pytest.mark.parametrize("name, h, spp, bounces, seed, jitter", [
    ("mixed", 8, 2, 3, 43, False),
    ("demo", 8, 2, 3, 3, True),
    ("black", 8, 2, 4, 11, False),
])
def test_fused_twin_matches_pallas_interpret(name, h, spp, bounces, seed, jitter):
    """Image and Jacobian against render_pallas_fused(interpret=True). The
    forward twin is bit-equal to Pallas-interpret at this size, and the
    sweep adds in the same order, so the contracted cotangents are held to
    rtol 1e-5, atol 1e-6."""
    w = 128
    jscene = SCENES[name]()
    jimg, jjac = jgrad.render_pallas_fused(jscene, JCAM, h, w, spp, bounces,
                                           jnp.uint32(seed), interpret=True, jitter=jitter)
    pscene = carry(jscene)
    img, jac = rg.render_fused_reference(pscene, PCAM, h, w, spp, bounces, seed, jitter=jitter)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(jac.numpy(), np.asarray(jjac), rtol=1e-5, atol=1e-6)
    g = cotangent(h, w, 9)
    got = five(rg.contract_jacobian(pscene, jac, torch.from_numpy(g), spp))
    want = five(jgrad.contract_jacobian(jscene, jjac, jnp.asarray(g), spp))
    assert_leaves_close(got, want, rtol=1e-5, atol=1e-6)


# -- (d) the contraction ------------------------------------------------------


def test_contract_jacobian_matches_jax():
    jscene = jdemo.glossy_scene()
    pscene = carry(jscene)
    rng = np.random.default_rng(4)
    jac = rng.standard_normal((9 * pscene.num_materials + 3, 6, 10)).astype(np.float32)
    g = rng.standard_normal((6, 10, 3)).astype(np.float32)
    got = rg.contract_jacobian(pscene, torch.from_numpy(jac), torch.from_numpy(g), 4)
    want = jgrad.contract_jacobian(jscene, jnp.asarray(jac), jnp.asarray(g), 4)
    assert_leaves_close(five(got), five(want), rtol=1e-5, atol=1e-6)
    assert got.materials.albedo.shape == (pscene.num_materials, 3)


# -- (e) the twin's cotangents against autograd ----------------------------


@pytest.mark.parametrize("name, h, spp, bounces, seed, gseed, jitter, rtol", [
    ("mixed", 16, 3, 4, 7, 0, False, 5e-3),
    ("demo", 8, 2, 4, 3, 1, False, 5e-3),
    # Giant wall spheres make closest hits grazing-sensitive: the eager
    # integrator and the kernel's arithmetic may flip a path or two.
    ("cornell", 8, 2, 3, 5, 2, False, 2e-2),
    ("black", 8, 2, 4, 11, 3, False, 5e-3),
    ("black_mixed", 8, 3, 4, 13, 4, False, 5e-3),
    ("mixed", 8, 2, 3, 17, 5, True, 5e-3),
])
def test_twin_cotangents_match_autograd(name, h, spp, bounces, seed, gseed, jitter, rtol):
    w = 128
    pscene = carry(SCENES[name]())
    g = cotangent(h, w, gseed)
    _, jac = rg.render_fused(pscene, PCAM, h, w, spp, bounces, seed, jitter=jitter)
    got = five(rg.contract_jacobian(pscene, jac, torch.from_numpy(g), spp))
    want = autograd_eager(pscene, g, h, w, spp, bounces, seed, jitter=jitter)
    assert_leaves_close(got, want, rtol=rtol, atol=2e-5)
    assert any(np.any(x) for x in got)


# -- (f) the autograd.Function under a loss ---------------------------------


def test_render_kernel_vjp_under_a_loss_matches_core():
    pscene = carry(mixed_scene())
    h, w, spp, bounces = 8, 128, 2, 3
    target = P.render_radiance(pscene, PCAM, h, w, spp, bounces, 9)

    def grad_of(render):
        albedo = pscene.materials.albedo.clone().requires_grad_()
        sc = dataclasses.replace(pscene, materials=dataclasses.replace(
            pscene.materials, albedo=albedo))
        loss = torch.mean((render(sc, PCAM, h, w, spp, bounces, 2) - target) ** 2)
        loss.backward()
        return albedo.grad.numpy()

    launches = tracing.counters()
    np.testing.assert_allclose(grad_of(rg.render_kernel_vjp), grad_of(P.render_radiance),
                               rtol=1e-3, atol=1e-7)
    assert (tracing.counters() - launches)["launch.render_fused"] == 0  # the twin ran


def test_render_kernel_vjp_without_grad_is_render_kernel(monkeypatch):
    pscene = carry(jdemo.demo_scene())
    monkeypatch.setattr(rg, "render_fused", lambda *a, **k: pytest.fail("the fused path ran"))
    img = rg.render_kernel_vjp(pscene, PCAM, 8, 16, 2, 3, 4, sample_offset=1, jitter=True)
    assert torch.equal(img, rk.render_kernel(pscene, PCAM, 8, 16, 2, 3, 4,
                                             sample_offset=1, jitter=True))
    assert not img.requires_grad


# -- (g) the zero contracts, from both sides --------------------------------


def test_zero_cotangents_in_the_port_and_in_jax():
    """Roughness, metallicity, refractive index, every sphere and triangle
    leaf and the camera get no gradient: ``.grad`` stays None behind
    render_kernel_vjp, contract_jacobian returns zeros, and the JAX VJP
    returns zeros for the same leaves."""
    jscene = mixed_scene()
    h, w, spp, bounces, seed = 8, 128, 2, 3, 43
    g = cotangent(h, w, 6)
    # the port: every float leaf and the camera require a gradient
    pscene = carry(jscene)
    req = lambda tab: dataclasses.replace(tab, **{
        f.name: getattr(tab, f.name).clone().requires_grad_()
        for f in dataclasses.fields(tab) if getattr(tab, f.name).is_floating_point()})
    live = P.Scene(req(pscene.materials), req(pscene.spheres), req(pscene.triangles),
                   pscene.sky_color.clone().requires_grad_())
    cam = req(PCAM)
    rg.render_kernel_vjp(live, cam, h, w, spp, bounces, seed).backward(torch.from_numpy(g))
    for name in LEAVES[:4]:
        assert getattr(live.materials, name).grad is not None
    assert live.sky_color.grad is not None
    silent = [live.materials.roughness, live.materials.metallicity,
              live.materials.refractive_index, live.spheres.center, live.spheres.radius,
              live.triangles.v0, live.triangles.v1, live.triangles.v2]
    silent += [getattr(cam, f.name) for f in dataclasses.fields(cam)]
    assert all(t.grad is None for t in silent)
    _, jac = rg.render_fused(pscene, PCAM, h, w, spp, bounces, seed)
    d = rg.contract_jacobian(pscene, jac, torch.from_numpy(g), spp)
    zero_p = [d.materials.roughness, d.materials.metallicity, d.materials.refractive_index,
              d.spheres.center, d.spheres.radius, d.triangles.v0, d.triangles.v1,
              d.triangles.v2]
    assert not any(bool(t.any()) for t in zero_p)
    # JAX: the same leaves of render_pallas_bwd, and the camera's VJP
    dj = jgrad.render_pallas_bwd(jscene, JCAM, jnp.asarray(g), h, w, spp, bounces,
                                 jnp.uint32(seed), tile=jgrad.FUSED_TILE)
    zero_j = [dj.materials.roughness, dj.materials.metallicity,
              dj.materials.refractive_index, dj.spheres.center, dj.spheres.radius,
              dj.triangles.v0, dj.triangles.v1, dj.triangles.v2]
    assert not any(np.any(np.asarray(t)) for t in zero_j)
    _, vjp = jax.vjp(lambda c: render_pallas_vjp(jscene, c, h, w, spp, bounces,
                                                 jnp.uint32(seed)), JCAM)
    assert not any(np.any(np.asarray(t)) for t in jax.tree_util.tree_leaves(vjp(jnp.asarray(g))[0]))
    # and the five that do flow agree
    assert_leaves_close(five(d), five(dj), rtol=1e-5, atol=1e-6)


# -- (h) executed rounds ------------------------------------------------------


def eager_rounds(pscene, h, w, spp, bounces, seed):
    """Ray-rounds that begin alive in the eager integrator, over the
    samples of one render (no jitter), as render_tile draws them."""
    from path_tracer_c_tpu_torch.models.integrator import trace_paths
    from path_tracer_c_tpu_torch.ops import rng
    from path_tracer_c_tpu_torch.ops.camera import pixel_indices, primary_rays

    pix = pixel_indices(h, w, "cpu")
    o, d = primary_rays(PCAM, h, w)
    return sum(int(trace_paths(pscene, o, d, rng.seed_state(pix, s, seed), bounces,
                               count_rounds=True)[2]) for s in range(spp))


@pytest.mark.parametrize("name, has_black", [("mixed", False), ("black_mixed", True),
                                             ("black", True)])
def test_count_rounds(name, has_black):
    """Thread-rounds: the fused twin stops a path at a miss or a death
    only, as the eager integrator's alive mask does; the forward twin also
    at zero throughput, which differs only where a material is black."""
    pscene = carry(SCENES[name]())
    args = (pscene, PCAM, 8, 128, 2, 4, 13)
    img, n_fwd = rk.render_kernel(*args, count_rounds=True)
    img2, jac, n_fus = rg.render_fused(*args, count_rounds=True)
    n_eager = eager_rounds(pscene, *args[2:])
    assert torch.equal(img, img2) and torch.equal(img, rk.render_kernel(*args))
    assert torch.equal(jac, rg.render_fused(*args)[1])
    assert 8 * 128 * 2 <= n_fwd <= n_fus <= 8 * 128 * 2 * 5
    assert n_fus == n_eager
    assert (n_fwd < n_fus) if has_black else (n_fwd == n_fus)


# -- the wrapper's rules ------------------------------------------------------


def test_fused_wrapper_rules():
    pscene = carry(jdemo.demo_scene())
    with pytest.raises(ValueError, match="cap"):
        rg.render_fused(pscene, PCAM, 8, 8, 1, rg.MAX_BOUNCES + 1, 0)
    with pytest.raises(ValueError):
        rg.render_fused(pscene, P.Camera.reference("meta"), 8, 8, 1, 1, 0)
    with pytest.raises(ValueError):
        rg.render_fused(P.demo.demo_scene("meta"), P.Camera.reference("meta"), 8, 8, 1, 1, 0)
    with pytest.raises(TypeError):
        rg.render_fused(dataclasses.replace(pscene, sky_color=pscene.sky_color.double()),
                        PCAM, 8, 8, 1, 1, 0)
    launches = tracing.counters()
    a = rg.render_fused(pscene, PCAM, 6, 10, 2, 2, 3)
    b = rg.render_fused_reference(pscene, PCAM, 6, 10, 2, 2, 3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (tracing.counters() - launches)["launch.render_fused"] == 0  # no card here
