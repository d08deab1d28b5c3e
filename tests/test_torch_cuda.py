"""PyTorch port on a card: the hand CUDA kernels against their plain twins.

These tests need a CUDA device and skip without one. They import no JAX, so
they also run where only PyTorch is installed; from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest.py configures JAX.)

Tolerance (tests/test_pallas.py's): a 0.999-quantile of |delta| < 1e-4 and
a mean |delta| < 1e-5. On the card the kernel and its twin round alike and
agree bit for bit; the CPU twin rounds rsqrt differently, and a chaotic path
can then flip at a silhouette.
"""

import dataclasses

import pytest
import torch

import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.ops import render_grad as rg
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
from path_tracer_c_tpu_torch.scene import demo as pdemo

pytestmark = pytest.mark.cuda


def assert_close(a, b):
    err = (a.double().cpu() - b.double().cpu()).abs().flatten()
    assert a.shape == b.shape and bool(torch.isfinite(err).all())
    assert float(torch.quantile(err, 0.999)) < 1e-4
    assert float(err.mean()) < 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", ["demo_scene", "glossy_scene", "cornell_spheres_scene"])
def test_kernel_matches_twin(cuda_device, name):
    scene, cam = getattr(pdemo, name)(cuda_device), P.Camera.reference(cuda_device)
    launches = rk.render_kernel.launches
    for jitter, offset, bounces in ((False, 0, 4), (True, 3, 8)):
        args = (scene, cam, 100, 160, 4, bounces, 7)
        k = rk.render_kernel(*args, sample_offset=offset, jitter=jitter)
        r = rk.render_kernel_reference(*args, sample_offset=offset, jitter=jitter)
        assert k.device == cuda_device and k.shape == (100, 160, 3)
        assert_close(k, r)
    assert rk.render_kernel.launches == launches + 2
    # the chain to the twin on the CPU
    cpu = rk.render_kernel_reference(getattr(pdemo, name)("cpu"), P.Camera.reference("cpu"),
                                     24, 40, 2, 4, 5, sample_offset=2, jitter=True)
    k = rk.render_kernel(scene, cam, 24, 40, 2, 4, 5, sample_offset=2, jitter=True)
    assert_close(k, cpu)


def test_kernel_rejects_mixed_devices(cuda_device):
    scene = pdemo.demo_scene(cuda_device)
    with pytest.raises(ValueError):
        rk.render_kernel(scene, P.Camera.reference("cpu"), 8, 8, 1, 1, 0)
    mixed = dataclasses.replace(scene, sky_color=scene.sky_color.cpu())
    with pytest.raises(ValueError):
        rk.render_kernel(mixed, P.Camera.reference(cuda_device), 8, 8, 1, 1, 0)


# -- the fused primal + Jacobian kernel --------------------------------------


def mixed_scene(device):
    """Emission, partial transparency (with total internal reflection), a
    diffuse floor whose albedo is exactly black, sky misses."""
    b = P.SceneBuilder(sky_color=(0.2, 0.3, 0.5))
    b.add_material(albedo=(0.9, 0.8, 0.7), roughness=0.4,
                   emission_color=(1.0, 0.8, 0.6), emission_strength=3.0)
    glassy = b.add_material(albedo=(0.9, 0.95, 1.0), roughness=0.1,
                            transparency=0.5, refractive_index=1.4)
    black = b.add_material(albedo=(0.0, 0.0, 0.0), roughness=1.0)
    b.add_sphere(center=(0, 2.5, 6), radius=1.5, material=0)
    b.add_sphere(center=(0.5, -0.2, 4), radius=1.0, material=glassy)
    b.add_triangle(v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50), material=black)
    b.add_triangle(v0=(-50, -1, -50), v1=(-50, -1, 50), v2=(50, -1, 50), material=black)
    return b.build(device)


@pytest.mark.parametrize(
    "name", ["demo_scene", "glossy_scene", "mixed", "random_spheres_scene"])
def test_fused_kernel_matches_forward_kernel_and_twin(cuda_device, name):
    """The image equals render_kernel's bit for bit, and image and
    Jacobian equal the twin's value for value: one definition of the
    arithmetic, no FMA contraction, one order of additions.
    random_spheres_scene has 33 materials, so 300 planes."""
    scene = mixed_scene(cuda_device) if name == "mixed" else getattr(pdemo, name)(cuda_device)
    cam = P.Camera.reference(cuda_device)
    launches = rg.render_fused.launches
    for jitter, offset, bounces in ((False, 0, 4), (True, 3, 8)):
        args = (scene, cam, 100, 160, 4, bounces, 7)
        kw = dict(sample_offset=offset, jitter=jitter)
        img, jac = rg.render_fused(*args, **kw)
        assert jac.shape == (9 * scene.num_materials + 3, 100, 160) and jac.device == cuda_device
        assert torch.equal(img, rk.render_kernel(*args, **kw))
        r_img, r_jac = rg.render_fused_reference(*args, **kw)
        assert torch.equal(img, r_img)
        assert torch.equal(jac, r_jac)
    assert rg.render_fused.launches == launches + 2


def test_count_rounds_match_twins(cuda_device):
    scene, cam = mixed_scene(cuda_device), P.Camera.reference(cuda_device)
    args = (scene, cam, 100, 160, 2, 6, 3)
    img, n_fwd = rk.render_kernel(*args, count_rounds=True)
    _, _, n_fus = rg.render_fused(*args, count_rounds=True)
    assert torch.equal(img, rk.render_kernel(*args))
    assert n_fwd == rk.render_kernel_reference(*args, count_rounds=True)[1]
    assert n_fus == rg.render_fused_reference(*args, count_rounds=True)[2]
    assert 0 < n_fwd < n_fus <= 100 * 160 * 2 * 7  # the black floor: more rounds fused


def test_vjp_backward_matches_twin_contraction(cuda_device):
    scene, cam = mixed_scene(cuda_device), P.Camera.reference(cuda_device)
    h, w, spp, bounces, seed = 32, 64, 3, 4, 7
    g = torch.randn((h, w, 3), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    leaves = [t.clone().requires_grad_() for t in rg._grad_leaves(scene)]
    launches = rg.render_fused.launches
    rg.render_kernel_vjp(rg._with_leaves(scene, leaves), cam, h, w, spp, bounces, seed).backward(g)
    assert rg.render_fused.launches == launches + 1
    _, r_jac = rg.render_fused_reference(scene, cam, h, w, spp, bounces, seed)
    want = rg._grad_leaves(rg.contract_jacobian(scene, r_jac, g, spp))
    for leaf, expect in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, expect, rtol=1e-5, atol=1e-6)
    assert scene.materials.roughness.grad is None


def test_fused_kernel_rejects_bad_inputs(cuda_device):
    scene, cam = pdemo.demo_scene(cuda_device), P.Camera.reference(cuda_device)
    with pytest.raises(ValueError):
        rg.render_fused(scene, P.Camera.reference("cpu"), 8, 8, 1, 1, 0)
    mixed = dataclasses.replace(scene, sky_color=scene.sky_color.cpu())
    with pytest.raises(ValueError):
        rg.render_fused(mixed, cam, 8, 8, 1, 1, 0)
    launches = rg.render_fused.launches
    with pytest.raises(ValueError, match="cap"):
        rg.render_fused(scene, cam, 8, 8, 1, rg.MAX_BOUNCES + 1, 0)
    assert rg.render_fused.launches == launches
    img, _ = rg.render_fused(scene, cam, 8, 8, 1, rg.MAX_BOUNCES, 0)  # the cap itself runs
    assert torch.equal(img, rk.render_kernel(scene, cam, 8, 8, 1, rg.MAX_BOUNCES, 0))


# -- the physical tier's forward kernel ------------------------------------------


def assert_close_physical(a, b):
    """tests/test_pallas_physical.py's tolerance for kernel against core."""
    err = (a.double().cpu() - b.double().cpu()).abs().flatten()
    assert a.shape == b.shape and bool(torch.isfinite(err).all())
    assert float(torch.quantile(err, 0.99)) < 1e-4
    assert float((err > 1e-3).double().mean()) < 0.01
    assert abs(float(a.double().mean()) - float(b.double().mean())) < 2e-3


def tri_light_mixed_scene(device):
    """A triangle ceiling light, a sphere light and diffuse content: the
    mixed emitter pool of tests/test_pallas_physical.py."""
    b = P.SceneBuilder(sky_color=(0.01, 0.01, 0.02))
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
    return b.build(device)


@pytest.mark.parametrize("name, kw", [
    ("cornell_spheres_scene", {}),
    ("glossy_scene", dict(sample_offset=3)),
    ("diffuse_sphere_scene", {}),  # no emitter: the pick is clamped, the term masked
    ("cornell_spheres_scene", dict(nee=False)),
    ("cornell_spheres_scene", dict(jitter=False)),
    ("tri_light", dict(tri_nee=True, jitter=False)),
    ("tri_light", dict(tri_nee=False)),
    ("glossy_scene", dict(tri_nee=True)),  # the flag with no emissive triangle
])
def test_physical_kernel_matches_twin(cuda_device, name, kw):
    """The kernel ends a path at zero throughput and skips light samples
    that cannot count; the twin runs every round of every path and masks.
    Equal images show that what the kernel skips adds exact zeros."""
    scene = (tri_light_mixed_scene(cuda_device) if name == "tri_light"
             else getattr(pdemo, name)(cuda_device))
    cam = P.Camera.reference(cuda_device)
    launches = rp.render_physical_kernel.launches
    args = (scene, cam, 100, 160, 4, 6, 7)
    k, n = rp.render_physical_kernel(*args, count_rounds=True, **kw)
    r, n_twin = rp.render_physical_kernel_reference(*args, count_rounds=True, **kw)
    assert k.device == cuda_device and k.shape == (100, 160, 3)
    assert_close_physical(k, r)
    assert torch.equal(k, rp.render_physical_kernel(*args, **kw))
    assert n == n_twin and 0 < n <= 100 * 160 * 4 * 7
    events = rp.render_physical_kernel(*args, count_events=True, **kw)[1]
    assert events == rp.render_physical_kernel_reference(*args, count_events=True, **kw)[1]
    assert events["rounds"] == n
    assert rp.render_physical_kernel.launches == launches + 3
    # the chain to the twin on the CPU
    cpu_scene = (tri_light_mixed_scene("cpu") if name == "tri_light"
                 else getattr(pdemo, name)("cpu"))
    cpu = rp.render_physical_kernel_reference(cpu_scene, P.Camera.reference("cpu"),
                                              24, 40, 2, 4, 5, **kw)
    assert_close_physical(rp.render_physical_kernel(scene, cam, 24, 40, 2, 4, 5, **kw), cpu)


def test_physical_kernel_rejects_mixed_devices(cuda_device):
    scene = pdemo.cornell_spheres_scene(cuda_device)
    launches = rp.render_physical_kernel.launches
    with pytest.raises(ValueError):
        rp.render_physical_kernel(scene, P.Camera.reference("cpu"), 8, 8, 1, 1, 0)
    assert rp.render_physical_kernel.launches == launches


# -- the physical tier's gradient kernels ----------------------------------------

FUSED_PHYSICAL_CASES = [
    ("cornell_spheres_scene", {}),
    ("glossy_scene", dict(n_em_cap=1, sample_offset=3)),
    ("cornell_spheres_scene", dict(nee=False, n_em_cap=1)),
    ("tri_light", dict(tri_nee=True, n_em_cap=1, tri_em_cap=2, rough_grad=True)),  # all flags
    ("tri_light", dict(tri_nee=True, n_em_cap=3, tri_em_cap=1, jitter=False)),  # above, below
    ("diffuse_sphere_scene", dict(rough_grad=True, n_em_cap=1)),  # no emitter
]


def physical_scene(name, device):
    return tri_light_mixed_scene(device) if name == "tri_light" else getattr(pdemo, name)(device)


@pytest.mark.parametrize("name, kw", FUSED_PHYSICAL_CASES)
def test_fused_physical_kernel_matches_forward_kernel_and_twin(cuda_device, name, kw):
    """The image equals the forward physical kernel's and the twin's bit for
    bit, every plane of the three families the twin's value for value, and
    the executed rounds the twin's: one definition of the arithmetic, no
    FMA contraction, the twin's order of additions."""
    scene, cam = physical_scene(name, cuda_device), P.Camera.reference(cuda_device)
    launches = pg.render_physical_fused.launches
    args = (scene, cam, 100, 160, 4, 6, 7)
    out = pg.render_physical_fused(*args, count_rounds=True, **kw)
    ref = pg.render_physical_fused_reference(*args, count_rounds=True, **kw)
    fwd_kw = {k: v for k, v in kw.items() if k in ("nee", "tri_nee", "jitter", "sample_offset")}
    assert torch.equal(out[0], rp.render_physical_kernel(*args, **fwd_kw))
    assert len(out) == len(ref) == 3 + bool(kw.get("n_em_cap")) + bool(kw.get("tri_em_cap"))
    for a, b in zip(out[:-1], ref[:-1]):
        assert a.device == cuda_device and torch.equal(a, b)
    assert out[-1] == ref[-1] and 0 < out[-1] <= 100 * 160 * 4 * 7
    assert out[-1] >= rp.render_physical_kernel(*args, count_rounds=True, **fwd_kw)[1]
    plain = pg.render_physical_fused(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(plain, out[:-1]))
    assert pg.render_physical_fused.launches == launches + 2


@pytest.mark.parametrize("name, kw", [
    ("cornell_spheres_scene", {}),
    ("glossy_scene", dict(n_em_cap=1, sample_offset=3)),
    ("cornell_spheres_scene", dict(nee=False)),
    ("tri_light", dict(tri_nee=True, n_em_cap=2, jitter=False)),
])
def test_two_pass_kernel_matches_twin_and_fused_contraction(cuda_device, name, kw):
    """The kernel reduces with float atomics in two levels, the twin in
    float64: rtol 2e-4 with an absolute floor of 1e-6 of the leaf's scale
    (the JAX suite's gate between its two schemes), against the twin and
    against the fused kernel's contraction."""
    scene, cam = physical_scene(name, cuda_device), P.Camera.reference(cuda_device)
    launches = pg.render_physical_bwd.launches
    g = torch.randn((100, 160, 3), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    d = pg.render_physical_bwd(scene, cam, g, 100, 160, 4, 6, 7, **kw)
    r = pg.render_physical_bwd_reference(scene, cam, g, 100, 160, 4, 6, 7, **kw)
    assert pg.render_physical_bwd.launches == launches + 1
    cap = kw.get("n_em_cap", min(scene.num_spheres, 8)) if kw.get("nee", True) else 0
    fkw = {k: v for k, v in kw.items() if k != "n_em_cap"}
    out = pg.render_physical_fused(scene, cam, 100, 160, 4, 6, 7, n_em_cap=cap, **fkw)
    c = pg.contract_physical_jacobian(scene, out[1], g, 4, jac_geo=out[2] if cap else None)
    for table, leaf in pg._GRAD_LEAVES:
        get = lambda t: getattr(getattr(t, table) if table else t, leaf)
        atol = 1e-6 * max(float(get(r).abs().max()), 1.0)
        if table == "triangles" or leaf == "roughness":
            assert not get(d).any()  # the narrower contract
            continue
        torch.testing.assert_close(get(d), get(r), rtol=2e-4, atol=atol)
        torch.testing.assert_close(get(d), get(c), rtol=2e-4, atol=atol)


def test_physical_vjp_backward_matches_autograd_through_the_eager_tier(cuda_device):
    """Materials, sky and the black sphere light's geometry, at the JAX
    suite's gates (rtol 5e-3, atol 3e-5)."""
    scene, cam = tri_light_mixed_scene(cuda_device), P.Camera.reference(cuda_device)
    g = torch.randn((32, 64, 3), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    launches = pg.render_physical_fused.launches
    grads = []
    for render in (pg.render_physical_kernel_vjp, P.render_physical):
        leaves = [t.clone().requires_grad_() for t in pg._grad_leaves(scene)]
        img = render(pg._with_leaves(scene, leaves), cam, 32, 64, 4, 3, 7, jitter=False)
        grads.append(torch.autograd.grad(img, leaves, g, allow_unused=True))
    assert pg.render_physical_fused.launches == launches + 1
    for (_, leaf), a, b in zip(pg._GRAD_LEAVES, *grads):
        if leaf in ("albedo", "emission_color", "emission_strength", "transparency", "sky_color"):
            torch.testing.assert_close(a, b, rtol=5e-3, atol=3e-5)
        elif leaf in ("center", "radius"):  # the light is sphere 1
            torch.testing.assert_close(a[1], b[1], rtol=5e-3, atol=1e-4 * float(b[1].abs().max()))
            assert not a[0].any()


def test_physical_gradient_kernels_reject_bad_inputs(cuda_device):
    scene, cam = pdemo.cornell_spheres_scene(cuda_device), P.Camera.reference(cuda_device)
    launches = (pg.render_physical_fused.launches, pg.render_physical_bwd.launches)
    g = torch.ones((8, 8, 3), device=cuda_device)
    with pytest.raises(ValueError):
        pg.render_physical_fused(scene, P.Camera.reference("cpu"), 8, 8, 1, 1, 0)
    with pytest.raises(ValueError):
        pg.render_physical_fused(scene, cam, 8, 8, 1, pg.MAX_BOUNCES + 1, 0)
    with pytest.raises(ValueError):
        pg.render_physical_bwd(scene, cam, g.cpu(), 8, 8, 1, 1, 0)
    with pytest.raises(ValueError):
        pg.render_physical_bwd(scene, cam, g, 8, 8, 1, pg.MAX_BOUNCES + 1, 0)
    assert (pg.render_physical_fused.launches, pg.render_physical_bwd.launches) == launches
    out = pg.render_physical_fused(scene, cam, 8, 8, 1, pg.MAX_BOUNCES, 0)
    assert torch.equal(out[0], rp.render_physical_kernel(scene, cam, 8, 8, 1, pg.MAX_BOUNCES, 0))
