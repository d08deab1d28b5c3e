"""PyTorch port: ``render_physical_kernel_vjp`` (``ops/render_physical_grad.py``;
on the CPU the fused twin and its contraction) against ``torch.autograd``
through the eager physical tier and against the JAX package's
``render_physical_pallas_vjp``, the contracts that are zero on both sides,
the cap warnings, and the physical engines of ``grad/diff.py``.

Gates are the JAX suite's (tests/test_pallas_physical.py): materials and sky
on the flip-free scenes rtol 5e-3, atol 3e-5; emitter geometry on scenes
whose lights are black, where the light sample's chain is the whole
gradient, rtol 5e-3 with an absolute floor of 1e-4 of the largest entry.
"""

import dataclasses
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from path_tracer_c_tpu.grad import diff as jdiff
from path_tracer_c_tpu.ops import pallas_physical as jpp
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.grad import diff as pdiff
from path_tracer_c_tpu_torch.models.physical import render_physical
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
import torch_physical_scenes as S
from torch_physical_scenes import JCAM, PCAM

torch.set_num_threads(1)

GEOMETRY = (("spheres", "center"), ("spheres", "radius"),
            ("triangles", "v0"), ("triangles", "v1"), ("triangles", "v2"))
FLOAT_LEAVES = S.GRAD_LEAVES + GEOMETRY + (
    ("materials", "roughness"), ("materials", "metallicity"), ("materials", "refractive_index"))


def cotangent(h, w, seed):
    return np.random.default_rng(seed).standard_normal((h, w, 3)).astype(np.float32)


def torch_vjp(render, pscene, g, *args, **kw):
    """Cotangents of every float leaf for the image cotangent ``g``, as a
    dict; None where the render gives the leaf no gradient."""
    leaves = [t.clone().requires_grad_() for t in
              (getattr(getattr(pscene, tb) if tb else pscene, nm) for tb, nm in FLOAT_LEAVES)]
    live = pg.replace_leaves(pscene, [(tb, nm, t) for (tb, nm), t in zip(FLOAT_LEAVES, leaves)])
    img = render(live, PCAM, *args, **kw)
    grads = torch.autograd.grad(img, leaves, torch.tensor(g), allow_unused=True)
    return {nm: (None if x is None else x.numpy()) for (_, nm), x in zip(FLOAT_LEAVES, grads)}, img


def jax_vjp(render, jscene, g, *args, **kw):
    h, w, spp, bounces, seed = args
    _, vjp = jax.vjp(lambda sc: render(sc, JCAM, h, w, spp, bounces, jnp.uint32(seed), **kw), jscene)
    d = vjp(jnp.asarray(g))[0]
    return {nm: S.leaf(d, tb, nm) for tb, nm in FLOAT_LEAVES}


def assert_close(a, b, names, rtol, atol=0.0, floor=0.0, what=""):
    for nm in names:
        tol = atol + floor * max(np.abs(b[nm]).max(), 1e-30)
        np.testing.assert_allclose(a[nm], b[nm], rtol=rtol, atol=tol, err_msg=f"{nm} {what}")


MATERIAL = [nm for _, nm in S.GRAD_LEAVES]


@pytest.mark.parametrize("jitter, bounces, seed", [(True, 3, 3), (False, 2, 7)])
def test_vjp_materials_match_autograd_and_jax(jitter, bounces, seed):
    jscene = S.cornell_triangles_scene()
    pscene = S.carry(jscene)
    args, g = (8, 128, 8, bounces, seed), cotangent(8, 128, 0)
    fast, img = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, jitter=jitter)
    eager, _ = torch_vjp(render_physical, pscene, g, *args, jitter=jitter)
    jfast = jax_vjp(jpp.render_physical_pallas_vjp, jscene, g, *args, jitter=jitter)
    assert torch.equal(img.detach(), rp.render_physical_kernel(pscene, PCAM, *args, jitter=jitter))
    assert_close(fast, eager, MATERIAL, rtol=5e-3, atol=3e-5, what="vs autograd")
    # XLA and PyTorch round a few operations differently, so between the
    # packages a path may flip where within one it does not: one sample's
    # worth, allowed for as 1e-3 of the leaf's largest entry (the JAX suite
    # allows 3e-2 where its own two compilations flip).
    assert_close(fast, jfast, MATERIAL, rtol=5e-3, atol=3e-5, floor=1e-3, what="vs JAX")
    # non-emitter geometry: nothing from the kernel, something from autograd
    for tb, nm in GEOMETRY[:2]:
        em = rp.live_emitter_mask(pscene)
        assert not fast[nm][~em].any() and not jfast[nm][~em].any()
        assert np.abs(eager[nm][~em]).max() > 0


def test_vjp_sphere_geometry_on_the_nee_chain():
    jscene = S.nee_light_scene(0.0)
    pscene = S.carry(jscene)
    args, g = (16, 128, 4, 3, 5), cotangent(16, 128, 5)
    fast, _ = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, jitter=False)
    eager, _ = torch_vjp(render_physical, pscene, g, *args, jitter=False)
    jfast = jax_vjp(jpp.render_physical_pallas_vjp, jscene, g, *args, jitter=False)
    assert np.abs(eager["center"][1]).max() > 1e-6
    for other, what in ((eager, "vs autograd"), (jfast, "vs JAX")):
        for nm in ("center", "radius"):
            np.testing.assert_allclose(fast[nm][1], other[nm][1], rtol=5e-3,
                                       atol=1e-4 * np.abs(other[nm][1]).max(), err_msg=f"{nm} {what}")
    assert not fast["center"][0].any() and not fast["radius"][0].any()


def test_vjp_tri_nee_pool_factor_and_vertex_geometry():
    """Under tri_nee the weight of a sphere pick carries the whole pool's
    size (3 here): a chain that took the sphere count would be off by 3.
    The triangle lights' vertices through their own chain."""
    jscene = S.tri_black_lights_scene()
    pscene = S.carry(jscene)
    args, g = (16, 128, 4, 3, 5), cotangent(16, 128, 6)
    fast, _ = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, jitter=False, tri_nee=True)
    eager, _ = torch_vjp(render_physical, pscene, g, *args, jitter=False, tri_nee=True)
    jfast = jax_vjp(jpp.render_physical_pallas_vjp, jscene, g, *args, jitter=False, tri_nee=True)
    assert np.abs(eager["center"][0]).max() > 1e-6 and np.abs(eager["v0"][2:]).max() > 1e-6
    for other, what in ((eager, "vs autograd"), (jfast, "vs JAX")):
        for nm in ("center", "radius"):
            np.testing.assert_allclose(fast[nm][0], other[nm][0], rtol=5e-3,
                                       atol=1e-4 * np.abs(other[nm][0]).max(), err_msg=f"{nm} {what}")
        den = max(np.abs(other[nm][2:]).max() for nm in ("v0", "v1", "v2"))
        for nm in ("v0", "v1", "v2"):  # the lamp triangles; the ground's are zero by contract
            np.testing.assert_allclose(fast[nm][2:], other[nm][2:], rtol=5e-3, atol=1e-4 * den,
                                       err_msg=f"{nm} {what}")
    assert not fast["v0"][:2].any() and not jfast["v0"][:2].any()


def test_vjp_rough_grad_matches_the_eager_score_function():
    jscene = S.lobe_scene()
    pscene = S.carry(jscene)
    args, g = (16, 128, 4, 3, 5), cotangent(16, 128, 7)
    fast, img = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, jitter=False, rough_grad=True)
    eager, _ = torch_vjp(render_physical, pscene, g, *args, jitter=False, rough_grad=True)
    jfast = jax_vjp(jpp.render_physical_pallas_vjp, jscene, g, *args, jitter=False, rough_grad=True)
    assert np.abs(eager["roughness"]).max() > 1e-6
    names = ["roughness", "albedo", "transparency", "emission_strength", "emission_color"]
    assert_close(fast, eager, names, rtol=0.0, floor=5e-3, what="vs autograd")
    assert_close(fast, jfast, names, rtol=0.0, floor=5e-3, what="vs JAX")
    # the image is the forward kernel's; without rough_grad roughness gets nothing
    assert torch.equal(img.detach(), rp.render_physical_kernel(pscene, PCAM, *args, jitter=False))
    plain, _ = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, jitter=False)
    assert plain["roughness"] is None
    jplain = jax_vjp(jpp.render_physical_pallas_vjp, jscene, g, *args, jitter=False)
    assert not jplain["roughness"].any()
    for nm in MATERIAL:  # the same planes, contracted beside three more a material
        np.testing.assert_allclose(plain[nm], fast[nm], rtol=1e-5, atol=1e-6)


def test_vjp_all_flags_compose():
    """geom, tri_nee and rough_grad in one pass against autograd through
    the eager tier, each family within 1e-2 of its largest entry (the JAX
    suite's gate for the same composition)."""
    pscene = S.carry(S.tri_black_lights_scene(ground_roughness=0.6))
    args, g = (16, 128, 4, 3, 5), cotangent(16, 128, 8)
    kw = dict(jitter=False, tri_nee=True, rough_grad=True)
    fast, _ = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, geom=True, **kw)
    eager, _ = torch_vjp(render_physical, pscene, g, *args, **kw)
    for nm, rows in (("roughness", slice(None)), ("albedo", slice(None)), ("center", slice(None)),
                     ("radius", slice(None)), ("v0", slice(2, None)), ("v1", slice(2, None)),
                     ("v2", slice(2, None))):
        a, c = fast[nm][rows], eager[nm][rows]
        assert np.abs(c).max() > 1e-10, nm
        assert np.abs(a - c).max() / np.abs(c).max() < 1e-2, (nm, a, c)


def test_zero_contracts_in_the_port_and_in_jax():
    """Metallicity, refractive index and the camera get nothing from the
    fused path on either side, although autograd through the eager tier
    gives the camera something: the physical tier varies with the primary
    ray."""
    jscene = S.nee_light_scene(0.8)
    pscene = S.carry(jscene)
    args, g = (8, 128, 2, 2, 3), np.ones((8, 128, 3), np.float32)
    fast, _ = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, jitter=False)
    jfast = jax_vjp(jpp.render_physical_pallas_vjp, jscene, g, *args, jitter=False)
    for nm in ("metallicity", "refractive_index", "roughness"):
        assert fast[nm] is None and not jfast[nm].any()

    def camera_grads(render, **kw):
        cam = P.Camera(**{f.name: getattr(PCAM, f.name).clone().requires_grad_()
                          for f in dataclasses.fields(PCAM)})
        albedo = pscene.materials.albedo.clone().requires_grad_()
        live = pg.replace_leaves(pscene, [("materials", "albedo", albedo)])
        render(live, cam, *args, jitter=False, **kw).sum().backward()
        return [getattr(cam, f.name).grad for f in dataclasses.fields(cam)]

    assert all(x is None for x in camera_grads(pg.render_physical_kernel_vjp))
    assert max(float(x.abs().max()) for x in camera_grads(render_physical)) > 1e-8
    h, w, spp, bounces, seed = args
    jgrad = jax.grad(lambda c: jnp.sum(jpp.render_physical_pallas_vjp(
        jscene, c, h, w, spp, bounces, jnp.uint32(seed), jitter=False)))(JCAM)
    assert not np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(jgrad)]).any()


def test_emitter_cap_warns_and_tracks_the_first_ordinals():
    jscene = S.many_lights_scene(10)
    pscene = S.carry(jscene)
    args, g = (8, 128, 2, 2, 43), np.ones((8, 128, 3), np.float32)
    with pytest.warns(UserWarning, match="n_em_cap=8"):
        capped8, _ = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, jitter=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        full, _ = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, jitter=False, n_em_cap=10)
    with pytest.warns(UserWarning, match="n_em_cap=4"):
        capped, _ = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, jitter=False, n_em_cap=4)
    np.testing.assert_array_equal(capped["center"][:4], full["center"][:4])
    assert np.abs(full["center"][4:]).min(axis=0).max() > 0 and not capped["center"][4:].any()
    assert not capped8["center"][8:].any() and capped8["center"][7].any()
    # the JAX side: the same rows from its capped planes (its warning needs a
    # concrete scene, which a traced gradient does not have)
    jcapped = jax_vjp(jpp.render_physical_pallas_vjp, jscene, g, *args, jitter=False, n_em_cap=4)
    np.testing.assert_allclose(capped["center"], jcapped["center"], rtol=5e-3, atol=1e-6)
    with pytest.raises(ValueError, match="n_em_cap=4"):
        pg._check_emitter_cap(pscene, 4, raise_=True)
    assert pg._check_emitter_cap(pscene, 10) == 10


def test_tri_cap_warns_and_geom_off_gives_nothing():
    pscene = S.carry(S.tri_black_lights_scene())  # 2 live triangle emitters
    args, g = (8, 128, 2, 2, 3), np.ones((8, 128, 3), np.float32)
    with pytest.warns(UserWarning, match="tri_em_cap=1"):
        one, _ = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, jitter=False,
                           tri_nee=True, tri_em_cap=1)
    assert np.isfinite(one["v0"]).all() and one["v0"][2].any() and not one["v0"][3].any()
    off, _ = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, jitter=False,
                       tri_nee=True, geom=False)
    no_tri, _ = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, jitter=False)
    for d in (off, no_tri):
        assert all(d[nm] is None for nm in ("v0", "v1", "v2"))
    assert off["center"] is None and no_tri["center"].any()
    # the caps are clamped to the live counts: asking for more changes nothing
    two, _ = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, jitter=False, tri_nee=True)
    many, _ = torch_vjp(pg.render_physical_kernel_vjp, pscene, g, *args, jitter=False, tri_nee=True,
                        n_em_cap=5, tri_em_cap=7)
    for nm in ("center", "v0", "v2"):
        np.testing.assert_array_equal(two[nm], many[nm])


def test_without_a_gradient_the_vjp_is_the_forward_kernel(monkeypatch):
    pscene = S.carry(S.tri_light_mixed_scene())
    monkeypatch.setattr(pg, "render_physical_fused", None)  # must not be reached
    img = pg.render_physical_kernel_vjp(pscene, PCAM, 8, 16, 2, 2, 3, tri_nee=True, sample_offset=2)
    assert torch.equal(img, rp.render_physical_kernel(pscene, PCAM, 8, 16, 2, 2, 3, tri_nee=True,
                                                      sample_offset=2))
    with torch.no_grad():
        live = pg.replace_leaves(pscene, [("materials", "albedo",
                                           pscene.materials.albedo.clone().requires_grad_())])
        assert torch.equal(pg.render_physical_kernel_vjp(live, PCAM, 8, 16, 2, 2, 3),
                           rp.render_physical_kernel(pscene, PCAM, 8, 16, 2, 2, 3))


# -- grad/diff.py: the physical engines -------------------------------------------------


def test_render_loss_physical_engines_match_jax():
    jscene = S.cornell_triangles_scene()
    pscene = S.carry(jscene)
    target = np.zeros((8, 16, 3), np.float32)
    args = (8, 16, 4, 2)
    for engine in ("physical", "physical_pallas"):
        for rough_grad in (False, True):
            want = float(jdiff.render_loss(jscene, jnp.asarray(target), JCAM, *args, jnp.uint32(5),
                                           engine=engine, rough_grad=rough_grad))
            got = float(pdiff.render_loss(pscene, torch.tensor(target), PCAM, *args, 5,
                                          engine=engine, rough_grad=rough_grad))
            assert got == pytest.approx(want, rel=1e-4), (engine, rough_grad)
    assert float(pdiff.render_loss(pscene, torch.tensor(target), PCAM, *args, 5, engine="physical_core")) \
        == float(pdiff.render_loss(pscene, torch.tensor(target), PCAM, *args, 5, engine="physical"))
    for engine in ("cuda", "core", "auto", "pallas"):
        with pytest.raises(ValueError, match="rough_grad requires a physical engine"):
            pdiff.render_loss(pscene, torch.tensor(target), PCAM, *args, 5, engine=engine, rough_grad=True)
        with pytest.raises(ValueError, match="rough_grad"):
            jdiff.render_loss(jscene, jnp.asarray(target), JCAM, *args, jnp.uint32(5),
                              engine=engine, rough_grad=True)


def test_loss_and_grad_physical_engines_agree():
    """The kernel engine (geom=False: a material objective) against autograd
    through the eager tier: the five material leaves at rtol 5e-3, atol
    1e-7; geometry zero from the kernel engine."""
    pscene = S.carry(S.cornell_triangles_scene())
    target = render_physical(pscene, PCAM, 8, 32, 4, 3, 99, jitter=False)
    la, da = pdiff.loss_and_grad(pscene, target, PCAM, 8, 32, 4, 3, 5, engine="physical_pallas")
    lb, db = pdiff.loss_and_grad(pscene, target, PCAM, 8, 32, 4, 3, 5, engine="physical")
    assert float(la) == pytest.approx(float(lb), rel=1e-5)
    for tb, nm in S.GRAD_LEAVES:
        np.testing.assert_allclose(S.leaf(da, tb, nm), S.leaf(db, tb, nm), rtol=5e-3, atol=1e-7)
    assert not da.spheres.center.any() and db.spheres.center.any()
    assert not da.materials.roughness.any() and not da.materials.refractive_index.any()
    assert not pscene.materials.albedo.requires_grad  # the caller's scene is untouched
