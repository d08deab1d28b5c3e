"""PyTorch port: the plain twin of the physical tier's two-pass backward
kernel (``ops/render_physical_grad.py`` ``render_physical_bwd_reference``)
against the JAX package's ``render_physical_pallas_bwd`` and against the
fused twin's contraction, and the contraction and the emitter scatters
against the JAX package's on planes made with numpy.

The JAX two-pass kernel runs as its own tests run it on the CPU: with its
default, the interpreter off the TPU. Cotangents sum every pixel, sample
and bounce; they are held at the JAX suite's gate between its two schemes
(rtol 2e-4 and an absolute floor, stated at each use).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from path_tracer_c_tpu.ops import pallas_physical as jpp
from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
import torch_physical_scenes as S
from torch_physical_scenes import JCAM, PCAM

torch.set_num_threads(1)

ALL_LEAVES = pg._GRAD_LEAVES


# -- the contraction and the scatters ----------------------------------------------


@pytest.mark.parametrize("mp", [9, 12])
def test_contraction_and_scatters_match_jax(mp):
    """Planes from numpy, no kernel: rtol 1e-5 (float32 sums of 8 x 16
    pixels in two orders) with an absolute floor of 1e-5."""
    jscene = S.tri_light_mixed_scene()
    pscene = S.carry(jscene)
    r = np.random.default_rng(mp)
    h, w, spp, n_mat = 8, 16, 4, jscene.num_materials
    jac = r.standard_normal((mp * n_mat + 3, h, w)).astype(np.float32)
    jgeo = r.standard_normal((12 * 3, h, w)).astype(np.float32)  # cap 3, 1 live
    jtri = r.standard_normal((27 * 3, h, w)).astype(np.float32)  # cap 3, 2 live
    g = r.standard_normal((h, w, 3)).astype(np.float32)
    want = jpp.contract_physical_jacobian(jscene, jnp.asarray(jac), jnp.asarray(g), spp,
                                          jac_geo=jnp.asarray(jgeo), jac_tri=jnp.asarray(jtri))
    got = pg.contract_physical_jacobian(pscene, torch.tensor(jac), torch.tensor(g), spp,
                                        jac_geo=torch.tensor(jgeo), jac_tri=torch.tensor(jtri))
    for table, name in ALL_LEAVES + (("materials", "metallicity"), ("materials", "refractive_index")):
        np.testing.assert_allclose(S.leaf(got, table, name), S.leaf(want, table, name),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # the live ordinals land on their rows, the others nowhere
    assert np.flatnonzero(np.abs(S.leaf(got, "spheres", "center")).sum(1)).tolist() == [1]
    assert np.flatnonzero(np.abs(S.leaf(got, "triangles", "v0")).sum(1)).tolist() == [2, 3]
    assert (np.abs(S.leaf(got, "materials", "roughness")).sum() > 0) == (mp == 12)
    bare = pg.contract_physical_jacobian(pscene, torch.tensor(jac), torch.tensor(g), spp)
    assert not S.leaf(bare, "spheres", "center").any() and not S.leaf(bare, "triangles", "v1").any()


@pytest.mark.parametrize("active", [[1, 1, 1], [0, 1, 1], [1, 0, 1], [0, 0, 0]])
def test_scatter_follows_the_emitter_ordinals(active):
    """Ordinal k goes to the k-th *live* emitter's row; inactive emitters
    take no ordinal; ordinals from the live count on are dropped."""
    jscene = S.many_lights_scene(3)
    sph = dataclasses.replace(jscene.spheres, active=jnp.asarray(active, bool))
    jscene = dataclasses.replace(jscene, spheres=sph)
    pscene = S.carry(jscene)
    geo = np.arange(1, 17, dtype=np.float32).reshape(4, 4)
    d_c, d_r = pg._scatter_emitter_geometry(pscene, torch.tensor(geo), 4)
    want = jpp._scatter_emitter_geometry(jscene, jnp.asarray(geo), 4)
    np.testing.assert_array_equal(d_c.numpy(), np.asarray(want.center))
    np.testing.assert_array_equal(d_r.numpy(), np.asarray(want.radius))
    rows = [i for i, a in enumerate(active) if a]
    assert np.flatnonzero(d_r.numpy()).tolist() == rows
    np.testing.assert_array_equal(d_r.numpy()[rows], geo[: len(rows), 3])


# -- the two-pass oracle ---------------------------------------------------------


BWD_CASES = [
    ("cornell", 16, 128, 2, 3, 37, dict(jitter=False)),
    ("glossy", 8, 128, 2, 3, 5, {}),
    ("nee_light", 16, 128, 2, 3, 41, dict(jitter=False, n_em_cap=2)),
    ("tri_light", 8, 128, 2, 3, 7, dict(jitter=False, n_em_cap=1, tri_nee=True)),
    ("cornell_triangles", 8, 128, 2, 2, 7, dict(nee=False)),
]


@pytest.mark.parametrize("name, h, w, spp, bounces, seed, kw", BWD_CASES)
def test_bwd_twin_matches_pallas_bwd_and_the_fused_contraction(name, h, w, spp, bounces, seed, kw):
    """The two-pass twin against the JAX two-pass kernel, and against the
    fused twin's contraction: rtol 2e-4 with an absolute floor of 1e-6 of
    the leaf's scale (the JAX suite's gate between its two schemes, rtol
    2e-4 and atol 1e-6 to 1e-5). One flipped path moves a sum by a sample's
    worth, which the controlled scenes avoid; the giant walls of cornell get
    the JAX suite's allowance for that (2e-2 and 3% of the leaf's scale)."""
    jscene = S.SCENES[name]()
    pscene = S.carry(jscene)
    g = np.random.default_rng(9).standard_normal((h, w, 3)).astype(np.float32)
    want = jpp.render_physical_pallas_bwd(jscene, JCAM, jnp.asarray(g), h, w, spp, bounces,
                                          jnp.uint32(seed), tile=(8, 128), **kw)
    got = pg.render_physical_bwd_reference(pscene, PCAM, torch.tensor(g), h, w, spp, bounces,
                                           seed, **kw)
    cap = kw.get("n_em_cap", min(jscene.num_spheres, 8)) if kw.get("nee", True) else 0
    fkw = {k: v for k, v in kw.items() if k != "n_em_cap"}
    out = pg.render_physical_fused_reference(pscene, PCAM, h, w, spp, bounces, seed,
                                             n_em_cap=cap, **fkw)
    fused = pg.contract_physical_jacobian(pscene, out[1], torch.tensor(g), spp,
                                          jac_geo=out[2] if cap else None)
    loose = name == "cornell"
    for table, leaf in S.GRAD_LEAVES + (("spheres", "center"), ("spheres", "radius")):
        a, b, c = (S.leaf(t, table, leaf) for t in (got, want, fused))
        scale = max(np.abs(b).max(), 1.0)
        rtol, atol = (2e-2, 3e-2 * scale) if loose else (2e-4, 1e-6 * scale)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{leaf} vs JAX")
        np.testing.assert_allclose(a, c, rtol=2e-4, atol=1e-6 * scale, err_msg=f"{leaf} vs fused")
    # the narrower contract: no triangle vertices, no roughness
    for table, leaf in (("triangles", "v0"), ("triangles", "v1"), ("triangles", "v2"),
                        ("materials", "roughness"), ("materials", "metallicity"),
                        ("materials", "refractive_index")):
        assert not S.leaf(got, table, leaf).any() and not S.leaf(want, table, leaf).any()


def test_bwd_default_cap_and_nee_off():
    """``n_em_cap`` defaults to min(num_spheres, 8) and is 0 without NEE."""
    pscene = S.carry(S.many_lights_scene(10))
    g = torch.ones(8, 32, 3)
    d = pg.render_physical_bwd(pscene, PCAM, g, 8, 32, 2, 2, 43, jitter=False)
    moved = np.flatnonzero(np.abs(d.spheres.center.numpy()).sum(1))
    assert moved.size and moved.max() < 8
    full = pg.render_physical_bwd(pscene, PCAM, g, 8, 32, 2, 2, 43, jitter=False, n_em_cap=10)
    np.testing.assert_array_equal(full.spheres.center.numpy()[:8], d.spheres.center.numpy()[:8])
    assert np.abs(full.spheres.center.numpy()[8:]).max() > 0
    off = pg.render_physical_bwd(pscene, PCAM, g, 8, 32, 2, 2, 43, jitter=False, nee=False,
                                 n_em_cap=10)
    assert not off.spheres.center.any() and not off.spheres.radius.any()
