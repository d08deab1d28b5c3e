"""PyTorch port: the plain twins of the physical tier's two gradient kernels
(``ops/render_physical_grad.py``) against the JAX package's Pallas kernels,
the hand-derived adjoints of the light sample's weight chains, and the
wrappers' device and input rules; the two-pass kernel's twin, the backward
contraction and the emitter scatters are in
test_torch_render_physical_bwd.py. The CUDA kernels themselves are tested in test_torch_cuda.py, which
runs without JAX on a machine with a card.

The JAX side runs as its own tests run it on the CPU: the fused kernel with
``interpret=True``. Tolerances: images under the physical tolerance and
planes under the same relative to their scale (``torch_physical_scenes``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from path_tracer_c_tpu.ops import pallas_physical as jpp
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.models import physical as pphys
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
from path_tracer_c_tpu_torch.ops import rng as prng
from path_tracer_c_tpu_torch.utils import tracing
import torch_physical_scenes as S
from torch_physical_scenes import JCAM, PCAM

torch.set_num_threads(1)


def j_fused(jscene, h, w, spp, bounces, seed, **kw):
    kw = dict(kw)
    offset = kw.pop("sample_offset", 0)
    return jpp.render_physical_pallas_fused(
        jscene, JCAM, h, w, spp, bounces, jnp.uint32(seed), sample_offset=offset,
        tile=(8, 128), interpret=True, **kw)


# name, h, w, spp, bounces, seed, flags. The caps of tri_light: 1 live sphere
# emitter, 2 live triangle emitters.
FUSED_CASES = [
    ("cornell", 8, 128, 2, 3, 31, dict(jitter=False)),
    ("glossy", 16, 128, 2, 3, 31, dict(jitter=False, n_em_cap=1)),
    ("cornell_triangles", 8, 128, 2, 3, 3, dict(n_em_cap=1)),  # jitter on
    ("cornell", 8, 128, 2, 3, 5, dict(jitter=False, nee=False, n_em_cap=1)),
    ("glossy", 8, 128, 1, 3, 2, dict(jitter=False, sample_offset=64)),
    ("tri_light", 8, 128, 2, 3, 7, dict(jitter=False, tri_nee=True, n_em_cap=1, tri_em_cap=2)),
    ("tri_light", 8, 128, 2, 3, 7, dict(jitter=False, tri_nee=True, n_em_cap=0, tri_em_cap=1)),
    ("tri_light", 8, 128, 2, 3, 9, dict(tri_nee=True, n_em_cap=3, tri_em_cap=4)),  # above the live counts
    ("cornell_triangles", 8, 128, 2, 3, 5, dict(jitter=False, rough_grad=True)),
    ("tri_black_lights", 8, 128, 2, 3, 5,
     dict(jitter=False, tri_nee=True, n_em_cap=1, tri_em_cap=2, rough_grad=True)),  # all flags
]


@pytest.mark.parametrize("name, h, w, spp, bounces, seed, kw", FUSED_CASES)
def test_fused_twin_matches_pallas_interpret(name, h, w, spp, bounces, seed, kw):
    jscene = S.SCENES[name]()
    want = j_fused(jscene, h, w, spp, bounces, seed, **kw)
    got = pg.render_physical_fused_reference(S.carry(jscene), PCAM, h, w, spp, bounces, seed, **kw)
    assert len(got) == len(want) == 2 + bool(kw.get("n_em_cap")) + bool(kw.get("tri_em_cap"))
    S.assert_images_close(got[0].numpy(), want[0])
    n_mat = jscene.num_materials
    assert got[1].shape == ((12 if kw.get("rough_grad") else 9) * n_mat + 3, h, w)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        S.assert_planes_close(a.numpy(), b)


@pytest.mark.parametrize("name, kw", [
    ("cornell", {}), ("glossy", dict(jitter=False, n_em_cap=1)),
    ("tri_light", dict(tri_nee=True, n_em_cap=1, tri_em_cap=2, rough_grad=True)),
    ("cornell", dict(nee=False)), ("diffuse", dict(sample_offset=5)),
])
def test_fused_twin_image_is_the_forward_twin_s(name, kw):
    """Value for value, at a ragged size: the rounds a black albedo keeps
    alive add exact zeros, the light sample included. The planes asked for
    do not change the image or the material planes."""
    pscene = S.carry(S.SCENES[name]())
    fwd_kw = {k: v for k, v in kw.items() if k in ("jitter", "nee", "tri_nee", "sample_offset")}
    out = pg.render_physical_fused(pscene, PCAM, 12, 20, 2, 4, 6, **kw)
    assert torch.equal(out[0], rp.render_physical_kernel_reference(pscene, PCAM, 12, 20, 2, 4, 6, **fwd_kw))
    bare = pg.render_physical_fused_reference(pscene, PCAM, 12, 20, 2, 4, 6, **fwd_kw)
    assert torch.equal(out[0], bare[0])
    mp, n_mat = (12 if kw.get("rough_grad") else 9), pscene.num_materials
    planes = out[1][: mp * n_mat].reshape(n_mat, mp, 12, 20)[:, :9]
    assert torch.equal(planes, bare[1][: 9 * n_mat].reshape(n_mat, 9, 12, 20))
    assert torch.equal(out[1][mp * n_mat:], bare[1][9 * n_mat:])


@pytest.mark.parametrize("name, kw", [
    ("cornell_triangles", {}), ("glossy", dict(jitter=False)), ("tri_light", dict(tri_nee=True)),
])
def test_fused_count_rounds_against_the_eager_tier(name, kw):
    """The fused kernel's thread stops at a miss or a death only. On scenes
    without an exactly black surface in view that is the forward kernel's
    count, which the eager tier counts from its alive mask; the counter is
    returned last and does not change the image or the planes."""
    pscene = S.carry(S.SCENES[name]())
    args = (pscene, PCAM, 16, 64, 2, 4, 3)
    out = pg.render_physical_fused(*args, count_rounds=True, n_em_cap=1, **kw)
    assert len(out) == 4 and isinstance(out[-1], int)
    plain = pg.render_physical_fused(*args, n_em_cap=1, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out[:-1], plain))
    _, n_fwd = rp.render_physical_kernel(*args, count_rounds=True, **kw)
    _, n_eager = pphys.render_physical(*args, count_rounds=True, **kw)
    nominal = 16 * 64 * 2 * 5
    assert n_fwd <= out[-1] <= nominal
    if name != "tri_light":  # its lamps are black: paths that strike them go on
        assert abs(out[-1] - n_eager) <= 0.002 * nominal, (out[-1], n_eager)


def test_fused_rounds_on_a_black_surface_exceed_the_forward_kernel_s():
    pscene = S.carry(S.tri_light_mixed_scene())
    args = (pscene, PCAM, 16, 64, 2, 4, 3)
    n_fused = pg.render_physical_fused(*args, tri_nee=True, count_rounds=True)[-1]
    n_fwd = rp.render_physical_kernel(*args, tri_nee=True, count_rounds=True)[1]
    assert n_fused > n_fwd


# -- the weight chains' adjoints -------------------------------------------------


def _chain_inputs(n, seed, floors):
    """Random shadow origins, normals, draws and emitter geometry; with
    ``floors`` the first lanes sit where a guard wins: the origin on the
    centre (d^2 below its floor), inside the emitter (the clip binds), the
    first draw 0 (sin(theta) at its floor), a degenerate triangle."""
    r = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    c = f32(r.normal(size=(3, n)) * 2.0 + np.array([[0.0], [2.0], [5.0]]))
    rad = f32(r.uniform(0.1, 1.0, n))
    so = f32(r.normal(size=(3, n)))
    nrm = r.normal(size=(3, n))
    nrm = f32(nrm / np.linalg.norm(nrm, axis=0))
    v1, v2 = f32(r.uniform(size=n)), f32(r.uniform(size=n))
    tv = f32(r.normal(size=(9, n)) + np.array([0, 3, 4, 1, 3, 4, 1, 3, 6])[:, None])
    if floors:
        so[:, 0] = c[:, 0]
        rad[1] = 50.0
        v1[2] = 0.0
        tv[3:6, 3] = tv[0:3, 3]
        tv[6:9, 3] = tv[0:3, 3]
    return c, rad, so, nrm, v1, v2, tv


@pytest.mark.parametrize("floors", [False, True])
def test_cone_adjoint_matches_autograd_and_jax_vjp(floors):
    """rtol 1e-4 with an absolute floor of 1e-5 of the largest entry: the
    three differentiate one chain in other expression orders."""
    c, rad, so, nrm, v1, v2, _ = _chain_inputs(512, 0, floors)
    T = torch.tensor
    cp, sp = prng.sincos_2pi(T(v2))
    pool = T(3.0)
    got = pg.cone_w_adjoint(tuple(T(c)), T(rad), tuple(T(so)), tuple(T(nrm)), T(v1), cp, sp, pool)
    cl, rl = [T(x).requires_grad_() for x in c], T(rad).requires_grad_()
    w = pg.cone_w_chain(cl, rl, tuple(T(so)), tuple(T(nrm)), T(v1), cp, sp, pool)
    auto = torch.autograd.grad(w.sum(), cl + [rl])
    jw, vjp = jax.vjp(
        lambda cx, cy, cz, rr: jpp._cone_w_chain(cx, cy, cz, rr, *so, *nrm, v1, cp.numpy(),
                                                 sp.numpy(), jnp.float32(3.0)),
        *c, rad)
    jgrad = vjp(jnp.ones_like(jw))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
    for a, b, j in zip(got, auto, jgrad):
        assert torch.isfinite(a).all()
        atol = 1e-5 * max(float(b.abs().max()), 1.0)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=atol)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=1e-4, atol=atol)
    if floors:  # where the clip binds nothing reaches the radius
        assert float(got[3][0]) == 0.0 and float(got[3][1]) == 0.0


@pytest.mark.parametrize("floors", [False, True])
def test_tri_adjoint_matches_autograd_and_jax_vjp(floors):
    _, _, so, nrm, v1, v2, tv = _chain_inputs(512, 1, floors)
    T = torch.tensor
    pool = T(3.0)
    got = pg.tri_w_adjoint(tuple(T(tv)), tuple(T(so)), tuple(T(nrm)), T(v1), T(v2), pool)
    tl = [T(x).requires_grad_() for x in tv]
    w = pg.tri_w_chain(tl, tuple(T(so)), tuple(T(nrm)), T(v1), T(v2), pool)
    auto = torch.autograd.grad(w.sum(), tl)
    jw, vjp = jax.vjp(lambda *t: jpp._tri_w_chain(*t, *so, *nrm, v1, v2, jnp.float32(3.0)), *tv)
    jgrad = vjp(jnp.ones_like(jw))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
    keep = np.ones(512, bool)
    keep[3] = not floors  # the degenerate triangle: see below
    for a, b, j in zip(got, auto, jgrad):
        assert torch.isfinite(a).all()
        atol = 1e-5 * max(float(b.abs()[keep].max()), 1.0)
        np.testing.assert_allclose(a.numpy()[keep], b.numpy()[keep], rtol=1e-4, atol=atol)
        np.testing.assert_allclose(a.numpy()[keep], np.asarray(j)[keep], rtol=1e-4, atol=atol)
    if floors:
        # With all three vertices equal the area's floor wins: the weight
        # and the hand adjoint are exactly zero.
        assert float(w.detach()[3]) == 0.0 and all(float(a[3]) == 0.0 for a in got)


# -- the wrappers ----------------------------------------------------------------


def test_cpu_tensors_take_the_twins():
    pscene = S.carry(S.nee_light_scene())
    launches = tracing.counters()
    kw = dict(jitter=False, n_em_cap=1)
    a = pg.render_physical_fused(pscene, PCAM, 8, 12, 2, 2, 6, **kw)
    b = pg.render_physical_fused_reference(pscene, PCAM, 8, 12, 2, 2, 6, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    g = torch.ones(8, 12, 3)
    da = pg.render_physical_bwd(pscene, PCAM, g, 8, 12, 2, 2, 6, **kw)
    db = pg.render_physical_bwd_reference(pscene, PCAM, g, 8, 12, 2, 2, 6, **kw)
    assert torch.equal(da.materials.albedo, db.materials.albedo)
    assert torch.equal(da.spheres.center, db.spheres.center)
    # 0 on a machine without a card: the counts grow where a kernel launches
    grew = tracing.counters() - launches
    assert grew["launch.render_phys_fused"] == grew["launch.render_phys_bwd"] == 0
    for fn, source, line in ((pg.render_physical_fused, "render_phys_fused.cu", 1348),
                             (pg.render_physical_bwd, "render_phys_bwd.cu", 931)):
        assert (S.REPO / fn.SOURCE).name == source and (S.REPO / fn.SOURCE).exists()
        path, _, at = fn.REPLACES.partition(":")
        assert int(at) == line and "pallas_call" not in path and (S.REPO / path).exists()


def test_wrappers_reject_bad_inputs():
    scene = S.carry(S.nee_light_scene())
    g = torch.ones(8, 8, 3)
    for call in (lambda **kw: pg.render_physical_fused(scene, PCAM, 8, 8, 1, kw.pop("b", 1), 0, **kw),
                 lambda **kw: pg.render_physical_bwd(scene, PCAM, g, 8, 8, 1, kw.pop("b", 1), 0, **kw)):
        with pytest.raises(ValueError, match="cap of 31"):
            call(b=pg.MAX_BOUNCES + 1)
        with pytest.raises(ValueError):
            call(n_em_cap=-1)
    with pytest.raises(ValueError, match="requires tri_nee"):
        pg.render_physical_fused(scene, PCAM, 8, 8, 1, 1, 0, tri_em_cap=1)
    with pytest.raises(ValueError, match="g has shape"):
        pg.render_physical_bwd(scene, PCAM, torch.ones(8, 4, 3), 8, 8, 1, 1, 0)
    with pytest.raises(ValueError):
        pg.render_physical_fused(scene, PCAM, 8, 8, 1, 1, 2**32)
    meta = (P.demo.cornell_spheres_scene("meta"), P.Camera.reference("meta"))
    with pytest.raises(ValueError):
        pg.render_physical_fused(*meta, 8, 8, 1, 1, 0)
    with pytest.raises(ValueError):
        pg.render_physical_bwd(*meta, torch.ones(8, 8, 3, device="meta"), 8, 8, 1, 1, 0)
