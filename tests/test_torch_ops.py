"""PyTorch port: camera rays, intersection and shading-direction math
against the JAX package, on the same numpy-made inputs.

Tolerances: XLA's float32 rsqrt and PyTorch's (1/sqrt) may differ by an
ulp, so directions and normals agree to a few ulps (atol 1e-6 on unit
vectors); distances to 1e-5 relative. Discrete results (hit mask, winning
material, RNG state) are exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.ops import camera as jcamera, intersect as jint, sampling as jsamp
from path_tracer_c_tpu.ops import rng as jrng
from path_tracer_c_tpu.scene import demo as jdemo
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.ops import camera as pcamera, intersect as pint, sampling as psamp
from path_tracer_c_tpu_torch.ops import rng as prng
from path_tracer_c_tpu_torch.scene import demo as pdemo

torch.set_num_threads(1)

UNIT_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("jitter", [False, True])
def test_primary_rays(jitter):
    h, w = 12, 20
    jcam, pcam = J.Camera.reference(75.0), P.Camera.reference("cpu", 75.0)
    if not jitter:
        jo, jd = jcamera.primary_rays(jcam, h, w)
        po, pd = pcamera.primary_rays(pcam, h, w)
    else:
        pix = np.arange(h * w)
        jst = jrng.seed_state(jnp.asarray(pix, jnp.int32), jnp.int32(3), jnp.uint32(9))
        pst = prng.seed_state(_t(pix), 3, 9)
        jo, jd, jst = jcamera.primary_rays(jcam, h, w, jst)
        po, pd, pst = pcamera.primary_rays(pcam, h, w, pst)
        np.testing.assert_array_equal(np.asarray(jst, np.int64), pst.numpy())
    assert pd.shape == (h * w, 3) and pd.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jo), po.numpy())
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=UNIT_ATOL)
    np.testing.assert_array_equal(
        pcamera.pixel_indices(h, w, "cpu").numpy(),
        np.asarray(jcamera.pixel_indices(h, w)),
    )


def _random_rays(seed, n=4096):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-3, -0.5, -1], [3, 2, 3], size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2])  # mostly towards the objects
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("name", ["demo_scene", "glossy_scene", "cornell_spheres_scene"])
def test_trace(name):
    o, d = _random_rays(5)
    jh = jint.trace(jnp.asarray(o), jnp.asarray(d), getattr(jdemo, name)())
    ph = pint.trace(_t(o), _t(d), getattr(pdemo, name)("cpu"))
    mask = np.asarray(jh.mask)
    assert mask.mean() > 0.2
    np.testing.assert_array_equal(ph.mask.numpy(), mask)
    np.testing.assert_array_equal(ph.is_sphere.numpy()[mask], np.asarray(jh.is_sphere)[mask])
    np.testing.assert_array_equal(ph.material.numpy()[mask], np.asarray(jh.material)[mask])
    np.testing.assert_array_equal(ph.obj_idx.numpy()[mask], np.asarray(jh.obj_idx)[mask])
    assert np.isinf(ph.t.numpy()[~mask]).all()
    np.testing.assert_allclose(ph.t.numpy()[mask], np.asarray(jh.t)[mask], rtol=1e-5)
    np.testing.assert_allclose(ph.normal.numpy()[mask], np.asarray(jh.normal)[mask],
                               rtol=0, atol=1e-5)


def test_shading_directions():
    rng = np.random.default_rng(6)
    n = 4096

    def unit(a):
        return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)

    i, nrm, sph = (unit(rng.normal(size=(n, 3))) for _ in range(3))
    rough = rng.uniform(0, 1, n).astype(np.float32)
    eta = rng.choice([1 / 1.5, 1.5, 1.33], size=(n, 1)).astype(np.float32)

    np.testing.assert_allclose(
        psamp.reflect(_t(i), _t(nrm)).numpy(),
        np.asarray(jsamp.reflect(jnp.asarray(i), jnp.asarray(nrm))), atol=UNIT_ATOL)
    pd, ptir = psamp.refract(_t(i), _t(nrm), _t(eta))
    jd, jtir = jsamp.refract(jnp.asarray(i), jnp.asarray(nrm), jnp.asarray(eta))
    np.testing.assert_array_equal(ptir.numpy(), np.asarray(jtir))
    assert 0 < ptir.numpy().mean() < 1  # TIR and transmission both occur
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), atol=UNIT_ATOL)
    np.testing.assert_allclose(
        psamp.perturb_normal(_t(nrm), _t(sph), _t(rough)).numpy(),
        np.asarray(jsamp.perturb_normal(jnp.asarray(nrm), jnp.asarray(sph),
                                        jnp.asarray(rough))),
        atol=UNIT_ATOL)
