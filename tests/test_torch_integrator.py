"""PyTorch port: the eager integrator against the JAX package's
``render_radiance``, at the sizes and under the tolerance of
``tests/test_pallas.py``.

Tolerance: a 0.999-quantile of |delta| < 1e-4 and a mean |delta| < 1e-5.
The two frameworks may round a float32 rsqrt differently, so a chaotic path
can now and then flip at a silhouette; everything else matches to float32
rounding (in practice, nearly every pixel bit for bit).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.models import integrator as jint
from path_tracer_c_tpu.scene import demo as jdemo
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.models import integrator as pint
from path_tracer_c_tpu_torch.ops import rng as prng
from path_tracer_c_tpu_torch.scene import demo as pdemo

torch.set_num_threads(1)


def assert_close(jax_img, torch_img):
    a = np.asarray(jax_img)
    b = torch_img.numpy()
    assert a.shape == b.shape and b.dtype == np.float32
    err = np.abs(a - b)
    assert np.quantile(err, 0.999) < 1e-4, np.quantile(err, 0.999)
    assert err.mean() < 1e-5, err.mean()


# (scene, h, w, spp, bounces, seed, jitter, sample_offset): the sizes of
# tests/test_pallas.py, plus jitter and a sample offset.
CASES = [
    ("diffuse_sphere_scene", 16, 128, 2, 2, 3, False, 0),
    ("demo_scene", 16, 128, 2, 4, 11, False, 0),
    ("cornell_spheres_scene", 16, 128, 2, 3, 5, False, 0),
    ("demo_scene", 16, 128, 2, 3, 21, True, 5),
]


@pytest.mark.parametrize("name, h, w, spp, bounces, seed, jitter, offset", CASES)
def test_render_radiance_matches_jax(name, h, w, spp, bounces, seed, jitter, offset):
    j = jint.render_radiance(
        getattr(jdemo, name)(), J.Camera.reference(), h, w, spp, bounces,
        jnp.uint32(seed), jitter=jitter, sample_offset=offset,
    )
    p = pint.render_radiance(
        getattr(pdemo, name)("cpu"), P.Camera.reference("cpu"), h, w, spp,
        bounces, seed, jitter=jitter, sample_offset=offset,
    )
    assert_close(j, p)


def test_trace_paths_stream_and_radiance():
    """trace_paths consumes exactly 3 draws per bounce and returns the JAX
    radiance for the same rays and states."""
    jscene, pscene = jdemo.demo_scene(), pdemo.demo_scene("cpu")
    o, d = P.primary_rays(P.Camera.reference("cpu"), 8, 16)
    st = prng.seed_state(torch.arange(128), 0, 4)
    rad, st_out = pint.trace_paths(pscene, o, d, st, 3)
    expect = st
    for _ in range(3 * 4):
        expect, _ = prng.pcg_next(expect)
    assert torch.equal(st_out, expect)
    jrad, _ = jint.trace_paths(jscene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                               jnp.asarray(st.numpy().astype(np.uint32)), 3)
    assert_close(jrad, rad)


def test_sample_offset_splits_sum():
    """Two sample ranges average to the unsplit render (the contract row and
    sample splitting will rely on)."""
    scene, cam = pdemo.diffuse_sphere_scene("cpu"), P.Camera.reference("cpu")
    full = pint.render_radiance(scene, cam, 8, 16, 4, 2, 9)
    a = pint.render_radiance(scene, cam, 8, 16, 2, 2, 9)
    b = pint.render_radiance(scene, cam, 8, 16, 2, 2, 9, sample_offset=2)
    torch.testing.assert_close((a + b) / 2, full, rtol=0, atol=1e-6)


def test_render_image_u8_matches_jax():
    x = np.random.default_rng(8).uniform(-0.5, 1.5, size=(16, 24, 3)).astype(np.float32)
    x[0, :4, 0] = [0.5 / 255, 1.5 / 255, 2.5 / 255, 1e30]
    j = np.asarray(jint.render_image_u8(jnp.asarray(x)))
    p = pint.render_image_u8(torch.from_numpy(x))
    assert p.dtype == torch.uint8
    np.testing.assert_array_equal(p.numpy(), j)


@pytest.mark.parametrize("name, h, w, spp, bounces, seed, jitter, offset", [
    ("demo_scene", 16, 32, 2, 3, 5, False, 0),
    ("cornell_spheres_scene", 16, 32, 2, 3, 9, True, 3),
])
def test_cpu_variant_matches_jax(name, h, w, spp, bounces, seed, jitter, offset):
    """The reference's CPU tier (biased cube sampler, half roughness, IOR
    1.5, per-sample clamp) against the JAX package's ``variant="cpu"``."""
    j = jint.render_radiance(
        getattr(jdemo, name)(), J.Camera.reference(), h, w, spp, bounces,
        jnp.uint32(seed), jitter=jitter, sample_offset=offset, variant="cpu")
    t = pint.render_radiance(
        getattr(pdemo, name)("cpu"), P.Camera.reference("cpu"), h, w, spp, bounces, seed,
        jitter=jitter, sample_offset=offset, variant="cpu")
    assert_close(j, t)
    assert float(t.max()) <= 1.0 and float(t.min()) >= 0.0
    gpu = pint.render_radiance(getattr(pdemo, name)("cpu"), P.Camera.reference("cpu"), h, w,
                               spp, bounces, seed, jitter=jitter, sample_offset=offset)
    assert not torch.equal(gpu, t)
    with pytest.raises(ValueError):
        pint.render_radiance(pdemo.demo_scene("cpu"), P.Camera.reference("cpu"), 2, 2, 1, 1, 0,
                             variant="tpu")


def test_remat_gradients_equal_without():
    """``remat=True`` recomputes each sample in backward: the image and the
    gradient of every material leaf and the sky are those without it."""
    from path_tracer_c_tpu_torch.ops.render_grad import _grad_leaves, _with_leaves

    scene, cam = pdemo.demo_scene("cpu"), P.Camera.reference("cpu")
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 32, 3)).astype(np.float32))
    out = {}
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in _grad_leaves(scene)]
        img = pint.render_radiance(_with_leaves(scene, leaves), cam, 16, 32, 3, 3, 7,
                                   jitter=True, remat=remat)
        out[remat] = (img.detach(),) + torch.autograd.grad(img, leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))
    assert any(bool(x.any()) for x in out[True][1:])
