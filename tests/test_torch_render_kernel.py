"""PyTorch port: the forward render kernel's plain twin against the JAX
package's Pallas kernel (interpret mode on the CPU), and the wrapper's
device and input rules. The CUDA kernel itself is tested in
test_torch_cuda.py, which runs without JAX on a machine with a card.

Tolerance (tests/test_pallas.py's): a 0.999-quantile of |delta| < 1e-4 and
a mean |delta| < 1e-5. XLA and PyTorch may round a float32 rsqrt
differently, and a chaotic path can then flip at a silhouette.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.ops.pallas_kernels import render_pallas
from path_tracer_c_tpu.scene import demo as jdemo
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.scene import demo as pdemo
from path_tracer_c_tpu_torch.utils import tracing

torch.set_num_threads(1)


def assert_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b)
    assert np.quantile(err, 0.999) < 1e-4, np.quantile(err, 0.999)
    assert err.mean() < 1e-5, err.mean()


@pytest.mark.parametrize("name, bounces, seed, jitter, offset", [
    ("demo_scene", 4, 11, True, 3),
    ("cornell_spheres_scene", 3, 5, False, 0),
    ("glossy_scene", 4, 2, True, 64),
])
def test_twin_matches_pallas_interpret(name, bounces, seed, jitter, offset):
    h, w, spp = 16, 128, 2
    j = render_pallas(
        getattr(jdemo, name)(), J.Camera.reference(), h, w, spp, bounces,
        jnp.uint32(seed), sample_offset=offset, tile=(8, 128),
        interpret=True, jitter=jitter,
    )
    p = rk.render_kernel_reference(
        getattr(pdemo, name)("cpu"), P.Camera.reference("cpu"), h, w, spp,
        bounces, seed, sample_offset=offset, jitter=jitter,
    )
    assert p.shape == (h, w, 3) and p.dtype == torch.float32
    assert_close(j, p)


def test_twin_ragged_size_matches_core():
    """No divisibility rule: a 20x36 image against the JAX core path (which
    has none either)."""
    j = J.render_radiance(jdemo.demo_scene(), J.Camera.reference(), 20, 36, 2, 3,
                          jnp.uint32(4), jitter=True)
    p = rk.render_kernel_reference(pdemo.demo_scene("cpu"), P.Camera.reference("cpu"),
                                   20, 36, 2, 3, 4, jitter=True)
    assert_close(j, p)


def test_cpu_tensors_take_the_twin():
    scene, cam = pdemo.demo_scene("cpu"), P.Camera.reference("cpu")
    launches = tracing.counters()
    a = rk.render_kernel(scene, cam, 12, 20, 2, 3, 6, sample_offset=1, jitter=True)
    b = rk.render_kernel_reference(scene, cam, 12, 20, 2, 3, 6, sample_offset=1, jitter=True)
    assert torch.equal(a, b)
    assert (tracing.counters() - launches)["launch.render_fwd"] == 0  # no card here


def test_empty_triangle_table():
    """A scene with no triangle slots renders like one with an inactive
    triangle."""
    b = P.SceneBuilder(sky_color=(0.3, 0.4, 0.5))
    m = b.add_material(albedo=(0.9, 0.5, 0.2), roughness=0.5)
    b.add_sphere(center=(0.0, 0.0, 3.0), radius=1.0, material=m)
    padded = b.build("cpu")
    tris = padded.triangles
    assert tris.active.tolist() == [False]
    empty = dataclasses.replace(padded, triangles=dataclasses.replace(
        tris, **{f.name: getattr(tris, f.name)[:0] for f in dataclasses.fields(tris)}))
    assert empty.num_triangles == 0
    cam = P.Camera.reference("cpu")
    assert torch.equal(rk.render_kernel(empty, cam, 8, 12, 2, 2, 1),
                       rk.render_kernel(padded, cam, 8, 12, 2, 2, 1))


def test_wrapper_rejects_bad_inputs():
    scene, cam = pdemo.demo_scene("cpu"), P.Camera.reference("cpu")
    with pytest.raises(TypeError):
        bad = dataclasses.replace(scene, sky_color=scene.sky_color.double())
        rk.render_kernel(bad, cam, 8, 8, 1, 1, 0)
    with pytest.raises(ValueError):
        rk.render_kernel(scene, cam, 8, 8, 1, 1, 2**32)
    with pytest.raises(ValueError):
        rk.render_kernel(scene, cam, 8, 8, 0, 1, 0)
    with pytest.raises(ValueError):
        rk.render_kernel(pdemo.demo_scene("meta"), P.Camera.reference("meta"), 8, 8, 1, 1, 0)
    with pytest.raises(ValueError):
        rk.render_kernel(scene, P.Camera.reference("meta"), 8, 8, 1, 1, 0)
