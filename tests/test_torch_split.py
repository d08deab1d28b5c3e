"""PyTorch port: the split tier (the reference shader's two-branch
estimator) against the JAX package's ``render_split`` and the scalar oracle
``tests/reference_tracer.render_split``, at ``tests/test_split.py``'s
tolerances: rtol 2e-4 / atol 2e-5 against the oracle, rtol 1e-5 / atol 1e-6
where the tree is a deterministic chain and the split equals single-path
selection. Against the JAX package the same tolerance as against the oracle
(the two frameworks may round a float32 rsqrt differently). Scenes are built
with the JAX package's SceneBuilder and carried over with ``scene_from_arrays``.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.models.split import SPLIT_SALT as J_SALT
from path_tracer_c_tpu.models.split import render_split as j_render_split
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.models.integrator import render_radiance
from path_tracer_c_tpu_torch.models.split import (MAX_BOUNCES, SPLIT_SALT, render_split,
                                                  trace_paths_split)
from path_tracer_c_tpu_torch.scene.io import scene_from_arrays

import reference_tracer as ref

torch.set_num_threads(1)

JCAM, PCAM = J.Camera.reference(), P.Camera.reference("cpu")


def arrays(x):
    if dataclasses.is_dataclass(x):
        return {f.name: arrays(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def carry(jscene):
    return scene_from_arrays(arrays(jscene), "cpu")


def split_scene(transparency=0.5, roughness=0.15):
    """tests/test_split.py's scene."""
    b = J.SceneBuilder(sky_color=(0.55, 0.7, 0.9))
    semi = b.add_material(albedo=(0.9, 0.85, 0.8), roughness=roughness,
                          transparency=transparency, refractive_index=1.4)
    diffuse = b.add_material(albedo=(0.6, 0.3, 0.2), roughness=1.0)
    light = b.add_material(albedo=(1.0, 1.0, 1.0), emission_color=(1.0, 0.9, 0.7),
                           emission_strength=3.0)
    b.add_sphere(center=(0.0, 0.0, 4.0), radius=1.2, material=semi)
    b.add_sphere(center=(2.0, 1.0, 6.0), radius=0.8, material=light)
    b.add_triangle(v0=(-30.0, -1.5, -10.0), v1=(30.0, -1.5, -10.0), v2=(0.0, -1.5, 60.0),
                   material=diffuse)
    return b.build()


def test_salt_is_the_jax_packages():
    assert SPLIT_SALT == J_SALT


def test_split_matches_scalar_oracle():
    jscene = split_scene()
    h, w, spp, bounces, seed = 5, 6, 2, 3, 11
    got = render_split(carry(jscene), PCAM, h, w, spp, bounces, seed)
    want = ref.render_split(jscene, h, w, spp, bounces, seed)
    assert got.shape == (h, w, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("transparency, roughness, bounces, offset", [
    (0.5, 0.15, 3, 0), (0.3, 0.4, 4, 2), (1.0, 0.0, 2, 0),
])
def test_split_matches_jax(transparency, roughness, bounces, offset):
    jscene = split_scene(transparency, roughness)
    h, w, spp, seed = 8, 10, 2, 7
    want = np.asarray(j_render_split(jscene, JCAM, h, w, spp, bounces, jnp.uint32(seed),
                                     sample_offset=offset))
    got = render_split(carry(jscene), PCAM, h, w, spp, bounces, seed, sample_offset=offset)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_split_equals_single_path_when_deterministic():
    """roughness 0 and t in {0, 1}: the tree is a chain, no random number
    reaches the radiance, and split equals single-path selection."""
    b = P.SceneBuilder(sky_color=(0.3, 0.5, 0.8))
    mirror = b.add_material(albedo=(0.9, 0.9, 0.9), roughness=0.0)
    glass = b.add_material(albedo=(0.95, 0.95, 0.99), roughness=0.0, transparency=1.0,
                           refractive_index=1.5)
    b.add_sphere(center=(-0.8, 0.0, 4.0), radius=1.0, material=mirror)
    b.add_sphere(center=(1.3, 0.2, 5.0), radius=1.0, material=glass)
    scene = b.build("cpu")
    h, w, spp, bounces = 6, 8, 1, 4
    split = render_split(scene, PCAM, h, w, spp, bounces, 3)
    single = render_radiance(scene, PCAM, h, w, spp, bounces, 3)
    np.testing.assert_allclose(split.numpy(), single.numpy(), rtol=1e-5, atol=1e-6)


def test_split_bounce_budget_guard():
    scene = carry(split_scene())
    with pytest.raises(ValueError, match="max_bounces > 10"):
        render_split(scene, PCAM, 4, 4, 1, MAX_BOUNCES + 1, 0)
    o, d = P.primary_rays(PCAM, 2, 2)
    with pytest.raises(ValueError, match="max_bounces > 10"):
        trace_paths_split(scene, o, d, torch.zeros(4, dtype=torch.int64), MAX_BOUNCES + 1)


def test_levels_double_and_fold_per_camera_ray():
    """Level b holds N * 2^b rays; the radiance is one row per camera ray,
    and sample ranges sum to the whole."""
    scene = carry(split_scene())
    whole = render_split(scene, PCAM, 4, 6, 4, 3, 9)
    a = render_split(scene, PCAM, 4, 6, 2, 3, 9)
    b = render_split(scene, PCAM, 4, 6, 2, 3, 9, sample_offset=2)
    np.testing.assert_allclose(((a + b) / 2).numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)
