"""Scenes and helpers shared by the PyTorch port's physical-gradient tests
(test_torch_render_physical_grad.py, test_torch_physical_vjp.py,
test_torch_physical_fit.py). Scenes are built once with the JAX package's
SceneBuilder and carried over with ``scene_from_arrays``. The controlled
scenes are those of tests/test_pallas_physical.py: triangle walls in place
of giant spheres, so that no float32 cancellation flips a path between two
compilations of the estimator."""

import dataclasses
from pathlib import Path

import numpy as np
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.scene import demo as jdemo
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.scene.io import scene_from_arrays

REPO = Path(__file__).resolve().parents[1]
JCAM = J.Camera.reference()
PCAM = P.Camera.reference("cpu")

GRAD_LEAVES = (
    ("materials", "albedo"), ("materials", "emission_color"),
    ("materials", "emission_strength"), ("materials", "transparency"),
    (None, "sky_color"),
)


def arrays(x):
    """A JAX dataclass tree as nested numpy dicts under its field names."""
    if dataclasses.is_dataclass(x):
        return {f.name: arrays(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def carry(jscene):
    return scene_from_arrays(arrays(jscene), "cpu")


def leaf(tree, table, name):
    """A leaf of a scene-shaped tree of either package, as numpy."""
    t = getattr(getattr(tree, table) if table else tree, name)
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def ground(b, y=-1.0, half=50.0, **material):
    m = b.add_material(**material)
    b.add_triangle(v0=(-half, y, -half), v1=(half, y, -half), v2=(half, y, half), material=m)
    b.add_triangle(v0=(-half, y, -half), v1=(-half, y, half), v2=(half, y, half), material=m)
    return m


def cornell_triangles_scene():
    """A Cornell box with triangle walls: diffuse walls, an emissive sphere,
    a mirror and a glass sphere (NEE, single counting, refraction, total
    internal reflection)."""
    b = J.SceneBuilder(sky_color=(0.0, 0.0, 0.0))
    white = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=1.0)
    red = b.add_material(albedo=(0.65, 0.05, 0.05), roughness=1.0)
    green = b.add_material(albedo=(0.12, 0.45, 0.15), roughness=1.0)
    light = b.add_material(albedo=(1.0, 1.0, 1.0), emission_color=(1.0, 0.9, 0.7),
                           emission_strength=15.0)
    mirror = b.add_material(albedo=(0.95, 0.95, 0.95), roughness=0.05)
    glass = b.add_material(albedo=(1.0, 1.0, 1.0), transparency=1.0, refractive_index=1.5)

    def quad(p00, p10, p11, p01, m):
        b.add_triangle(v0=p00, v1=p10, v2=p11, material=m)
        b.add_triangle(v0=p00, v1=p11, v2=p01, material=m)

    z0, z1, x_, y_ = 2.0, 10.0, 3.0, 2.0
    quad((-x_, -y_, z0), (x_, -y_, z0), (x_, -y_, z1), (-x_, -y_, z1), white)
    quad((-x_, y_, z0), (x_, y_, z0), (x_, y_, z1), (-x_, y_, z1), white)
    quad((-x_, -y_, z0), (-x_, y_, z0), (-x_, y_, z1), (-x_, -y_, z1), red)
    quad((x_, -y_, z0), (x_, y_, z0), (x_, y_, z1), (x_, -y_, z1), green)
    quad((-x_, -y_, z1), (x_, -y_, z1), (x_, y_, z1), (-x_, y_, z1), white)
    b.add_sphere(center=(0.0, 1.55, 6.0), radius=0.8, material=light)
    b.add_sphere(center=(-1.0, -1.2, 6.5), radius=0.8, material=mirror)
    b.add_sphere(center=(1.1, -1.3, 5.0), radius=0.7, material=glass)
    return b.build()


def nee_light_scene(light_albedo=0.0):
    """A diffuse room lit by one small sphere light (sphere 1). With a black
    light a path that strikes it dies, so autograd's geometry gradient of
    the light is exactly the light sample's chain."""
    b = J.SceneBuilder(sky_color=(0.05, 0.06, 0.08))
    ground(b, albedo=(0.55, 0.5, 0.45), roughness=1.0)
    wall = b.add_material(albedo=(0.4, 0.45, 0.6), roughness=1.0)
    lamp = b.add_material(albedo=(light_albedo,) * 3, emission_color=(1.0, 0.85, 0.6),
                          emission_strength=12.0)
    b.add_sphere(center=(0.0, 0.0, 6.0), radius=1.2, material=wall)
    b.add_sphere(center=(1.6, 2.2, 4.5), radius=0.35, material=lamp)
    return b.build()


def tri_light_mixed_scene():
    """A triangle ceiling light (triangles 2, 3), a sphere light (sphere 1)
    and diffuse content: a mixed emitter pool of three."""
    b = J.SceneBuilder(sky_color=(0.01, 0.01, 0.02))
    ground(b, half=40.0, albedo=(0.6, 0.55, 0.5), roughness=1.0)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.9, 0.7),
                          emission_strength=20.0)
    slamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(0.8, 0.9, 1.0),
                           emission_strength=8.0)
    ball = b.add_material(albedo=(0.7, 0.3, 0.3), roughness=1.0)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(1.0, 3.0, 4.0), v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(-1.0, 3.0, 6.0), v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_sphere(center=(0.0, -0.3, 5.0), radius=0.7, material=ball)
    b.add_sphere(center=(2.0, 2.0, 3.5), radius=0.4, material=slamp)
    return b.build()


def tri_black_lights_scene(ground_roughness=1.0):
    """One black sphere light (sphere 0) and two black triangle lights
    (triangles 2, 3): a pool of three whose geometry gradient under
    autograd is exactly the light samples' chains, and shows a wrong pool
    factor as a factor of 3."""
    b = J.SceneBuilder(sky_color=(0.04, 0.05, 0.07))
    ground(b, albedo=(0.55, 0.5, 0.45), roughness=ground_roughness)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.85, 0.6),
                          emission_strength=12.0)
    tlamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(0.7, 0.8, 1.0),
                           emission_strength=9.0)
    b.add_triangle(v0=(-1.2, 3.0, 4.0), v1=(0.8, 3.0, 4.0), v2=(0.8, 3.0, 6.0), material=tlamp)
    b.add_triangle(v0=(-1.2, 3.0, 4.0), v1=(-1.2, 3.0, 6.0), v2=(0.8, 3.0, 6.0), material=tlamp)
    b.add_sphere(center=(1.6, 2.2, 4.5), radius=0.35, material=lamp)
    return b.build()


def lobe_scene(roughness=0.5):
    """A half-rough sphere (material 0) over a diffuse ground under a black
    lamp: the radiance depends on which lobe the sphere draws."""
    b = J.SceneBuilder(sky_color=(0.02, 0.02, 0.03))
    m = b.add_material(albedo=(0.9, 0.9, 0.9), roughness=roughness)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.9, 0.8),
                          emission_strength=25.0)
    b.add_sphere(center=(0.0, 0.0, 3.0), radius=1.0, material=m)
    b.add_sphere(center=(2.0, 3.5, 2.0), radius=0.5, material=lamp)
    ground(b, y=-1.2, half=60.0, albedo=(0.4, 0.35, 0.3), roughness=1.0)
    return b.build()


def many_lights_scene(n=10):
    """``n`` black sphere lights over a diffuse ground: sphere index ==
    emitter ordinal."""
    b = J.SceneBuilder(sky_color=(0.02, 0.02, 0.03))
    ground(b, albedo=(0.5, 0.5, 0.5), roughness=1.0)
    for i in range(n):
        lamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.9, 0.8),
                              emission_strength=4.0 + i)
        b.add_sphere(center=(-4.5 + i, 2.0, 6.0), radius=0.3, material=lamp)
    return b.build()


SCENES = {
    "cornell": jdemo.cornell_spheres_scene, "glossy": jdemo.glossy_scene,
    "cornell_triangles": cornell_triangles_scene, "tri_light": tri_light_mixed_scene,
    "nee_light": nee_light_scene, "tri_black_lights": tri_black_lights_scene,
    "diffuse": jdemo.diffuse_sphere_scene,
}


def assert_images_close(a, b):
    """The physical tolerance for two compilations of one estimator: the
    0.99-quantile of |delta| below 1e-4, the share of |delta| > 1e-3 below
    1%, the means within 2e-3."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.all(np.isfinite(a))
    err = np.abs(a - b)
    assert np.quantile(err, 0.99) < 1e-4, np.quantile(err, 0.99)
    assert (err > 1e-3).mean() < 0.01, (err > 1e-3).mean()
    assert abs(a.mean() - b.mean()) < 2e-3, (a.mean(), b.mean())


def assert_planes_close(a, b):
    """Jacobian planes of two compilations: the same tolerance, relative to
    the planes' scale ``s = max(1, max |b|)`` (a plane entry is a sum over
    samples and bounces of throughputs, weights and their products): the
    0.99-quantile of |delta| below 1e-4 s, the share of |delta| > 1e-3 s
    below 1%, the plane means within 2e-3 s. A path that a rounding
    difference flips moves its pixel's entries by much, and is rare."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.all(np.isfinite(a)), (a.shape, b.shape)
    if a.size == 0:
        return
    s = max(1.0, np.abs(b).max())
    err = np.abs(a - b)
    assert np.quantile(err, 0.99) < 1e-4 * s, (np.quantile(err, 0.99), s)
    assert (err > 1e-3 * s).mean() < 0.01, (err > 1e-3 * s).mean()
    assert abs(a.mean() - b.mean()) < 2e-3 * s, (a.mean(), b.mean())


def light_fit_scene():
    """A black sphere light (sphere 0) over a diffuse sphere and ground: the
    light-recovery scene of tests/test_pallas_physical.py."""
    b = J.SceneBuilder(sky_color=(0.0, 0.0, 0.0))
    light = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.9, 0.8),
                           emission_strength=10.0)
    diffuse = b.add_material(albedo=(0.7, 0.5, 0.4), roughness=1.0)
    b.add_sphere(center=(1.5, 2.4, 4.0), radius=0.45, material=light)
    b.add_sphere(center=(0.0, -0.2, 5.0), radius=1.0, material=diffuse)
    b.add_triangle(v0=(-50, -1.2, -50), v1=(50, -1.2, -50), v2=(50, -1.2, 50), material=diffuse)
    b.add_triangle(v0=(-50, -1.2, -50), v1=(-50, -1.2, 50), v2=(50, -1.2, 50), material=diffuse)
    return b.build()


def tri_light_fit_scene():
    """A black triangle ceiling light (triangles 2, 3) over a diffuse ball
    and ground: the triangle-light recovery scene of
    tests/test_pallas_physical.py."""
    b = J.SceneBuilder(sky_color=(0.0, 0.0, 0.0))
    ground(b, half=40.0, albedo=(0.6, 0.55, 0.5), roughness=1.0)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.9, 0.7),
                          emission_strength=20.0)
    ball = b.add_material(albedo=(0.7, 0.3, 0.3), roughness=1.0)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(1.0, 3.0, 4.0), v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(-1.0, 3.0, 6.0), v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_sphere(center=(0.0, -0.3, 5.0), radius=0.7, material=ball)
    return b.build()
