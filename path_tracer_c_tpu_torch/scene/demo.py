"""Canonical scenes, value for value the JAX package's ``scene/demo.py``.

Each builder takes the ``device`` its tables are placed on. Scenes that
draw random values do so with numpy generators in the same order as the
JAX package, so both packages build identical tables.
"""

from __future__ import annotations

import numpy as np

from .scene import Scene, SceneBuilder

__all__ = [
    "demo_scene",
    "diffuse_sphere_scene",
    "cornell_spheres_scene",
    "glossy_scene",
    "random_spheres_scene",
]


def demo_scene(device) -> Scene:
    """The reference's demo scene, value-for-value (src/main.c:202-230).

    Five materials (sun, red plastic, green grass, mirror, glass), four
    spheres, two ground triangles, black sky (src/main.c:206).
    """
    b = SceneBuilder(sky_color=(0.0, 0.0, 0.0))
    sun = b.add_material(
        albedo=(0.9372, 0.7490, 0.0157),
        roughness=0.3,
        metallicity=1.0,
        emission_color=(0.9372, 0.7490, 0.0157),
        emission_strength=10.0,
        transparency=0.0,
        refractive_index=1.0,
    )
    red_plastic = b.add_material(
        albedo=(1.0, 0.0, 0.0),
        roughness=0.85,
        metallicity=0.5,
        emission_color=(1.0, 0.0, 0.0),
        emission_strength=0.0,
        transparency=0.0,
        refractive_index=1.0,
    )
    green_grass = b.add_material(
        albedo=(65 / 255, 152 / 255, 10 / 255),
        roughness=1.0,
        metallicity=0.1,
        emission_color=(65 / 255, 152 / 255, 10 / 255),
        emission_strength=0.0,
        transparency=0.0,
        refractive_index=1.0,
    )
    mirror = b.add_material(
        albedo=(1.0, 1.0, 1.0),
        roughness=0.0,
        metallicity=1.0,
        emission_color=(0.0, 0.0, 0.0),
        emission_strength=0.0,
        transparency=0.0,
        refractive_index=1.0,
    )
    glass = b.add_material(
        albedo=(1.0, 1.0, 1.0),
        roughness=0.0,
        metallicity=0.0,
        emission_color=(1.0, 1.0, 1.0),
        emission_strength=0.0,
        transparency=1.0,
        refractive_index=1.52,
    )

    b.add_sphere(center=(80.0, 50.0, 100.0), radius=40.0, material=sun)
    b.add_sphere(center=(-2.0, 0.0, 4.0), radius=1.0, material=red_plastic)
    b.add_sphere(center=(2.5, -0.2, 5.0), radius=1.0, material=glass)
    b.add_sphere(center=(0.0, 1.5, 10.0), radius=2.5, material=mirror)

    b.add_triangle(
        v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50), material=green_grass
    )
    b.add_triangle(
        v0=(-50, -1, -50), v1=(-50, -1, 50), v2=(50, -1, 50), material=green_grass
    )
    return b.build(device)


def diffuse_sphere_scene(device) -> Scene:
    """BASELINE config 1: single diffuse sphere + ground plane, dim sky."""
    b = SceneBuilder(sky_color=(0.6, 0.7, 0.9))
    white = b.add_material(albedo=(0.8, 0.3, 0.3), roughness=1.0)
    ground = b.add_material(albedo=(0.5, 0.5, 0.5), roughness=1.0)
    b.add_sphere(center=(0.0, 0.0, 4.0), radius=1.0, material=white)
    b.add_triangle(
        v0=(-100, -1, -100), v1=(100, -1, -100), v2=(100, -1, 100), material=ground
    )
    b.add_triangle(
        v0=(-100, -1, -100), v1=(-100, -1, 100), v2=(100, -1, 100), material=ground
    )
    return b.build(device)


def cornell_spheres_scene(device) -> Scene:
    """BASELINE config 2: Cornell-box-style 8-sphere scene with emissive light.

    Walls are built from giant spheres (a classic trick) so the whole scene
    exercises the sphere path heavily; one emissive ceiling light.
    """
    b = SceneBuilder(sky_color=(0.0, 0.0, 0.0))
    white = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=1.0)
    red = b.add_material(albedo=(0.65, 0.05, 0.05), roughness=1.0)
    green = b.add_material(albedo=(0.12, 0.45, 0.15), roughness=1.0)
    light = b.add_material(
        albedo=(1.0, 1.0, 1.0),
        emission_color=(1.0, 0.9, 0.7),
        emission_strength=15.0,
    )
    mirror = b.add_material(albedo=(0.95, 0.95, 0.95), roughness=0.05)
    glass = b.add_material(
        albedo=(1.0, 1.0, 1.0), transparency=1.0, refractive_index=1.5
    )

    r = 1000.0
    z0 = 6.0
    b.add_sphere(center=(0.0, -(r + 2.0), z0), radius=r, material=white)  # floor
    b.add_sphere(center=(0.0, r + 2.0, z0), radius=r, material=white)  # ceiling
    b.add_sphere(center=(-(r + 3.0), 0.0, z0), radius=r, material=red)  # left
    b.add_sphere(center=(r + 3.0, 0.0, z0), radius=r, material=green)  # right
    b.add_sphere(center=(0.0, 0.0, r + 10.0), radius=r, material=white)  # back
    b.add_sphere(center=(0.0, 2.55, z0), radius=0.8, material=light)  # lamp
    b.add_sphere(center=(-1.0, -1.2, 6.5), radius=0.8, material=mirror)
    b.add_sphere(center=(1.1, -1.3, 5.0), radius=0.7, material=glass)
    return b.build(device)


def glossy_scene(device) -> Scene:
    """BASELINE config 3: glossy/specular material mix for the 1024^2 bench."""
    b = SceneBuilder(sky_color=(0.5, 0.6, 0.8))
    ground = b.add_material(albedo=(0.4, 0.4, 0.42), roughness=0.9)
    b.add_triangle(
        v0=(-200, -1, -200), v1=(200, -1, -200), v2=(200, -1, 200), material=ground
    )
    b.add_triangle(
        v0=(-200, -1, -200), v1=(-200, -1, 200), v2=(200, -1, 200), material=ground
    )
    sun = b.add_material(
        albedo=(1.0, 0.95, 0.8),
        emission_color=(1.0, 0.95, 0.8),
        emission_strength=20.0,
    )
    b.add_sphere(center=(60.0, 80.0, 40.0), radius=30.0, material=sun)
    rng = np.random.default_rng(3)
    for i in range(12):
        rough = float(i % 4) / 4.0
        col = rng.uniform(0.2, 0.95, size=3)
        m = b.add_material(albedo=tuple(col), roughness=rough)
        x = -5.5 + (i % 6) * 2.2
        z = 5.0 + (i // 6) * 3.0
        b.add_sphere(center=(x, 0.0, z), radius=1.0, material=m)
    glass = b.add_material(
        albedo=(1.0, 1.0, 1.0), transparency=1.0, refractive_index=1.5
    )
    b.add_sphere(center=(0.0, 0.2, 3.0), radius=1.2, material=glass)
    return b.build(device)


def random_spheres_scene(
    device, n: int = 32, seed: int = 0, emissive_every: int = 8
) -> Scene:
    """BASELINE config 4: n-sphere scene whose albedo+emission get recovered
    by inverse rendering. Deterministic from ``seed``.
    """
    rng = np.random.default_rng(seed)
    b = SceneBuilder(sky_color=(0.05, 0.05, 0.08))
    ground = b.add_material(albedo=(0.5, 0.5, 0.5), roughness=1.0)
    b.add_triangle(
        v0=(-100, -1, -100), v1=(100, -1, -100), v2=(100, -1, 100), material=ground
    )
    b.add_triangle(
        v0=(-100, -1, -100), v1=(-100, -1, 100), v2=(100, -1, 100), material=ground
    )
    grid = int(np.ceil(np.sqrt(n)))
    for i in range(n):
        albedo = tuple(rng.uniform(0.1, 0.9, size=3))
        emissive = (i % emissive_every) == 0
        m = b.add_material(
            albedo=albedo,
            roughness=float(rng.uniform(0.3, 1.0)),
            emission_color=albedo if emissive else (0.0, 0.0, 0.0),
            emission_strength=float(rng.uniform(2.0, 8.0)) if emissive else 0.0,
        )
        x = (i % grid - (grid - 1) / 2) * 1.6
        y = (i // grid - (grid - 1) / 2) * 1.6
        b.add_sphere(center=(x, y, 8.0), radius=0.6, material=m)
    return b.build(device)
