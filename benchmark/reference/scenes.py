"""The configurations' scenes and camera as numpy tables: the inputs the
benchmark hands to the program (``scene_from_arrays``, ``Camera.from_arrays``)
and, the same tables, to the reference.

Each constructor is a frozen copy of the port's ``scene/demo.py`` builder
of that name, draw for draw, so the tables are the ones the command line
renders. The layout is the JAX package's field names: ``materials``,
``spheres``, ``triangles`` (each a dict of arrays) and ``sky_color``.
"""

from __future__ import annotations

import numpy as np


class _Builder:
    """The scene builder's verbs, on lists, frozen into float32 tables
    whose capacity is the object count (at least one inactive row)."""

    def __init__(self, sky_color):
        self.sky = tuple(sky_color)
        self.mats, self.sph, self.tri = [], [], []

    def material(self, albedo, roughness=0.0, metallicity=0.0, emission_color=(0.0, 0.0, 0.0),
                 emission_strength=0.0, transparency=0.0, refractive_index=1.0) -> int:
        self.mats.append((tuple(albedo), float(roughness), float(metallicity),
                          tuple(emission_color), float(emission_strength),
                          float(transparency), float(refractive_index)))
        return len(self.mats) - 1

    def sphere(self, center, radius, material):
        self.sph.append((tuple(center), float(radius), int(material)))

    def triangle(self, v0, v1, v2, material):
        self.tri.append((tuple(v0), tuple(v1), tuple(v2), int(material)))

    def build(self) -> dict:
        def arr(vals, shape, dt=np.float32):
            out = np.zeros(shape, dtype=dt)
            if vals:
                out[: len(vals)] = np.asarray(vals, dtype=dt)
            return out

        nm, ns, nt = len(self.mats), max(len(self.sph), 1), max(len(self.tri), 1)
        m = self.mats
        return {
            "materials": {
                "albedo": arr([r[0] for r in m], (nm, 3)),
                "roughness": arr([r[1] for r in m], (nm,)),
                "metallicity": arr([r[2] for r in m], (nm,)),
                "emission_color": arr([r[3] for r in m], (nm, 3)),
                "emission_strength": arr([r[4] for r in m], (nm,)),
                "transparency": arr([r[5] for r in m], (nm,)),
                "refractive_index": arr([r[6] for r in m], (nm,)),
            },
            "spheres": {
                "center": arr([s[0] for s in self.sph], (ns, 3)),
                "radius": arr([s[1] for s in self.sph], (ns,)),
                "material": arr([s[2] for s in self.sph], (ns,), np.int32),
                "active": np.arange(ns) < len(self.sph),
            },
            "triangles": {
                "v0": arr([t[0] for t in self.tri], (nt, 3)),
                "v1": arr([t[1] for t in self.tri], (nt, 3)),
                "v2": arr([t[2] for t in self.tri], (nt, 3)),
                "material": arr([t[3] for t in self.tri], (nt,), np.int32),
                "active": np.arange(nt) < len(self.tri),
            },
            "sky_color": np.asarray(self.sky, dtype=np.float32),
        }


def glossy() -> dict:
    """BASELINE config 3: glossy and specular materials, 15 spheres and a
    ground of two triangles (``scene/demo.py`` ``glossy_scene``)."""
    b = _Builder((0.5, 0.6, 0.8))
    ground = b.material(albedo=(0.4, 0.4, 0.42), roughness=0.9)
    b.triangle((-200, -1, -200), (200, -1, -200), (200, -1, 200), ground)
    b.triangle((-200, -1, -200), (-200, -1, 200), (200, -1, 200), ground)
    sun = b.material(albedo=(1.0, 0.95, 0.8), emission_color=(1.0, 0.95, 0.8),
                     emission_strength=20.0)
    b.sphere((60.0, 80.0, 40.0), 30.0, sun)
    rng = np.random.default_rng(3)
    for i in range(12):
        col = rng.uniform(0.2, 0.95, size=3)
        m = b.material(albedo=tuple(col), roughness=float(i % 4) / 4.0)
        b.sphere((-5.5 + (i % 6) * 2.2, 0.0, 5.0 + (i // 6) * 3.0), 1.0, m)
    glass = b.material(albedo=(1.0, 1.0, 1.0), transparency=1.0, refractive_index=1.5)
    b.sphere((0.0, 0.2, 3.0), 1.2, glass)
    return b.build()


def spheres32(n: int = 32, seed: int = 0, emissive_every: int = 8) -> dict:
    """BASELINE config 4: ``n`` spheres whose albedo and emission a fit
    recovers, drawn from ``seed`` (``scene/demo.py``
    ``random_spheres_scene``)."""
    rng = np.random.default_rng(seed)
    b = _Builder((0.05, 0.05, 0.08))
    ground = b.material(albedo=(0.5, 0.5, 0.5), roughness=1.0)
    b.triangle((-100, -1, -100), (100, -1, -100), (100, -1, 100), ground)
    b.triangle((-100, -1, -100), (-100, -1, 100), (100, -1, 100), ground)
    grid = int(np.ceil(np.sqrt(n)))
    for i in range(n):
        albedo = tuple(rng.uniform(0.1, 0.9, size=3))
        emissive = (i % emissive_every) == 0
        m = b.material(
            albedo=albedo,
            roughness=float(rng.uniform(0.3, 1.0)),
            emission_color=albedo if emissive else (0.0, 0.0, 0.0),
            emission_strength=float(rng.uniform(2.0, 8.0)) if emissive else 0.0,
        )
        b.sphere(((i % grid - (grid - 1) / 2) * 1.6, (i // grid - (grid - 1) / 2) * 1.6, 8.0),
                 0.6, m)
    return b.build()


SCENES = {"glossy": glossy, "spheres32": spheres32}


def scene(name: str) -> dict:
    """The tables of the scene a configuration names."""
    if name not in SCENES:
        raise ValueError(f"unknown scene {name!r}; one of {', '.join(SCENES)}")
    return SCENES[name]()


def camera(fov_deg: float) -> dict:
    """The command line's fixed camera: at the origin, looking down +z."""
    return {"origin": np.zeros(3, np.float32), "right": np.array([1, 0, 0], np.float32),
            "up": np.array([0, 1, 0], np.float32), "forward": np.array([0, 0, 1], np.float32),
            "fov": np.float32(np.deg2rad(fov_deg))}


def with_materials(tables: dict, **fields) -> dict:
    """``tables`` with material fields set to one value each (the fit's
    corrupted start: ``albedo=0.5, emission_strength=0.1``)."""
    mats = {k: (np.full_like(v, fields[k]) if k in fields else v)
            for k, v in tables["materials"].items()}
    return {**tables, "materials": mats}
