"""SoA scene representation and builder API (PyTorch).

Counterpart of ``path_tracer_c_tpu/scene/scene.py``: the same structure-of-
arrays tables with exact capacities and per-object ``active`` masks, as
frozen dataclasses of tensors. Layouts match the JAX package field for
field: (M, 3)/(M,) materials, (S, 3)/(S,) spheres, (T, 3)/(T,) triangles,
float32 values, int32 material indices and bool masks.

Every table is built on the host with numpy, exactly as the JAX builder
does, and then moved to the ``device`` the caller names.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["Materials", "Spheres", "Triangles", "Scene", "SceneBuilder"]


@dataclass(frozen=True)
class Materials:
    """Material table, one row per material.

    ``metallicity`` is carried for parity with the JAX package and is read
    by no renderer.
    """

    albedo: torch.Tensor  # (M, 3)
    roughness: torch.Tensor  # (M,)
    metallicity: torch.Tensor  # (M,)
    emission_color: torch.Tensor  # (M, 3)
    emission_strength: torch.Tensor  # (M,)
    transparency: torch.Tensor  # (M,)
    refractive_index: torch.Tensor  # (M,)


@dataclass(frozen=True)
class Spheres:
    center: torch.Tensor  # (S, 3)
    radius: torch.Tensor  # (S,)
    material: torch.Tensor  # (S,) int32
    active: torch.Tensor  # (S,) bool, False for padding slots


@dataclass(frozen=True)
class Triangles:
    v0: torch.Tensor  # (T, 3)
    v1: torch.Tensor  # (T, 3)
    v2: torch.Tensor  # (T, 3)
    material: torch.Tensor  # (T,) int32
    active: torch.Tensor  # (T,) bool


@dataclass(frozen=True)
class Scene:
    """Full scene: material, sphere and triangle tables plus the sky."""

    materials: Materials
    spheres: Spheres
    triangles: Triangles
    sky_color: torch.Tensor  # (3,)

    @property
    def device(self) -> torch.device:
        return self.sky_color.device

    @property
    def num_spheres(self) -> int:
        return self.spheres.radius.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.triangles.material.shape[0]

    @property
    def num_materials(self) -> int:
        return self.materials.roughness.shape[0]


_DEFAULT_MATERIAL = dict(
    albedo=(0.0, 0.0, 0.0),
    roughness=0.0,
    metallicity=0.0,
    emission_color=(0.0, 0.0, 0.0),
    emission_strength=0.0,
    transparency=0.0,
    refractive_index=1.0,
)


@dataclass
class SceneBuilder:
    """Host-side scene construction with the reference's five verbs
    (``SceneBuilder()``, ``add_material``, ``add_sphere``, ``add_triangle``,
    ``build``)."""

    sky_color: tuple = (0.0, 0.0, 0.0)
    _materials: list = field(default_factory=list)
    _spheres: list = field(default_factory=list)
    _triangles: list = field(default_factory=list)

    def add_material(
        self,
        albedo,
        roughness=0.0,
        metallicity=0.0,
        emission_color=(0.0, 0.0, 0.0),
        emission_strength=0.0,
        transparency=0.0,
        refractive_index=1.0,
    ) -> int:
        """Append a material; returns its index."""
        self._materials.append(
            dict(
                albedo=tuple(albedo),
                roughness=float(roughness),
                metallicity=float(metallicity),
                emission_color=tuple(emission_color),
                emission_strength=float(emission_strength),
                transparency=float(transparency),
                refractive_index=float(refractive_index),
            )
        )
        return len(self._materials) - 1

    def add_sphere(self, center, radius, material: int) -> int:
        """Append a sphere; returns its index."""
        self._spheres.append((tuple(center), float(radius), int(material)))
        return len(self._spheres) - 1

    def add_triangle(self, v0, v1, v2, material: int) -> int:
        """Append a triangle; returns its index."""
        self._triangles.append(
            (tuple(v0), tuple(v1), tuple(v2), int(material))
        )
        return len(self._triangles) - 1

    @property
    def num_materials(self) -> int:
        return len(self._materials)

    @property
    def num_spheres(self) -> int:
        return len(self._spheres)

    @property
    def num_triangles(self) -> int:
        return len(self._triangles)

    def build(
        self,
        device,
        sphere_capacity: int | None = None,
        triangle_capacity: int | None = None,
    ) -> Scene:
        """Freeze into a ``Scene`` on ``device``.

        Capacities default to the exact object counts (at least 1). An
        explicit capacity pads the table with inactive slots; one smaller
        than the object count raises ``ValueError``.
        """
        ns, nt = len(self._spheres), len(self._triangles)
        cap_s = sphere_capacity if sphere_capacity is not None else max(ns, 1)
        cap_t = triangle_capacity if triangle_capacity is not None else max(nt, 1)
        if cap_s < ns or cap_t < nt:
            raise ValueError("capacity smaller than object count")

        def arr(vals, shape, dt=np.float32):
            out = np.zeros(shape, dtype=dt)
            if vals:
                out[: len(vals)] = np.asarray(vals, dtype=dt)
            return torch.from_numpy(out).to(device)

        def mask(n, cap):
            return torch.from_numpy(np.arange(cap) < n).to(device)

        mats = self._materials or [_DEFAULT_MATERIAL]
        nm = len(mats)
        materials = Materials(
            albedo=arr([m["albedo"] for m in mats], (nm, 3)),
            roughness=arr([m["roughness"] for m in mats], (nm,)),
            metallicity=arr([m["metallicity"] for m in mats], (nm,)),
            emission_color=arr([m["emission_color"] for m in mats], (nm, 3)),
            emission_strength=arr([m["emission_strength"] for m in mats], (nm,)),
            transparency=arr([m["transparency"] for m in mats], (nm,)),
            refractive_index=arr([m["refractive_index"] for m in mats], (nm,)),
        )
        spheres = Spheres(
            center=arr([s[0] for s in self._spheres], (cap_s, 3)),
            radius=arr([s[1] for s in self._spheres], (cap_s,)),
            material=arr([s[2] for s in self._spheres], (cap_s,), np.int32),
            active=mask(ns, cap_s),
        )
        triangles = Triangles(
            v0=arr([t[0] for t in self._triangles], (cap_t, 3)),
            v1=arr([t[1] for t in self._triangles], (cap_t, 3)),
            v2=arr([t[2] for t in self._triangles], (cap_t, 3)),
            material=arr([t[3] for t in self._triangles], (cap_t,), np.int32),
            active=mask(nt, cap_t),
        )
        return Scene(
            materials=materials,
            spheres=spheres,
            triangles=triangles,
            sky_color=arr(list(self.sky_color), (3,)),
        )
