"""Scene serialization and carrying scenes over from the JAX package.

``scene_to_dict``/``scene_from_dict``/``save_scene``/``load_scene`` use the
JSON builder format of ``path_tracer_c_tpu/scene/io.py``: one entry per
builder verb, active objects only.

``scene_from_arrays`` takes a scene's tables as numpy arrays, nested under
the JAX dataclass field names (``{"materials": {"albedo": ...}, "spheres":
{"active": ...}, ..., "sky_color": ...}``), and keeps capacities, padding
and masks exactly. It is how a scene built in JAX crosses to this package
without importing JAX here; the JSON form drops padding and so cannot do
that for a scene built with an explicit capacity.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .scene import Materials, Scene, SceneBuilder, Spheres, Triangles

__all__ = [
    "scene_to_dict",
    "scene_from_dict",
    "save_scene",
    "load_scene",
    "scene_from_arrays",
]


# field -> (trailing shape, dtype); the leading dimension is the table's
# capacity, shared by every field of one table.
_FIELDS = {
    "materials": {
        "albedo": ((3,), np.float32),
        "roughness": ((), np.float32),
        "metallicity": ((), np.float32),
        "emission_color": ((3,), np.float32),
        "emission_strength": ((), np.float32),
        "transparency": ((), np.float32),
        "refractive_index": ((), np.float32),
    },
    "spheres": {
        "center": ((3,), np.float32),
        "radius": ((), np.float32),
        "material": ((), np.int32),
        "active": ((), np.bool_),
    },
    "triangles": {
        "v0": ((3,), np.float32),
        "v1": ((3,), np.float32),
        "v2": ((3,), np.float32),
        "material": ((), np.int32),
        "active": ((), np.bool_),
    },
}
_TABLES = {"materials": Materials, "spheres": Spheres, "triangles": Triangles}


def scene_to_dict(scene: Scene) -> dict:
    """Serialize a Scene to builder form; padding slots are dropped."""
    g = lambda x: x.detach().cpu().numpy()
    mats = {k: g(getattr(scene.materials, k)) for k in _FIELDS["materials"]}
    sph = {k: g(getattr(scene.spheres, k)) for k in _FIELDS["spheres"]}
    tri = {k: g(getattr(scene.triangles, k)) for k in _FIELDS["triangles"]}
    return {
        "sky_color": g(scene.sky_color).tolist(),
        "materials": [
            {
                "albedo": mats["albedo"][i].tolist(),
                "roughness": float(mats["roughness"][i]),
                "metallicity": float(mats["metallicity"][i]),
                "emission_color": mats["emission_color"][i].tolist(),
                "emission_strength": float(mats["emission_strength"][i]),
                "transparency": float(mats["transparency"][i]),
                "refractive_index": float(mats["refractive_index"][i]),
            }
            for i in range(scene.num_materials)
        ],
        "spheres": [
            {
                "center": sph["center"][i].tolist(),
                "radius": float(sph["radius"][i]),
                "material": int(sph["material"][i]),
            }
            for i in range(scene.num_spheres)
            if bool(sph["active"][i])
        ],
        "triangles": [
            {
                "v0": tri["v0"][i].tolist(),
                "v1": tri["v1"][i].tolist(),
                "v2": tri["v2"][i].tolist(),
                "material": int(tri["material"][i]),
            }
            for i in range(scene.num_triangles)
            if bool(tri["active"][i])
        ],
    }


def scene_from_dict(d: dict, device, **build_kwargs) -> Scene:
    b = SceneBuilder(sky_color=tuple(d.get("sky_color", (0.0, 0.0, 0.0))))
    for m in d.get("materials", []):
        b.add_material(**m)
    for s in d.get("spheres", []):
        b.add_sphere(center=s["center"], radius=s["radius"], material=s["material"])
    for t in d.get("triangles", []):
        b.add_triangle(v0=t["v0"], v1=t["v1"], v2=t["v2"], material=t["material"])
    return b.build(device, **build_kwargs)


def save_scene(path, scene: Scene) -> None:
    Path(path).write_text(json.dumps(scene_to_dict(scene), indent=2) + "\n")


def load_scene(path, device, **build_kwargs) -> Scene:
    return scene_from_dict(json.loads(Path(path).read_text()), device, **build_kwargs)


def scene_from_arrays(d: dict, device) -> Scene:
    """Build a Scene on ``device`` from numpy tables, capacities included.

    ``d`` nests the tables under the JAX dataclass field names. Values are
    cast to the scene's dtypes (float32, int32 material indices, bool
    masks); a field whose shape disagrees with its table raises
    ``ValueError``.
    """
    tables = {}
    for table, fields in _FIELDS.items():
        src = d[table]
        n = len(src[next(iter(fields))])  # the table's capacity
        vals = {}
        for name, (trail, dt) in fields.items():
            a = np.asarray(src[name])
            if a.shape != (n,) + trail:
                raise ValueError(
                    f"{table}.{name}: shape {a.shape}, expected {(n,) + trail}"
                )
            vals[name] = torch.from_numpy(np.array(a, dtype=dt)).to(device)
        tables[table] = _TABLES[table](**vals)
    sky = np.asarray(d["sky_color"])
    if sky.shape != (3,):
        raise ValueError(f"sky_color: shape {sky.shape}, expected (3,)")
    return Scene(
        sky_color=torch.from_numpy(np.array(sky, dtype=np.float32)).to(device),
        **tables,
    )
