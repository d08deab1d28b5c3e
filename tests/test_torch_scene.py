"""PyTorch port: scene tables and the camera, carried over from the JAX
package bit for bit (capacities, padding and masks included)."""

import dataclasses

import numpy as np
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.scene import demo as jdemo
from path_tracer_c_tpu.scene.io import scene_to_dict as j_scene_to_dict
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.scene import demo as pdemo
from path_tracer_c_tpu_torch.scene.io import (
    load_scene, save_scene, scene_from_arrays, scene_from_dict, scene_to_dict,
)

torch.set_num_threads(1)

DEMOS = [
    "demo_scene", "diffuse_sphere_scene", "cornell_spheres_scene",
    "glossy_scene", "random_spheres_scene",
]


def arrays(x):
    """A JAX dataclass tree as nested numpy dicts under its field names."""
    if dataclasses.is_dataclass(x):
        return {f.name: arrays(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def assert_same_tables(jscene, pscene):
    ja, pa = arrays(jscene), arrays_t(pscene)
    for table in ("materials", "spheres", "triangles"):
        for name, jv in ja[table].items():
            pv = pa[table][name]
            assert pv.dtype == jv.dtype, (table, name, pv.dtype, jv.dtype)
            np.testing.assert_array_equal(pv, jv, err_msg=f"{table}.{name}")
    np.testing.assert_array_equal(pa["sky_color"], ja["sky_color"])


def arrays_t(x):
    if dataclasses.is_dataclass(x):
        return {f.name: arrays_t(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return x.cpu().numpy()


@pytest.mark.parametrize("name", DEMOS)
def test_demo_scenes_match_and_carry_over(name):
    """The port's demo scenes equal the JAX ones value for value, and the
    JAX scene carried over by scene_from_arrays equals both."""
    jscene = getattr(jdemo, name)()
    assert_same_tables(jscene, getattr(pdemo, name)("cpu"))
    carried = scene_from_arrays(arrays(jscene), "cpu")
    assert_same_tables(jscene, carried)
    assert scene_to_dict(carried) == j_scene_to_dict(jscene)


def _builder(mod):
    b = mod.SceneBuilder(sky_color=(0.1, 0.2, 0.3))
    m = b.add_material(albedo=(0.5, 0.25, 1.0), roughness=0.3,
                       emission_color=(1.0, 0.5, 0.0), emission_strength=2.0,
                       transparency=0.5, refractive_index=1.33)
    b.add_sphere(center=(0.0, 0.0, 4.0), radius=1.0, material=m)
    b.add_sphere(center=(1.0, -0.5, 6.0), radius=0.5, material=m)
    b.add_triangle(v0=(-1, -1, 3), v1=(1, -1, 3), v2=(0, 1, 3), material=m)
    return b


def test_padded_scene_carries_capacity_and_masks():
    """A scene built with explicit capacities keeps its padding and active
    masks through scene_from_arrays, and the port's builder pads the same."""
    jscene = _builder(J).build(sphere_capacity=8, triangle_capacity=4)
    carried = scene_from_arrays(arrays(jscene), "cpu")
    assert carried.num_spheres == 8 and carried.num_triangles == 4
    assert carried.spheres.active.tolist() == [True, True] + [False] * 6
    assert_same_tables(jscene, carried)
    assert_same_tables(jscene, _builder(P).build("cpu", sphere_capacity=8,
                                                 triangle_capacity=4))
    # the JSON form drops padding
    assert scene_from_dict(scene_to_dict(carried), "cpu").num_spheres == 2


def test_builder_rejects_small_capacity():
    with pytest.raises(ValueError):
        _builder(P).build("cpu", sphere_capacity=1)
    with pytest.raises(ValueError):
        _builder(P).build("cpu", triangle_capacity=0)


def test_scene_from_arrays_rejects_bad_shape():
    d = arrays(jdemo.demo_scene())
    d["spheres"]["radius"] = d["spheres"]["radius"][:-1]
    with pytest.raises(ValueError):
        scene_from_arrays(d, "cpu")


def test_save_load_roundtrip(tmp_path):
    scene = pdemo.glossy_scene("cpu")
    save_scene(tmp_path / "s.json", scene)
    assert_same_tables(jdemo.glossy_scene(), load_scene(tmp_path / "s.json", "cpu"))


def test_camera_reference_and_look_at():
    jcam = J.Camera.reference(60.0)
    pcam = P.Camera.reference("cpu", 60.0)
    for f in dataclasses.fields(jcam):
        np.testing.assert_array_equal(getattr(pcam, f.name).numpy(),
                                      np.asarray(getattr(jcam, f.name)))
        np.testing.assert_array_equal(
            getattr(P.Camera.from_arrays(arrays(jcam), "cpu"), f.name).numpy(),
            np.asarray(getattr(jcam, f.name)),
        )
    # look_at: normalisations may round differently; 1e-6 is a few ulps
    jl = J.Camera.look_at((3.0, 1.5, -2.0), (0.0, 0.0, 6.0), fov_deg=70.0)
    pl = P.Camera.look_at((3.0, 1.5, -2.0), (0.0, 0.0, 6.0), "cpu", fov_deg=70.0)
    for f in dataclasses.fields(jl):
        np.testing.assert_allclose(getattr(pl, f.name).numpy(),
                                   np.asarray(getattr(jl, f.name)), atol=1e-6)
