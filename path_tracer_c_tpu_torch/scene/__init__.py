"""Scene model: SoA tables, builder verbs, canonical scenes, JSON IO."""
from .scene import Scene, SceneBuilder, Materials, Spheres, Triangles
from .io import (
    save_scene, load_scene, scene_to_dict, scene_from_dict, scene_from_arrays,
)
from . import demo

__all__ = [
    "Scene", "SceneBuilder", "Materials", "Spheres", "Triangles", "demo",
    "save_scene", "load_scene", "scene_to_dict", "scene_from_dict",
    "scene_from_arrays",
]
