"""Render configuration as data, JSON-compatible with the JAX package.

``load`` reads the JAX package's config files (``configs/*.json``). Keys
this package does not know, such as the TPU tile sizes, are ignored, as
the JAX loader ignores them. The fields for features not ported yet
(``mesh``, checkpointing, progressive output, ``tri_nee``, ``debug_nans``)
are kept so that the CLI can refuse a config that sets them, instead of
silently rendering something else.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["RenderConfig", "MeshConfig", "load"]


@dataclass
class MeshConfig:
    """tile x spp device mesh layout; 1 x 1 is a single device."""

    tile: int = 1
    spp: int = 1


@dataclass
class RenderConfig:
    """One render: resolution, sampling, scene, camera, output."""

    width: int = 1280
    height: int = 800
    spp: int = 64
    max_bounces: int = 4
    fov_deg: float = 90.0
    seed: int = 0
    scene: str = "demo"  # name in scene.demo or a scene JSON path
    jitter: bool = False
    # "cuda" (the hand kernel) | "core" (the eager integrator). "pallas",
    # the JAX package's name for its kernel engine, means "cuda" here.
    engine: str = "cuda"
    output: str = "output.bmp"
    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint_every: int = 0
    checkpoint_path: str = ""
    debug_nans: bool = False
    progressive: bool = False
    tri_nee: bool = False


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name == "mesh" and isinstance(v, dict):
            v = _from_dict(MeshConfig, v)
        kwargs[f.name] = v
    return cls(**kwargs)


def load(path) -> RenderConfig:
    return _from_dict(RenderConfig, json.loads(Path(path).read_text()))
