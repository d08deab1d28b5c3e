"""Render configuration as data, JSON-compatible with the JAX package.

``load`` reads the JAX package's config files (``configs/*.json``): a
render config, or with ``cls=FitConfig`` a fit config, whose ``render``
block is a render config. Keys
this package does not know, such as the TPU tile sizes, are ignored, as
the JAX loader ignores them. The fields for features not ported yet
(``mesh``, checkpointing, progressive output, ``debug_nans``) are kept so
that the CLI can refuse a config that sets them, instead of silently
rendering something else.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["RenderConfig", "MeshConfig", "FitConfig", "load"]


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
    # Reference tier: "cuda" (the hand kernel) | "core" (the eager
    # integrator). Physical tier, in a render: "physical" (its hand kernel) |
    # "physical_core" (its eager integrator); "pallas" and
    # "physical_pallas", the JAX package's names for its kernel engines,
    # mean "cuda" and "physical" there. In a fit the physical names are the
    # JAX package's: "physical" is autograd through the eager tier,
    # "physical_pallas" the fused kernel (grad/diff.py).
    engine: str = "cuda"
    output: str = "output.bmp"
    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint_every: int = 0
    checkpoint_path: str = ""
    debug_nans: bool = False
    progressive: bool = False
    tri_nee: bool = False  # physical engines: light-sample emissive triangles too


@dataclass
class FitConfig:
    """Inverse rendering: the render settings of every step, and the fit's."""

    render: RenderConfig = field(default_factory=RenderConfig)
    steps: int = 200
    lr: float = 0.05
    target: str = ""  # target image path (npy), or empty to render one
    checkpoint_every: int = 0
    checkpoint_path: str = ""
    mode: str = "materials"  # materials | geometry | roughness; the CLI's --mode overrides


_NESTED = {"mesh": MeshConfig, "render": RenderConfig}


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in _NESTED and isinstance(v, dict):
            v = _from_dict(_NESTED[f.name], v)
        kwargs[f.name] = v
    return cls(**kwargs)


def load(path, cls=RenderConfig):
    """A ``RenderConfig`` (or ``cls``) from a JSON file."""
    return _from_dict(cls, json.loads(Path(path).read_text()))
