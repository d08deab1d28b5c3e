"""Parallel layer: device meshes, tile/spp-sharded rendering and training
steps, and the process group they span (``torch.distributed``)."""
from .mesh import make_mesh, Mesh, Slot, TILE_AXIS, SPP_AXIS
from .render import render_sharded, replicate_scene, make_train_step
from . import distributed

__all__ = [
    "make_mesh", "Mesh", "Slot", "TILE_AXIS", "SPP_AXIS",
    "render_sharded", "replicate_scene", "make_train_step", "distributed",
]
