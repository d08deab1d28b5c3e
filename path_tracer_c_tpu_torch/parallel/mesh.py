"""Device meshes for tile x spp sharded rendering.

Counterpart of ``path_tracer_c_tpu/parallel/mesh.py``: a small 2-D grid of
slots,

* ``tile``: image row blocks, one block of rows per slot;
* ``spp``: Monte-Carlo sample ranges, reduced by a mean in a fixed order
  (``parallel/render.py``).

A slot is a device of one process. Where ``torch.distributed`` is up the
mesh spans every process of the group: each process contributes its own
devices, rank after rank, and renders only the slots it owns. The slots are
laid out so that the ``spp`` axis, which every render reduces over, runs
over neighbouring devices of one process.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "Mesh", "Slot", "TILE_AXIS", "SPP_AXIS"]

TILE_AXIS = "tile"
SPP_AXIS = "spp"


@dataclass(frozen=True)
class Slot:
    """One position of the mesh: a device of the process of rank ``rank``."""

    rank: int
    device: torch.device


@dataclass(frozen=True)
class Mesh:
    """``slots[ti][si]``: the slot of row block ``ti`` and sample range
    ``si``; ``rank``: this process's rank (0 without a process group)."""

    slots: tuple
    rank: int = 0

    @property
    def shape(self) -> dict:
        return {TILE_AXIS: len(self.slots), SPP_AXIS: len(self.slots[0])}

    @property
    def size(self) -> int:
        return len(self.slots) * len(self.slots[0])

    @property
    def processes(self) -> int:
        return len({s.rank for row in self.slots for s in row})

    def flat(self) -> list:
        """``(ti, si, slot)`` of every slot, in slot order (tile-major)."""
        return [(ti, si, s) for ti, row in enumerate(self.slots) for si, s in enumerate(row)]

    def local(self) -> list:
        """``(ti, si, slot)`` of the slots this process owns, in slot order."""
        return [x for x in self.flat() if x[2].rank == self.rank]


def _group():
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _is_cpu(devices) -> bool:
    return isinstance(devices, (str, torch.device)) and torch.device(devices).type == "cpu"


def _local_devices(devices, positions, world) -> list:
    """This process's devices: every visible CUDA device (``None``), the
    CPU once for each of its share of ``positions`` (``"cpu"``), or the
    list given, as ``torch.device``s."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices='cpu' "
                               "to lay the mesh on the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if _is_cpu(devices):
        if positions % world:
            raise ValueError(f"{positions} CPU slots do not divide among {world} processes")
        return [torch.device("cpu")] * (positions // world)
    local = [torch.device(d) for d in devices]
    for d in local:
        if d.type == "cuda":
            index = torch.cuda.current_device() if d.index is None else d.index
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if index >= count:
                raise ValueError(f"make_mesh: {d} is not among the {count} visible CUDA devices")
        elif d.type != "cpu":
            raise ValueError(f"make_mesh: unsupported device {d}")
    return local


def make_mesh(tile: int | None = None, spp: int = 1, devices=None) -> Mesh:
    """Build a ``(tile, spp)`` mesh over the given devices.

    ``devices``: ``None`` takes every visible CUDA device of each process
    (it raises where there is none: the mesh never moves to the CPU by
    itself); ``"cpu"`` lays ``tile * spp`` slots on the CPU (``tile``
    defaults to 1), the counterpart of the JAX suite's fake CPU devices; a
    list names each of this process's slots and may name one device more
    than once, which is how a 4 x 2 mesh is laid on one card. With a process
    group up, every process contributes its devices, rank after rank.

    With only ``spp`` given, ``tile`` absorbs the remaining devices. A mesh
    that is not exactly the devices is refused, as the JAX package refuses
    it: it is never shrunk, and never mapped onto fewer devices.
    """
    rank, world = _group()
    positions = (1 if tile is None else tile) * spp
    local = _local_devices(devices, positions, world)
    if world > 1:
        names = [None] * world
        dist.all_gather_object(names, [str(d) for d in local])
        every = [Slot(r, torch.device(d)) for r, ds in enumerate(names) for d in ds]
    else:
        every = [Slot(0, d) for d in local]
    n = len(every)
    if tile is None:
        if n % spp:
            raise ValueError(f"{n} devices not divisible by spp={spp}")
        tile = n // spp
    if tile * spp != n:
        shown = ", ".join(str(s.device) for s in every)
        raise ValueError(f"tile*spp = {tile * spp} != {n} devices ({shown})")
    slots = tuple(tuple(every[ti * spp:(ti + 1) * spp]) for ti in range(tile))
    return Mesh(slots, rank)
