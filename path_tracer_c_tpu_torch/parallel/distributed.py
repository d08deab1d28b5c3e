"""Multi-process bring-up and a health check, on ``torch.distributed``.

Counterpart of ``path_tracer_c_tpu/parallel/distributed.py``: the process
group that a mesh spans (``parallel/mesh.py``), and a check that every
process and every device answers before a long render starts. Nothing here
reads a cluster's environment: the caller names the coordinator's address,
the number of processes and this process's rank.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

logger = logging.getLogger("path_tracer_c_tpu_torch.distributed")

__all__ = ["initialize", "health_check", "is_multi_host", "local_device_count"]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
):
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``, with the coordinator at ``coordinator_address``
    (``host:port``, or a URL such as ``tcp://localhost:29500``).

    A no-op for one process (``num_processes`` of 1 or None), as in the JAX
    package, and where the group is already up. ``backend``: NCCL by default
    where CUDA is available, gloo otherwise, or the one named (NCCL takes
    one process per card: two ranks on one card need gloo). A failed
    bring-up raises; nothing carries on in one process.
    """
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        logger.debug("distributed.initialize: the process group is already up")
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize: a group of several processes needs "
                         "coordinator_address and process_id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)
    logger.info("distributed init ok: process %d/%d, backend %s, %d local CUDA devices",
                process_id, num_processes, backend, local_device_count())


def is_multi_host() -> bool:
    """Whether a process group of more than one process is up."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def local_device_count() -> int:
    """The CUDA devices this process sees (0 without one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _collective_device(device: torch.device) -> torch.device:
    """Where a collective's tensor lies: on the CPU for gloo, on this
    process's card for NCCL."""
    if dist.get_backend() == "nccl":
        return device if device.type == "cuda" else torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def health_check(mesh=None) -> dict:
    """Every-device liveness probe before committing to a long render.

    Two stages: (1) a host -> device -> host round trip on every device of
    this process (those of the mesh's slots it owns; without a mesh, every
    visible CUDA device, else the CPU), (2) one all-reduce over every
    process of the group, of the slots (devices) each owns and a 1 from
    each: a missing or hung process fails here in seconds instead of
    minutes into a render. Returns a status dict for the metrics log, and
    raises if a stage fails.
    """
    if mesh is not None:
        owned = len(mesh.local())
        local = list(dict.fromkeys(s.device for _, _, s in mesh.local()))
    else:
        local = ([torch.device("cuda", i) for i in range(local_device_count())]
                 or [torch.device("cpu")])
        owned = len(local)
    local_ok = sum(float(torch.ones((), device=d).cpu()) for d in local) == float(len(local))
    counts = torch.tensor([float(owned), 1.0], dtype=torch.float64)
    processes = 1
    if dist.is_initialized():
        processes = dist.get_world_size()
        t = counts.to(_collective_device(local[0]))
        dist.all_reduce(t)
        counts = t.cpu()
    n, answered = int(counts[0]), int(counts[1])
    alive = local_ok and answered == processes and (mesh is None or n == mesh.size)
    status = {
        "devices": n,
        "local_devices": owned,
        "processes": processes,
        "alive": alive,
        "platform": local[0].type,
        "backend": dist.get_backend() if dist.is_initialized() else None,
    }
    if not alive:
        raise RuntimeError(f"health check failed: {status}")
    logger.info("health check ok: %s", status)
    return status
