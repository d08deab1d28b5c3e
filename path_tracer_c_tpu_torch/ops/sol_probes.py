"""The speed-of-light probes: hand-written CUDA, and their plain PyTorch twins.

Two probes of ``csrc/sol_probes.cu``, which replace the Pallas TPU kernels
of ``scripts/sol_decompose.py``:

- ``sol_null`` (B7, for ``_null_kernel``): the forward kernel's launch
  (grid, blocks, scene and camera operands, output) doing nothing but write
  ``(sph[0], 0, 0)`` to every pixel. Its time prices a render's fixed cost:
  the operand packing, the launch, the blocks' start and end, the store.
- ``sol_micro`` (B8, for ``kern`` of ``_mk_micro``): per pixel, ``MICRO_REPS``
  x ``MICRO_NOBJ`` dependent steps ``x = ((x a + b) c + d) e + x`` with the
  five scalars of one object of a table, which the ``reload`` variant loads
  at every object, as the forward kernel loads its scene tables, and the
  ``hoisted`` one once, before the loop. The difference prices a table load.

On CUDA tensors the wrappers launch the kernels (the counters
``launch.sol_null`` and ``launch.sol_micro`` count them); on CPU tensors
they run the twins. Both probes equal their twins
value for value: B7 moves values, B8 issues each multiply and add
separately, as the twin does.
"""

from __future__ import annotations

import ctypes

import torch

from .camera import Camera
from .render_kernel import _camera_params, _check_inputs, _ptr, _scene_operands, _table_args
from .rng import _f32
from ..scene.scene import Scene
from ..utils.tracing import count

__all__ = ["sol_null", "sol_null_launcher", "sol_null_reference", "sol_micro",
           "sol_micro_reference",
           "micro_table", "MICRO_REPS", "MICRO_NOBJ", "SOURCE", "REPLACES", "REPLACES_MICRO"]

SOURCE = "path_tracer_c_tpu_torch/csrc/sol_probes.cu"
REPLACES = "scripts/sol_decompose.py:119"
REPLACES_MICRO = "scripts/sol_decompose.py:159"

MICRO_REPS = 200
MICRO_NOBJ = 8


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_cuda(device, name):
    if device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {device}")


def sol_null(scene: Scene, camera: Camera, height: int, width: int) -> torch.Tensor:
    """B7: ``(H, W, 3)`` float32 on the scene's device, every pixel
    ``(first sphere's centre x, 0, 0)``, through the forward kernel's
    operand packing and launch: what a render call costs beside its rounds.
    CUDA tensors launch the kernel, CPU tensors run ``sol_null_reference``."""
    _check_inputs(scene, camera, height, width, 1, 0, 0, 0)
    if scene.device.type == "cpu":
        return sol_null_reference(scene, camera, height, width)
    return sol_null_launcher(scene, camera, height, width)()


def sol_null_launcher(scene: Scene, camera: Camera, height: int, width: int):
    """B7 on operands packed once: a function of no arguments that launches
    the kernel and returns its image, so that a caller can time the kernel
    without the packing. Each call counts in ``launch.sol_null``. CUDA
    tensors only."""
    _check_inputs(scene, camera, height, width, 1, 0, 0, 0)
    device = scene.device
    _check_cuda(device, "sol_null")
    from .build import load_library

    lib = load_library()
    operands = _scene_operands(scene)
    par = _camera_params(camera, scene, height, width)
    args = (*_table_args(operands), _ptr(par))

    def launch() -> torch.Tensor:
        out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
        err = lib.sol_null(*args, _ptr(out), height, width, device.index, _stream(device))
        if err != 0:
            raise RuntimeError(f"sol_null kernel launch failed: CUDA error {err}")
        count("launch.sol_null")
        return out

    launch.operands = (operands, par)  # kept alive with the launcher
    return launch


def sol_null_reference(scene: Scene, camera: Camera, height: int, width: int) -> torch.Tensor:
    """Plain twin of B7, on the scene's device."""
    _check_inputs(scene, camera, height, width, 1, 0, 0, 0)
    sph = _scene_operands(scene)[0]
    out = torch.zeros((height, width, 3), dtype=torch.float32, device=scene.device)
    out[..., 0] = sph[0, 0]
    return out


def micro_table(device) -> torch.Tensor:
    """The probe's ``(MICRO_NOBJ, 5)`` float32 table: 0, 1e-3, 2e-3, ...,
    as ``scripts/sol_decompose.py`` builds it."""
    return (torch.arange(MICRO_NOBJ * 5, dtype=torch.float32, device=device)
            * _f32(1e-3)).reshape(MICRO_NOBJ, 5)


def _check_micro(table, seed, height, width, reps):
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] != 5:
        raise ValueError(f"table must be (n, 5) float32, not {tuple(table.shape)} {table.dtype}")
    if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != table.device:
        raise ValueError("seed must be one int32 on the table's device")
    if not (height >= 1 and width >= 1 and height * width < 2**31 and reps >= 0):
        raise ValueError(f"image {height}x{width} or reps {reps} out of range")


def sol_micro(table: torch.Tensor, seed: torch.Tensor, height: int, width: int,
              hoisted: bool, reps: int = MICRO_REPS) -> torch.Tensor:
    """B8: ``(H, W)`` float32, every pixel ``reps`` passes over the table's
    objects from ``x = float(seed) * 1e-6``. ``hoisted`` loads the table
    into registers once (it takes ``MICRO_NOBJ`` objects); otherwise every
    object's scalars are loaded where they are used. CUDA tensors launch the
    kernel, CPU tensors run ``sol_micro_reference``."""
    _check_micro(table, seed, height, width, reps)
    if hoisted and table.shape[0] != MICRO_NOBJ:
        raise ValueError(f"the hoisted variant takes {MICRO_NOBJ} objects, not {table.shape[0]}")
    device = table.device
    if device.type == "cpu":
        return sol_micro_reference(table, seed, height, width, reps)
    _check_cuda(device, "sol_micro")
    from .build import load_library

    lib = load_library()
    table, seed = table.contiguous(), seed.contiguous()
    out = torch.empty((height, width), dtype=torch.float32, device=device)
    err = lib.sol_micro(_ptr(table), _ptr(seed), _ptr(out), height, width, table.shape[0],
                        int(reps), int(bool(hoisted)), device.index, _stream(device))
    if err != 0:
        raise RuntimeError(f"sol_micro kernel launch failed: CUDA error {err}")
    count("launch.sol_micro")
    return out


def sol_micro_reference(table: torch.Tensor, seed: torch.Tensor, height: int, width: int,
                        reps: int = MICRO_REPS) -> torch.Tensor:
    """Plain twin of B8 (either variant), on the table's device."""
    _check_micro(table, seed, height, width, reps)
    x = seed.reshape(()).to(torch.float32) * _f32(1e-6)
    x = x.expand(height, width).contiguous()
    rows = table.unbind(0)
    for _ in range(reps):
        for a, b, c, d, e in (row.unbind(0) for row in rows):
            x = ((x * a + b) * c + d) * e + x
    return x
