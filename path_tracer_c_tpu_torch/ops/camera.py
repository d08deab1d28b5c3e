"""Pinhole camera: pixel grid -> primary rays.

Counterpart of ``path_tracer_c_tpu/ops/camera.py``: eye at ``origin``,
direction ``normalize(x tan(fov/2) right + y tan(fov/2)/aspect up +
forward)`` with ``aspect = W / H``, pixel centres, row 0 at the top of the
image. With a jitter state, two uniforms per pixel replace the centre
offset, in the same draw order as the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import rng as _rng

__all__ = ["Camera", "primary_rays", "pixel_indices", "check_rows"]


@dataclass(frozen=True)
class Camera:
    """Position, orthonormal frame and field of view (radians), float32."""

    origin: torch.Tensor  # (3,)
    right: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    forward: torch.Tensor  # (3,)
    fov: torch.Tensor  # () radians

    @property
    def device(self) -> torch.device:
        return self.origin.device

    @staticmethod
    def reference(device, fov_deg: float = 90.0) -> "Camera":
        """The reference's fixed camera: origin, looking down +z."""
        return Camera.from_arrays(
            dict(
                origin=np.zeros(3),
                right=np.array([1.0, 0.0, 0.0]),
                up=np.array([0.0, 1.0, 0.0]),
                forward=np.array([0.0, 0.0, 1.0]),
                fov=np.deg2rad(fov_deg),
            ),
            device,
        )

    @staticmethod
    def look_at(
        origin, target, device, up=(0.0, 1.0, 0.0), fov_deg: float = 90.0
    ) -> "Camera":
        f32 = dict(dtype=torch.float32, device=device)
        origin = torch.as_tensor(origin, **f32)
        fwd = torch.as_tensor(target, **f32) - origin
        fwd = fwd / torch.linalg.norm(fwd)
        right = torch.linalg.cross(torch.as_tensor(up, **f32), fwd)
        right = right / torch.linalg.norm(right)
        return Camera(
            origin=origin,
            right=right,
            up=torch.linalg.cross(fwd, right),
            forward=fwd,
            fov=torch.tensor(np.float32(np.deg2rad(fov_deg)), device=device),
        )

    @staticmethod
    def from_arrays(d: dict, device) -> "Camera":
        """Camera on ``device`` from numpy values under the JAX field names
        (``origin``, ``right``, ``up``, ``forward``: (3,); ``fov``: ())."""
        vals = {}
        for name, shape in (("origin", (3,)), ("right", (3,)), ("up", (3,)),
                            ("forward", (3,)), ("fov", ())):
            a = np.array(d[name], dtype=np.float32)
            if a.shape != shape:
                raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
            vals[name] = torch.from_numpy(a).to(device)
        return Camera(**vals)


def check_rows(height: int, row_start: int, rows: int | None) -> int:
    """The row count of the block of ``rows`` rows (None: the rest of the
    image) from ``row_start`` of an image ``height`` rows high; raises
    unless ``0 <= row_start``, ``rows >= 1`` and ``row_start + rows <=
    height``."""
    row_start = int(row_start)
    rows = height - row_start if rows is None else int(rows)
    if row_start < 0 or rows < 1 or row_start + rows > height:
        raise ValueError(f"row block of {rows} rows from row {row_start} is outside "
                         f"an image of {height} rows")
    return rows


def pixel_indices(height: int, width: int, device, row_start: int = 0,
                  rows: int | None = None) -> torch.Tensor:
    """Global row-major pixel index of every pixel of the row block of
    ``rows`` rows (default: all) from ``row_start``, int64 (rows*W,). The
    RNG is keyed on it, so a row block keeps each pixel's stream."""
    rows = height if rows is None else rows
    return row_start * width + torch.arange(rows * width, dtype=torch.int64, device=device)


def primary_rays(camera: Camera, height: int, width: int, jitter_state=None,
                 row_start: int = 0, rows: int | None = None):
    """Camera rays for a block of image rows, ``(origins (N, 3), dirs (N,
    3))`` with N = rows*W, row-major from the block's top-left pixel, on the
    camera's device. ``height`` is the full image height (it sets the NDC
    mapping and the aspect); ``row_start`` and ``rows`` (default: all)
    select the block.

    With ``jitter_state`` (a uint32 state per pixel, see ``ops.rng``),
    sub-pixel uniforms replace the pixel centre and the advanced state is
    returned as a third value.
    """
    device = camera.device
    aspect = _rng._f32(width / height)
    tan_fov_2 = torch.tan(camera.fov * 0.5)

    rows = height if rows is None else rows
    px = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    py = torch.arange(row_start, row_start + rows, dtype=torch.float32, device=device)[:, None]
    px = px.expand(rows, width).reshape(-1)
    py = py.expand(rows, width).reshape(-1)

    if jitter_state is not None:
        jitter_state, jx = _rng.uniform(jitter_state)
        jitter_state, jy = _rng.uniform(jitter_state)
    else:
        jx = jy = 0.5

    x = (px + jx) / float(width) * 2.0 - 1.0
    y = -((py + jy) / float(height) * 2.0 - 1.0)

    d_cam_x = x * tan_fov_2
    d_cam_y = y * tan_fov_2 / aspect
    d = (
        d_cam_x[:, None] * camera.right[None, :]
        + d_cam_y[:, None] * camera.up[None, :]
        + camera.forward[None, :]
    )
    d = d * torch.rsqrt(torch.sum(d * d, dim=-1, keepdim=True))
    o = camera.origin[None, :].expand(d.shape)
    if jitter_state is not None:
        return o, d, jitter_state
    return o, d
