"""Batched ray-scene intersection (eager PyTorch).

Counterpart of ``path_tracer_c_tpu/ops/intersect.py``: every ray tests
every object, then one argmin picks the closest hit.

* sphere: the nearer non-negative root, ``t1 >= 0 ? t1 : (t2 >= 0 ? t2 :
  miss)``, computed in the sphere's frame;
* triangle: Moller-Trumbore with eps 1e-6, rejecting ``|det| < eps``,
  ``u < eps``, ``u > 1``, ``v < eps``, ``u + v > 1`` and ``t < eps``;
* spheres come before triangles in the argmin, and on a tie the first
  object wins;
* sphere normal ``normalize(p - center)``; triangle normal the face normal
  of ``cross(v0 - v1, v0 - v2)``, flipped to oppose the ray.

A miss is ``t = +inf``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..scene.scene import Scene
from .rng import _f32, sqrt_rn

__all__ = ["Hit", "ray_sphere_t", "ray_triangle_t", "trace", "rows"]

INF = float("inf")
_TRI_EPS = _f32(1e-6)
# The most elements of one-hot products a row sum holds at once on the card.
_ROW_SUM_CHUNK = 1 << 26


def _row_sums(idx, g, n: int):
    """(n, ...) the sums of ``g``'s entries over the positions where ``idx``
    names each row, by one-hot products summed over the rays: a fixed
    order, no atomics. Done for blocks of rows that keep each product under
    ``_ROW_SUM_CHUNK`` elements."""
    flat = g.reshape(g.shape[0], -1)
    per_row = max(1, flat.numel())
    step = max(1, _ROW_SUM_CHUNK // per_row)
    out = []
    for r0 in range(0, n, step):
        ids = torch.arange(r0, min(n, r0 + step), device=idx.device)
        hot = (idx[:, None] == ids[None, :]).to(g.dtype)
        out.append(torch.sum(hot[:, :, None] * flat[:, None, :], dim=0))
    return torch.cat(out).reshape(n, *g.shape[1:])


class _Rows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if g.device.type == "cpu":
            grad = torch.zeros((ctx.n, *g.shape[1:]), dtype=g.dtype, device=g.device)
            return grad.index_add_(0, idx, g), None
        return _row_sums(idx, g, ctx.n), None


def rows(table, idx):
    """``table[idx]`` for a (N,) integer ``idx``: the rows of a scene table
    that a batch of rays fetches, with a backward that gives the same bits
    on every run, so that a fit resumes bit for bit. Indexing's backward
    (``index_put_`` with accumulate) adds with atomics across threads on
    the CPU, and on the card sorts the indices and serialises the many
    repeats of a few rows; ``index_select``'s (``index_add_``) adds in
    index order on the CPU but with atomics on the card. So the backward is
    ``index_add_`` on the CPU and one-hot sums (``_row_sums``) on the
    card."""
    return _Rows.apply(table, idx)


@dataclass(frozen=True)
class Hit:
    """Batched ray-hit record."""

    t: torch.Tensor  # (N,) distance; +inf on miss
    point: torch.Tensor  # (N, 3)
    normal: torch.Tensor  # (N, 3) unit, opposing the ray for triangles
    material: torch.Tensor  # (N,) int32
    mask: torch.Tensor  # (N,) bool, True where the ray hit something
    is_sphere: torch.Tensor  # (N,) bool, winning object kind
    obj_idx: torch.Tensor  # (N,) int64, index within its kind's table


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _safe_normalize(v, eps=_f32(1e-20)):
    return v * torch.rsqrt(torch.clamp_min(_dot(v, v), eps))[..., None]


def _cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def ray_sphere_t(o, d, center, radius, active):
    """All-pairs ray/sphere distances: (N, 3) rays x (S,) spheres -> (N, S).

    The ray is moved into the sphere's frame before squaring: the expanded
    ``|o|^2 - 2 o.c + |c|^2`` form loses too much to cancellation in
    float32 for large distant spheres.
    """
    dd = _dot(d, d)[:, None]
    oc = o[:, None, :] - center[None, :, :]  # (N, S, 3)
    b = 2.0 * torch.sum(oc * d[:, None, :], dim=-1)
    c = torch.sum(oc * oc, dim=-1) - (radius * radius)[None, :]
    det = b * b - 4.0 * dd * c
    valid = det >= 0.0
    sq = sqrt_rn(torch.where(valid, torch.clamp_min(det, _f32(1e-30)), 1.0))
    inv_2a = 0.5 / dd
    t1 = (-b - sq) * inv_2a
    t2 = (-b + sq) * inv_2a
    t = torch.where(t1 >= 0.0, t1, torch.where(t2 >= 0.0, t2, INF))
    return torch.where(valid & active[None, :], t, INF)


def ray_triangle_t(o, d, v0, v1, v2, active):
    """All-pairs Moller-Trumbore distances: (N, 3) rays x (T,) -> (N, T)."""
    e1 = v1 - v0  # (T, 3)
    e2 = v2 - v0
    rce = _cross(d[:, None, :], e2[None, :, :])  # (N, T, 3)
    det = torch.sum(e1[None] * rce, dim=-1)
    nonparallel = torch.abs(det) >= _TRI_EPS
    inv = 1.0 / torch.where(nonparallel, det, 1.0)
    s = o[:, None, :] - v0[None, :, :]  # (N, T, 3)
    u = inv * torch.sum(s * rce, dim=-1)
    sce = _cross(s, e1[None, :, :])  # (N, T, 3)
    v = inv * torch.sum(d[:, None, :] * sce, dim=-1)
    t = inv * torch.sum(e2[None] * sce, dim=-1)
    ok = (
        nonparallel
        & (u >= _TRI_EPS)
        & (u <= 1.0)
        & (v >= _TRI_EPS)
        & (u + v <= 1.0)
        & (t >= _TRI_EPS)
        & active[None, :]
    )
    return torch.where(ok, t, INF)


def trace(o, d, scene: Scene) -> Hit:
    """Closest hit of a batch of rays against the whole scene."""
    S = scene.num_spheres
    sp, tr = scene.spheres, scene.triangles
    ts = ray_sphere_t(o, d, sp.center, sp.radius, sp.active)
    tt = ray_triangle_t(o, d, tr.v0, tr.v1, tr.v2, tr.active)
    t_all = torch.cat([ts, tt], dim=1)  # (N, S+T)
    idx = torch.argmin(t_all, dim=1)  # first minimum on ties
    t = torch.gather(t_all, 1, idx[:, None])[:, 0]
    mask = torch.isfinite(t)
    t_safe = torch.where(mask, t, 0.0)
    point = o + t_safe[:, None] * d

    is_sphere = idx < S
    sidx = torch.clamp(idx, 0, S - 1)
    tidx = torch.clamp(idx - S, 0, scene.num_triangles - 1)

    n_sphere = _safe_normalize(point - rows(sp.center, sidx))
    v0, v1, v2 = rows(tr.v0, tidx), rows(tr.v1, tidx), rows(tr.v2, tidx)
    n_tri = _safe_normalize(_cross(v0 - v1, v0 - v2))
    n_tri = torch.where((_dot(n_tri, d) < 0.0)[:, None], n_tri, -n_tri)

    normal = torch.where(is_sphere[:, None], n_sphere, n_tri)
    material = torch.where(is_sphere, sp.material[sidx], tr.material[tidx])
    return Hit(
        t=t, point=point, normal=normal, material=material, mask=mask,
        is_sphere=is_sphere, obj_idx=torch.where(is_sphere, sidx, tidx),
    )
