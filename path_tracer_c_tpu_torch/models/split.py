"""The reference GPU shader's deterministic two-branch SPLIT estimator
(eager PyTorch).

Counterpart of ``path_tracer_c_tpu/models/split.py``. At a transparent hit
the reference's shader pushes BOTH children onto a ray stack, reflection
weighted ``1 - t`` and refraction weighted ``t``: a deterministic convex
split, where the production tiers pick one branch at random (the same
expectation; the split has less variance for 0 < t < 1).

The stack becomes a breadth-first expansion: level ``b`` is a batch of
``N * 2^b`` rays, and the children of slot ``k`` land in slots ``2k``
(reflect) and ``2k + 1`` (refract). The node count equals the reference's
tree exactly; memory grows as ``2^max_bounces``, so the bounce budget is
capped (``MAX_BOUNCES``).

RNG contract: each node draws its roughness deviation from its own stream.
The reflect child inherits the parent's advanced state; the refract child
takes one PCG step off the parent's state XOR ``SPLIT_SALT``. At the last
level the children would exceed the budget, and their weighted sky is
added instead (the bounce-budget fold).

This is a parity and analysis tier, as in the JAX package: eager only, with
no kernel. The CLI's ``render --engine split`` reaches it, on one device.
"""

from __future__ import annotations

import torch

from ..ops import rng as _rng
from ..ops.camera import Camera, pixel_indices, primary_rays
from ..ops.intersect import trace
from ..ops.sampling import reflect, refract
from ..scene.scene import Scene
from .integrator import DEFAULT_EPS_OFFSET, EPS_OFFSET_SCALE

__all__ = ["trace_paths_split", "render_split", "SPLIT_SALT", "MAX_BOUNCES"]

# Decorrelating salt for the refract child's stream (see module doc).
SPLIT_SALT = 0x632BE59B
# Above this the levels would hold 2^max_bounces rays a camera ray.
MAX_BOUNCES = 10


def _child_state(state):
    """The refract child's RNG stream: one PCG step off a salted parent."""
    st, _ = _rng.pcg_next(state ^ SPLIT_SALT)
    return st


def _interleave(a, b):
    """Slot ``k``'s children at ``2k`` (from ``a``) and ``2k + 1`` (``b``)."""
    return torch.stack([a, b], dim=1).reshape((-1,) + tuple(a.shape[1:]))


def trace_paths_split(scene: Scene, origins, directions, state, max_bounces: int):
    """Split-estimator radiance (N, 3) for a batch of N camera rays
    (``origins``, unit ``directions``: (N, 3); ``state``: (N,) uint32 RNG
    states). Memory is O(N * 2^max_bounces); ``max_bounces`` above
    ``MAX_BOUNCES`` raises."""
    if max_bounces > MAX_BOUNCES:
        raise ValueError("split estimator: max_bounces > 10 would "
                         f"materialize 2^{max_bounces} paths per sample")
    n = origins.shape[0]
    sky = scene.sky_color[None, :]
    mats = scene.materials

    total = torch.zeros_like(origins)
    o, d, st = origins, directions, state
    w = torch.ones_like(origins)  # the node's weight (throughput)
    live = torch.ones((n,), dtype=torch.bool, device=origins.device)

    def fold(total, contrib):
        # Level b holds (n * 2^b, 3) contributions: sum the siblings of
        # each camera ray.
        return total + torch.sum(contrib.reshape(n, -1, 3), dim=1)

    for b in range(max_bounces + 1):
        hit = trace(o, d, scene)
        miss = live & ~hit.mask
        total = fold(total, torch.where(miss[:, None], w * sky, 0.0))
        alive = live & hit.mask

        # Emission, then albedo.
        m = hit.material.long()
        emission = mats.emission_color[m] * mats.emission_strength[m][:, None]
        total = fold(total, torch.where(alive[:, None], w * emission, 0.0))
        w = torch.where(alive[:, None], w * mats.albedo[m], w)

        # One unit-sphere draw a node: both children share the perturbed
        # normal.
        st, dev = _rng.unit_sphere(st)
        rough_n = hit.normal + mats.roughness[m][:, None] * dev
        rough_n = rough_n * torch.rsqrt(torch.clamp_min(
            torch.sum(rough_n * rough_n, -1, keepdim=True), _rng._f32(1e-20)))

        transp = mats.transparency[m]
        refl_d = reflect(d, rough_n)
        ndot = torch.sum(d * rough_n, dim=-1, keepdim=True)
        entering = ndot < 0.0
        ior = mats.refractive_index[m]
        eta = torch.where(entering[..., 0], 1.0 / ior, ior)[:, None]
        refr_nrm = torch.where(entering, rough_n, -rough_n)
        refr_d, tir = refract(d, refr_nrm, eta)

        # Children: reflect iff t < 1, refract iff t > 0 and no total
        # internal reflection; weights 1 - t and t.
        refl_alive = alive & (transp < 1.0)
        refr_alive = alive & (transp > 0.0) & ~tir
        refl_w = w * (1.0 - transp)[:, None]
        refr_w = w * transp[:, None]

        if b == max_bounces:
            # The children would exceed the bounce budget: their sky.
            total = fold(total, torch.where(refl_alive[:, None], refl_w * sky, 0.0))
            total = fold(total, torch.where(refr_alive[:, None], refr_w * sky, 0.0))
            break

        # Step off the surface along the normal, with the scale-adaptive
        # offset of the other tiers.
        p = hit.point
        offs = DEFAULT_EPS_OFFSET + EPS_OFFSET_SCALE * torch.sqrt(
            torch.clamp_min(torch.sum(p * p, dim=-1, keepdim=True), _rng._f32(1e-20)))
        side_r = torch.where(torch.sum(refl_d * hit.normal, -1, keepdim=True) >= 0.0, 1.0, -1.0)
        side_t = torch.where(torch.sum(refr_d * hit.normal, -1, keepdim=True) >= 0.0, 1.0, -1.0)

        o = _interleave(p + offs * side_r * hit.normal, p + offs * side_t * hit.normal)
        d = _interleave(refl_d, torch.where(tir[:, None], d, refr_d))
        w = _interleave(refl_w, refr_w)
        st = _interleave(st, _child_state(st))
        live = _interleave(refl_alive, refr_alive)

    return total


def render_split(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    sample_offset: int = 0,
):
    """Split-estimator radiance image (H, W, 3) float32 on the scene's
    device: the reference GPU shader's estimator (module docstring).
    Samples run one after another; memory scales with
    ``2^max_bounces``."""
    device = scene.device
    if camera.device != device:
        raise ValueError(f"camera on {camera.device}, scene on {device}")
    if max_bounces > MAX_BOUNCES:
        raise ValueError("split estimator: max_bounces > 10 would "
                         f"materialize 2^{max_bounces} paths per sample")
    pix = pixel_indices(height, width, device)
    o, d = primary_rays(camera, height, width)
    accum = torch.zeros((height * width, 3), dtype=torch.float32, device=device)
    for s in range(spp):
        st = _rng.seed_state(pix, s + sample_offset, seed)
        accum = accum + trace_paths_split(scene, o, d, st, max_bounces)
    return (accum / spp).reshape(height, width, 3)
