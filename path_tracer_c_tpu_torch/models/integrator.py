"""Wavefront path-tracing integrator (eager PyTorch, reference tier).

Counterpart of ``path_tracer_c_tpu/models/integrator.py`` with its "gpu"
variant: every pixel-sample advances one bounce per loop iteration, and
terminated rays are masked lanes. Per bounce: closest hit; sky on a miss;
emission, then albedo; a roughness-perturbed normal; refraction chosen
with probability ``transparency`` (single-path selection, unbiased for the
reference's two-branch estimator), reflection otherwise; a refracted ray
that meets total internal reflection dies. The sky is added again when
the bounce budget runs out, after ``max_bounces + 1`` trace rounds.

Exactly 3 PCG draws per ray per bounce (2 for the unit sphere, 1 for the
branch), drawn unconditionally, so this path, the JAX package and the
CUDA kernel (``ops/render_kernel.py``) consume the same streams.

``variant="cpu"`` is the reference's CPU tier instead: the biased cube
sampler (3 draws for the sphere, so 4 a bounce), the normal perturbed by
half the roughness, every refractive index 1.5, and each sample's radiance
clamped to [0, 1]. It exists here only, not in the kernel.

This is the eager spec; the main path's speed comes from the hand kernel.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import rng as _rng
from ..ops.camera import Camera, check_rows, pixel_indices, primary_rays
from ..ops.intersect import trace
from ..ops.rng import _f32, sqrt_rn
from ..ops.sampling import perturb_normal, reflect, refract
from ..scene.scene import Scene

__all__ = [
    "trace_paths",
    "render_tile",
    "render_radiance",
    "render_bounce_stats",
    "render_image_u8",
    "DEFAULT_EPS_OFFSET",
    "EPS_OFFSET_SCALE",
]

_STAT_KEYS = ("hits", "misses", "tir_deaths")
DEFAULT_EPS_OFFSET = _f32(1e-4)
EPS_OFFSET_SCALE = _f32(4e-6)  # extra offset per unit |hit point|


def trace_paths(scene: Scene, origins, directions, state, max_bounces: int,
                count_rounds: bool = False, collect_stats: bool = False,
                variant: str = "gpu"):
    """Incident radiance for a batch of rays.

    ``origins``/``directions`` are (N, 3) (unit directions), ``state`` the
    (N,) uint32 RNG state (see ``ops.rng``). Returns ``(radiance (N, 3),
    final state)``; with ``count_rounds`` also the number of ray-rounds
    that began alive (an int64 scalar tensor): a ray stays alive until it
    misses or dies of total internal reflection, which is the fused
    kernel's exit rule (``ops/render_grad.py``). With ``collect_stats``
    the last item returned is a dict of per-bounce ``(max_bounces + 1,)``
    int64 event counts: ``hits`` (rays shaded), ``misses`` (sky exits) and
    ``tir_deaths`` (refracted rays that met total internal reflection).

    Differentiable by ``torch.autograd`` in the material leaves and the
    sky. Every random decision is detached: the branch compares against
    ``transparency.detach()``, and the ratio factor below re-attaches its
    derivative.

    ``variant``: ``"gpu"`` (the reference's shader) or ``"cpu"`` (its CPU
    tier, see the module docstring).
    """
    if variant not in ("gpu", "cpu"):
        raise ValueError(f"unknown variant {variant!r}")
    cpu_tier = variant == "cpu"
    n = origins.shape[0]
    sky = scene.sky_color[None, :]
    mats = scene.materials
    o, d, st = origins, directions, state
    thr = torch.ones_like(origins)
    total = torch.zeros_like(origins)
    alive = torch.ones((n,), dtype=torch.bool, device=origins.device)
    rounds = torch.zeros((), dtype=torch.int64, device=origins.device)
    stats = {k: [] for k in _STAT_KEYS}

    for _ in range(max_bounces + 1):
        if count_rounds:
            rounds = rounds + alive.sum()
        hit = trace(o, d, scene)
        miss_now = alive & ~hit.mask
        total = total + torch.where(miss_now[:, None], thr * sky, 0.0)
        alive = alive & hit.mask
        hit_now = alive
        live = alive[:, None]

        m = hit.material.long()
        albedo = mats.albedo[m]
        emission = mats.emission_color[m] * mats.emission_strength[m][:, None]
        rough = mats.roughness[m]
        transp = mats.transparency[m]
        ior = mats.refractive_index[m]
        if cpu_tier:
            rough = rough * 0.5
            ior = torch.full_like(ior, 1.5)

        total = total + torch.where(live, thr * emission, 0.0)
        thr = torch.where(live, thr * albedo, thr)

        st, sph = (_rng.unit_sphere_biased if cpu_tier else _rng.unit_sphere)(st)
        st, u_branch = _rng.uniform(st)

        nrm = perturb_normal(hit.normal, sph, rough)
        refl_dir = reflect(d, nrm)

        ndot = torch.sum(d * nrm, dim=-1, keepdim=True)
        entering = ndot < 0.0
        eta = torch.where(entering[..., 0], 1.0 / ior, ior)[:, None]
        refr_normal = torch.where(entering, nrm, -nrm)
        refr_dir, tir = refract(d, refr_normal, eta)

        # The branch is chosen against the detached transparency, and the
        # ratio is 1 in value wherever the chosen branch has probability
        # >= 1e-6; its derivative, 1/t on the refracted branch and
        # -1/(1-t) on the reflected one, is that of the reference's t and
        # (1-t) branch weights.
        transp_d = transp.detach()
        choose_refr = u_branch < transp_d
        ratio = torch.where(
            choose_refr,
            transp / torch.clamp_min(transp_d, _f32(1e-6)),
            (1.0 - transp) / torch.clamp_min(1.0 - transp_d, _f32(1e-6)),
        )
        thr = torch.where(live, thr * ratio[:, None], thr)

        new_d = torch.where(choose_refr[:, None], refr_dir, refl_dir)
        died = choose_refr & tir
        alive = alive & ~died
        live = alive[:, None]
        new_d = torch.where(died[:, None], d, new_d)
        # Step off the surface along the geometric normal, towards the side
        # the ray leaves on, by an amount that grows with |p|: a fixed 1e-4
        # is below float32 round-off for large or distant geometry.
        p = hit.point
        offs = DEFAULT_EPS_OFFSET + EPS_OFFSET_SCALE * sqrt_rn(
            torch.clamp_min(torch.sum(p * p, dim=-1, keepdim=True), _f32(1e-20))
        )
        side = torch.where(
            torch.sum(new_d * hit.normal, dim=-1, keepdim=True) >= 0.0, 1.0, -1.0
        )
        new_o = p + offs * side * hit.normal
        o = torch.where(live, new_o, o)
        d = torch.where(live, new_d, d)
        if collect_stats:
            for key, mask in zip(_STAT_KEYS, (hit_now, miss_now, hit_now & died)):
                stats[key].append(mask.sum())

    total = total + torch.where(alive[:, None], thr * sky, 0.0)
    if cpu_tier:
        total = torch.clamp(total, 0.0, 1.0)
    out = (total, st) + ((rounds,) if count_rounds else ())
    if collect_stats:
        out += ({k: torch.stack(v) for k, v in stats.items()},)
    return out


def render_tile(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    jitter: bool = False,
    sample_offset: int = 0,
    remat: bool = False,
    variant: str = "gpu",
    row_start: int = 0,
    rows: int | None = None,
):
    """Monte-Carlo radiance of a row block, (rows, W, 3) float32 mean over
    ``spp`` samples.

    Samples run one after another, each a batch over the block's pixels.
    ``height`` is the full image height; ``row_start`` and ``rows``
    (default: the whole image) select the block, the unit of image
    sharding (``parallel/render.py``). RNG streams key on global pixel and
    sample indices, so a block equals the same rows of the whole image, and
    ``sample_offset`` shifts the sample indices, so a render split into
    sample ranges sums to the unsplit one.

    ``remat=True`` runs each sample under ``torch.utils.checkpoint``:
    backward recomputes the sample's bounces instead of keeping their
    intermediates, so autograd's memory holds one sample's at a time. The
    values and gradients do not change. ``variant``: see ``trace_paths``.
    """
    device = scene.device
    if camera.device != device:
        raise ValueError(f"camera on {camera.device}, scene on {device}")
    rows = check_rows(height, row_start, rows)
    pix = pixel_indices(height, width, device, row_start, rows)
    rays = primary_rays(camera, height, width, row_start=row_start, rows=rows)
    accum = torch.zeros((rows * width, 3), dtype=torch.float32, device=device)

    def one_sample(s):
        st = _rng.seed_state(pix, s + sample_offset, seed)
        if jitter:
            o, d, st = primary_rays(camera, height, width, st, row_start=row_start, rows=rows)
        else:
            o, d = rays
        return trace_paths(scene, o, d, st, max_bounces, variant=variant)[0]

    for s in range(spp):
        radiance = (checkpoint(one_sample, s, use_reentrant=False) if remat
                    else one_sample(s))
        accum = accum + radiance
    return (accum / spp).reshape(rows, width, 3)


def render_radiance(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    jitter: bool = False,
    sample_offset: int = 0,
    remat: bool = False,
    variant: str = "gpu",
):
    """Full-image radiance, (H, W, 3) float32, on the scene's device; see
    ``render_tile``."""
    return render_tile(
        scene, camera, height, width, spp, max_bounces, seed,
        jitter=jitter, sample_offset=sample_offset, remat=remat, variant=variant,
    )


def render_bounce_stats(scene: Scene, camera: Camera, height: int, width: int,
                        spp: int, max_bounces: int, seed):
    """Per-bounce event histogram of a full render (no jitter): a dict of
    ``(max_bounces + 1,)`` int64 tensors on the scene's device, summed over
    pixels and samples, keyed ``hits``, ``misses`` and ``tir_deaths`` (see
    ``trace_paths``). Samples run one after another, so memory stays
    O(H * W) at any spp."""
    device = scene.device
    if camera.device != device:
        raise ValueError(f"camera on {camera.device}, scene on {device}")
    pix = pixel_indices(height, width, device)
    o, d = primary_rays(camera, height, width)
    acc = {k: torch.zeros(max_bounces + 1, dtype=torch.int64, device=device)
           for k in _STAT_KEYS}
    for s in range(spp):
        st = _rng.seed_state(pix, s, seed)
        stats = trace_paths(scene, o, d, st, max_bounces, collect_stats=True)[-1]
        acc = {k: acc[k] + stats[k] for k in acc}
    return acc


def render_image_u8(radiance: torch.Tensor) -> torch.Tensor:
    """Radiance -> RGB8: clamp to [0, 1], scale by 255, round half to even."""
    return torch.round(torch.clamp(radiance, 0.0, 1.0) * 255.0).to(torch.uint8)
