"""Physically based shading tier (eager PyTorch): importance-sampled BRDF
and next-event estimation.

Counterpart of ``path_tracer_c_tpu/models/physical.py``. Same scene schema
as the reference tier, read differently:

* albedo: Lambert reflectance (f = albedo / pi) and the specular tint;
* roughness: the probability of the diffuse lobe; the mirror lobe has
  probability ``1 - roughness``;
* transparency / refractive_index: the refraction branch of the reference
  tier;
* emission: Le.

Estimator: cosine-weighted hemisphere sampling for the diffuse lobe (cos /
pdf cancels to exactly ``albedo``), the mirror direction for the specular
lobe. At every diffuse vertex one emissive sphere is sampled by its cone
of directions, a shadow ray is cast, and ``thr * albedo/pi * Le * cos *
n_emitters / pdf`` is added (next-event estimation, NEE). The radiance
such an emitter would add through a diffuse-sampled ray is skipped at the
next vertex (single counting); specular and refracted chains and camera
rays collect Le directly. Emissive triangles are collected directly by
default; ``tri_nee=True`` adds them to the pool, sampled uniformly by
area.

RNG: a fixed schedule of 7 draws per bounce (u_transp, u_lobe, 2 for the
BSDF, 1 emitter pick, 2 for the emitter), drawn by every ray, so this
path, the JAX package and the CUDA kernel (``ops/render_physical.py``)
consume the same streams.

The tier is differentiable under ``torch.autograd``, geometry included
(the cosine and solid-angle factors depend on it continuously), and is
the autograd oracle of the physical kernels. Every random decision is
detached; three floors exist only to keep reverse mode finite through
masked branches and change no value.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import rng as _rng
from ..ops.camera import Camera, check_rows, pixel_indices, primary_rays
from ..ops.intersect import ray_sphere_t, rows, trace
from ..ops.rng import _f32, sqrt_rn
from ..ops.sampling import reflect, refract
from ..scene.scene import Scene
from .integrator import DEFAULT_EPS_OFFSET, EPS_OFFSET_SCALE

__all__ = ["trace_paths_physical", "render_physical", "render_bounce_stats_physical"]

_TWO_PI = _f32(2.0 * math.pi)
_SIN2_CAP = _f32(1.0 - 1e-7)
_VIS_SCALE = _f32(1.0 - 1e-3)
_VIS_SLACK = _f32(1e-4)

_STAT_KEYS = ("hits", "misses", "tir_deaths")
_NEE_STAT_KEYS = ("nee_candidates", "nee_visible")


def _refuse(kwargs):
    for name in kwargs:
        if name != "vma_axes":
            raise TypeError(f"unexpected argument {name!r}")
        raise TypeError(
            "vma_axes types a render's values by mesh axis under JAX's shard_map; "
            "PyTorch has no counterpart, and parallel/render.py shards without it")


def _onb(n):
    """Branchless orthonormal basis around unit ``n`` (Duff et al. 2017)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bv = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bv


def _cosine_hemisphere(n, u1, u2):
    """Cosine-weighted direction about ``n``; pdf = cos(theta) / pi."""
    r = sqrt_rn(u1)
    c, s = _rng.sincos_2pi(u2)
    lz = sqrt_rn(torch.clamp_min(1.0 - u1, 0.0))
    t, b = _onb(n)
    return (r * c)[..., None] * t + (r * s)[..., None] * b + lz[..., None] * n


def _emitter_pool(mats, table):
    """Live emitters of a sphere or triangle table: the cumulative count
    per row (int64) and the total."""
    mask = table.active & (mats.emission_strength[table.material.long()] > 0.0)
    cum = torch.cumsum(mask.to(torch.int64), dim=0)
    return cum, mask.sum()


def _pick(cum, k, rows):
    """Row of the ``k``-th live emitter (``k`` from 0): the first row whose
    cumulative count reaches ``k + 1``, clipped into the table. With no
    emitter the last row comes back, and the caller masks the term."""
    return torch.searchsorted(cum, k + 1, right=False).clamp(0, max(rows - 1, 0))


def trace_paths_physical(
    scene: Scene,
    origins,
    directions,
    state,
    max_bounces: int,
    nee: bool = True,
    rough_grad: bool = False,
    tri_nee: bool = False,
    count_rounds: bool = False,
    collect_stats: bool = False,
    **unported,
):
    """Physical-tier radiance for a batch of rays: ``(radiance (N, 3),
    final RNG state)``; see the module docstring.

    ``tri_nee=True`` makes the emitter pick uniform over sphere and
    triangle emitters; a triangle is sampled uniformly by area from the
    same two draws the sphere cone uses, with the area pdf converted to
    solid angle (``dist^2 / (area |cos_l|)``, two-sided emission), and its
    direct Le is single-counted on diffuse arrivals like a sphere's.

    ``rough_grad=True`` multiplies the throughput by ``p_lobe /
    p_lobe.detach()``: the value stays exactly as it was, and the
    derivative is the score-function estimate of d/d(roughness).

    ``count_rounds=True`` also returns the ray-rounds that began with
    nonzero throughput (an int64 scalar tensor): the rounds a thread of the
    CUDA kernel runs.

    ``collect_stats=True`` also returns, last, a dict of per-bounce
    ``(max_bounces + 1,)`` int64 event counts: ``hits``, ``misses`` and
    ``tir_deaths`` as in ``models.integrator.trace_paths`` (here every
    refraction that meets total internal reflection counts, as in the JAX
    package), and with ``nee`` the diffuse vertices that attempted a light
    sample (``nee_candidates``) and the shadow rays among them that reached
    the emitter (``nee_visible``).
    """
    _refuse(unported)
    n = origins.shape[0]
    dev = origins.device
    sky = scene.sky_color[None, :]
    mats, sph, tri = scene.materials, scene.spheres, scene.triangles
    pi = torch.tensor(_f32(math.pi), device=dev)  # a tensor: see ops/render_kernel._camera_dir

    em_cum, n_em = _emitter_pool(mats, sph)
    n_em_t = torch.zeros((), dtype=torch.int64, device=dev)
    if tri_nee:
        tri_cum, n_em_t = _emitter_pool(mats, tri)
        tri_cross = torch.linalg.cross(tri.v1 - tri.v0, tri.v2 - tri.v0)
        tri_2area = sqrt_rn(torch.clamp_min(torch.sum(tri_cross * tri_cross, -1), _f32(1e-20)))
        tri_nrm = tri_cross / tri_2area[:, None]
        tri_area = 0.5 * tri_2area
    if scene.num_triangles == 0:
        tri_nee = False  # nothing to sample
    n_tot = n_em + n_em_t

    o, d, st = origins, directions, state
    thr = torch.ones_like(origins)
    total = torch.zeros_like(origins)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_diff = torch.zeros((n,), dtype=torch.bool, device=dev)
    rounds = torch.zeros((), dtype=torch.int64, device=dev)
    stats = {k: [] for k in _STAT_KEYS + (_NEE_STAT_KEYS if nee else ())}

    for _ in range(max_bounces + 1):
        if count_rounds:
            rounds = rounds + (alive & (thr.detach() != 0.0).any(dim=-1)).sum()
        alive_in = alive
        hit = trace(o, d, scene)
        miss_now = alive & ~hit.mask
        total = total + torch.where(miss_now[:, None], thr * sky, 0.0)
        alive = alive & hit.mask
        live = alive[:, None]

        # Table rows are fetched by ``rows``, whose backward sums the
        # many repeats of a few rows in parallel and in a fixed order.
        m = hit.material.long()
        albedo = rows(mats.albedo, m)
        est = rows(mats.emission_strength, m)
        emission = rows(mats.emission_color, m) * est[:, None]
        rough = rows(mats.roughness, m)
        transp = rows(mats.transparency, m)
        ior = rows(mats.refractive_index, m)

        # Le, skipped where a diffuse-sampled ray arrives at an emitter the
        # previous vertex could have light-sampled.
        nee_counted = torch.zeros_like(prev_diff)
        if nee:
            nee_counted = prev_diff & hit.is_sphere & (est > 0.0) & (n_em > 0)
            if tri_nee:
                nee_counted = nee_counted | (
                    prev_diff & hit.mask & ~hit.is_sphere & (est > 0.0) & (n_em_t > 0))
        add_le = alive & ~nee_counted
        total = total + torch.where(add_le[:, None], thr * emission, 0.0)

        st, u_transp = _rng.uniform(st)
        st, u_lobe = _rng.uniform(st)
        st, u1 = _rng.uniform(st)
        st, u2 = _rng.uniform(st)
        st, u_pick = _rng.uniform(st)
        st, v1 = _rng.uniform(st)
        st, v2 = _rng.uniform(st)

        nrm = hit.normal  # geometric, already opposing the ray

        # Branches are chosen against detached probabilities; the ratios
        # are 1 in value and re-attach the derivative of the branch weight.
        transp_d, rough_d = transp.detach(), rough.detach()
        choose_refr = u_transp < transp_d
        choose_diff = ~choose_refr & (u_lobe < rough_d)
        ratio = torch.where(
            choose_refr,
            transp / torch.clamp_min(transp_d, _f32(1e-6)),
            (1.0 - transp) / torch.clamp_min(1.0 - transp_d, _f32(1e-6)),
        )
        thr = torch.where(live, thr * ratio[:, None], thr)
        if rough_grad:
            lobe_ratio = torch.where(
                choose_diff,
                rough / torch.clamp_min(rough_d, _f32(1e-6)),
                (1.0 - rough) / torch.clamp_min(1.0 - rough_d, _f32(1e-6)),
            )
            lobe_ratio = torch.where(choose_refr, 1.0, lobe_ratio)
            thr = torch.where(live, thr * lobe_ratio[:, None], thr)

        ndot = torch.sum(d * nrm, dim=-1, keepdim=True)
        entering = ndot < 0.0
        eta = torch.where(entering[..., 0], 1.0 / ior, ior)[:, None]
        refr_normal = torch.where(entering, nrm, -nrm)
        refr_dir, tir = refract(d, refr_normal, eta)
        spec_dir = reflect(d, nrm)
        diff_dir = _cosine_hemisphere(nrm, u1, u2)

        new_d = torch.where(
            choose_refr[:, None], refr_dir,
            torch.where(choose_diff[:, None], diff_dir, spec_dir),
        )
        died = choose_refr & tir
        alive = alive & ~died
        live = alive[:, None]
        new_d = torch.where(died[:, None], d, new_d)

        p = hit.point
        # The floor keeps d(sqrt)/dp finite on miss lanes (p = 0); it is
        # below float32 resolution of the 1e-4 offset.
        offs = DEFAULT_EPS_OFFSET + EPS_OFFSET_SCALE * sqrt_rn(
            torch.clamp_min(torch.sum(p * p, dim=-1, keepdim=True), _f32(1e-20))
        )
        shadow_o = p + offs * nrm

        if nee:
            pool = n_tot if tri_nee else n_em
            k = torch.minimum(
                torch.clamp_min(torch.floor(u_pick * pool).to(torch.int64), 0),
                torch.clamp_min(pool - 1, 0),
            )
            e_idx = _pick(em_cum, k, scene.num_spheres)
            c_e = rows(sph.center, e_idx)
            r_e = rows(sph.radius, e_idx)
            m_e = sph.material[e_idx].long()
            le_e = (rows(mats.emission_color, m_e)
                    * rows(mats.emission_strength, m_e)[:, None])

            dc = c_e - shadow_o
            d2 = torch.sum(dc * dc, dim=-1)
            d2_safe = torch.clamp_min(d2, _f32(1e-12))
            dist = sqrt_rn(d2_safe)
            wz = dc / dist[:, None]
            # Capped strictly below 1: at 1 the root's gradient is infinite
            # and would reach lanes that `outside` masks.
            sin2max = torch.clamp(r_e * r_e / d2_safe, 0.0, _SIN2_CAP)
            cosmax = sqrt_rn(1.0 - sin2max)
            outside = d2 > r_e * r_e
            # cos(theta) uniform in [cosmax, 1]; the floor keeps
            # d(sth)/d(cth) finite at cth -> 1.
            cth = 1.0 - v1 * (1.0 - cosmax)
            sth = sqrt_rn(torch.clamp_min(1.0 - cth * cth, _f32(1e-12)))
            cphi, sphi = _rng.sincos_2pi(v2)
            t_ax, b_ax = _onb(wz)
            omega = ((sth * cphi)[:, None] * t_ax + (sth * sphi)[:, None] * b_ax
                     + cth[:, None] * wz)
            pdf_omega = 1.0 / torch.clamp_min(_TWO_PI * (1.0 - cosmax), _f32(1e-8))
            cos_surf = torch.sum(nrm * omega, dim=-1)

            # Distance at which the shadow ray meets the sampled emitter.
            t_e = torch.gather(
                ray_sphere_t(shadow_o, omega, sph.center, sph.radius, sph.active),
                1, e_idx[:, None])[:, 0]

            if tri_nee:
                kt = torch.minimum(torch.clamp_min(k - n_em, 0), torch.clamp_min(n_em_t - 1, 0))
                t_idx = _pick(tri_cum, kt, scene.num_triangles)
                is_tri = (k >= n_em) & (n_em_t > 0)
                su = sqrt_rn(v1)
                b1 = su * (1.0 - v2)
                b2 = su * v2
                b0 = 1.0 - su
                q = (b0[:, None] * rows(tri.v0, t_idx) + b1[:, None] * rows(tri.v1, t_idx)
                     + b2[:, None] * rows(tri.v2, t_idx))
                dq = q - shadow_o
                d2t = torch.sum(dq * dq, dim=-1)
                d2t_safe = torch.clamp_min(d2t, _f32(1e-12))
                dist_t = sqrt_rn(d2t_safe)
                omega_t = dq / dist_t[:, None]
                cos_l = torch.abs(torch.sum(rows(tri_nrm, t_idx) * omega_t, dim=-1))
                w_tri_geom = rows(tri_area, t_idx) * cos_l / d2t_safe
                m_t = tri.material[t_idx].long()
                le_t = (rows(mats.emission_color, m_t)
                        * rows(mats.emission_strength, m_t)[:, None])
                itc = is_tri[:, None]
                omega = torch.where(itc, omega_t, omega)
                cos_surf = torch.where(is_tri, torch.sum(nrm * omega_t, dim=-1), cos_surf)
                t_e = torch.where(is_tri, dist_t, t_e)
                le_e = torch.where(itc, le_t, le_e)
                pool_ok = n_tot > 0
                branch_ok = torch.where(is_tri, cos_l > _f32(1e-6), outside)
                weight = torch.where(
                    is_tri, cos_surf * w_tri_geom, cos_surf / pdf_omega,
                ) * n_tot.to(torch.float32)
            else:
                pool_ok = n_em > 0
                branch_ok = outside
                weight = cos_surf / pdf_omega * n_em.to(torch.float32)

            # Unoccluded: the shadow ray's closest hit is the emitter itself.
            s_hit = trace(shadow_o, omega, scene)
            visible = (s_hit.mask & (s_hit.t >= t_e * _VIS_SCALE - _VIS_SLACK)
                       & torch.isfinite(t_e))
            valid = alive & choose_diff & pool_ok & branch_ok & (cos_surf > 0.0) & visible
            contrib = thr * (albedo / pi) * le_e * weight[:, None]
            total = total + torch.where(valid[:, None], contrib, 0.0)

        # cos / pdf cancels for the diffuse lobe; the other lobes tint by
        # albedo as the reference tier does.
        thr = torch.where(live, thr * albedo, thr)

        side = torch.where(torch.sum(new_d * nrm, dim=-1, keepdim=True) >= 0.0, 1.0, -1.0)
        new_o = p + offs * side * nrm
        o = torch.where(live, new_o, o)
        d = torch.where(live, new_d, d)
        if nee:
            prev_diff = torch.where(alive, choose_diff, prev_diff)
        if collect_stats:
            masks = [alive_in & hit.mask, miss_now, died]
            if nee:
                cand = alive & choose_diff & pool_ok & branch_ok & (cos_surf > 0.0)
                masks += [cand, cand & visible]
            for key, mask in zip(stats, masks):
                stats[key].append(mask.sum())

    total = total + torch.where(alive[:, None], thr * sky, 0.0)
    out = (total, st) + ((rounds,) if count_rounds else ())
    if collect_stats:
        out += ({k: torch.stack(v) for k, v in stats.items()},)
    return out


def render_physical(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    nee: bool = True,
    jitter: bool = True,
    sample_offset: int = 0,
    rough_grad: bool = False,
    tri_nee: bool = False,
    count_rounds: bool = False,
    remat: bool = False,
    row_start: int = 0,
    rows: int | None = None,
    **unported,
):
    """Physical-tier radiance image (rows, W, 3) float32 on the scene's
    device, the mean over ``spp`` samples. Anti-aliasing jitter is on by
    default, unlike the reference tier. ``row_start`` and ``rows`` (default:
    the whole image) select a row block of the ``height``-row image, as in
    ``models.integrator.render_tile``: a block equals the same rows of the
    whole image. With ``count_rounds`` returns ``(image, rounds)``, see
    ``trace_paths_physical``. ``remat=True`` runs each sample under
    ``torch.utils.checkpoint``, as ``render_tile`` does: backward
    recomputes it, and no value or gradient changes. The JAX package's
    ``vma_axes`` is refused by name (``_refuse``)."""
    _refuse(unported)
    device = scene.device
    if camera.device != device:
        raise ValueError(f"camera on {camera.device}, scene on {device}")
    rows = check_rows(height, row_start, rows)
    pix = pixel_indices(height, width, device, row_start, rows)
    rays = primary_rays(camera, height, width, row_start=row_start, rows=rows)
    accum = torch.zeros((rows * width, 3), dtype=torch.float32, device=device)
    rounds = 0

    def one_sample(s):
        st = _rng.seed_state(pix, s + sample_offset, seed)
        if jitter:
            o, d, st = primary_rays(camera, height, width, st, row_start=row_start, rows=rows)
        else:
            o, d = rays
        return trace_paths_physical(
            scene, o, d, st, max_bounces, nee=nee, rough_grad=rough_grad,
            tri_nee=tri_nee, count_rounds=count_rounds,
        )

    for s in range(spp):
        out = checkpoint(one_sample, s, use_reentrant=False) if remat else one_sample(s)
        accum = accum + out[0]
        if count_rounds:
            rounds += int(out[2])
    img = (accum / spp).reshape(rows, width, 3)
    return (img, rounds) if count_rounds else img


def render_bounce_stats_physical(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed,
    nee: bool = True,
    jitter: bool = False,
    tri_nee: bool = False,
):
    """Physical-tier per-bounce event histogram of a full render: a dict of
    ``(max_bounces + 1,)`` int64 tensors on the scene's device, summed over
    pixels and samples: the reference tier's ``hits``, ``misses`` and
    ``tir_deaths`` and, with ``nee``, ``nee_candidates`` and ``nee_visible``
    (see ``trace_paths_physical``). Samples run one after another.
    ``tri_nee`` counts the estimator that also samples emissive triangles,
    the one ``render --tri-nee`` renders with; the JAX package's histogram
    has no such argument and always counts the estimator without it."""
    device = scene.device
    if camera.device != device:
        raise ValueError(f"camera on {camera.device}, scene on {device}")
    pix = pixel_indices(height, width, device)
    rays = primary_rays(camera, height, width)
    keys = _STAT_KEYS + (_NEE_STAT_KEYS if nee else ())
    acc = {k: torch.zeros(max_bounces + 1, dtype=torch.int64, device=device) for k in keys}
    for s in range(spp):
        st = _rng.seed_state(pix, s, seed)
        if jitter:
            o, d, st = primary_rays(camera, height, width, st)
        else:
            o, d = rays
        stats = trace_paths_physical(scene, o, d, st, max_bounces, nee=nee,
                                     collect_stats=True, tri_nee=tri_nee)[-1]
        acc = {k: acc[k] + stats[k] for k in keys}
    return acc
