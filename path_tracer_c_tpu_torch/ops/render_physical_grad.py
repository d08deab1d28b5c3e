"""The physical tier's gradient: the fused primal + Jacobian kernel and the
two-pass backward kernel (hand-written CUDA), their plain PyTorch twins, the
backward contraction, and the ``torch.autograd.Function`` that joins them.

Counterpart of the fused and backward halves of
``path_tracer_c_tpu/ops/pallas_physical.py``.

``render_physical_fused`` launches ``csrc/render_phys_fused.cu`` on CUDA
tensors, which replaces the Pallas TPU kernel ``_phys_fused_kernel``; on CPU
tensors it runs ``render_physical_fused_reference``. One pass gives the
radiance image, equal to ``render_physical_kernel``'s, and per-pixel Jacobian
planes: per material A[3] (albedo), S'[3] (emission), R[3] (transparency)
and, with ``rough_grad``, G[3] (roughness, the score function of the lobe
choice), then the 3 sky planes K; with ``n_em_cap`` 12 planes per
sphere-emitter ordinal (centre xyz and radius, times colour); with
``tri_em_cap`` 27 per triangle-emitter ordinal (nine vertex components, times
colour). Per sample the radiance is

    sum_b P_b E_b addle_b + sum_b P_b albedo_b/pi le_b w_b valid_b + P_end sky

with ``P_b`` the throughput before bounce ``b``, ``E_b`` the hit's emission
(``addle``: not skipped by single counting) and ``(le, w, valid)`` the light
sample of a diffuse vertex. Every material cotangent is linear in the image
cotangent ``g`` with per-pixel weights built by a sweep from the path's last
round down (``csrc/render_phys_fused.cu`` has the formulas), and the
emitter-geometry cotangent is ``sum_c g_c F_c dw/dcomp`` with ``F_c = valid
P_c albedo_c le_c / pi``: the backward pass is ``contract_physical_jacobian``.

``dw/dcomp`` is the adjoint of the light sample's weight chain, derived by
hand (``cone_w_adjoint``, ``tri_w_adjoint``; the TPU kernel takes a
``jax.vjp``), so that the kernel, which has no automatic differentiation,
and its twin compute it operation for operation alike. ``cone_w_chain`` and
``tri_w_chain`` transcribe the chains themselves; the tests hold the adjoints
against ``torch.autograd`` through them.

``render_physical_bwd`` launches ``csrc/render_phys_bwd.cu``, which replaces
``_phys_bwd_kernel``: the two-pass oracle, which takes ``g`` and reduces the
cotangents over all pixels inside the kernel. Its contract is narrower: no
triangle vertices, no roughness.

Contract against autograd through ``models/physical.py``: albedo, emission,
transparency and sky match; with ``rough_grad`` roughness matches the eager
tier's score-function estimate; geometry cotangents carry only the light
sample's chain (hit points and normals of struck surfaces, and geometry that
is no emitter, get zero); ordinals at or above a cap get zero; metallicity,
refractive index and the camera get zero.
"""

from __future__ import annotations

import types
import warnings

import torch

from . import render_kernel as _rk
from . import render_physical as _rp
from . import rng as _rng
from .camera import Camera
from . import render_grad as _rg
from .render_grad import replace_leaves, zeros_like_scene
from .render_kernel import _ptr
from .rng import _f32, sqrt_rn
from ..scene.scene import Scene
from ..utils.tracing import count, span, wait

__all__ = [
    "render_physical_fused", "render_physical_fused_reference",
    "render_physical_fused_round_counts", "render_physical_fused_round_counts_reference",
    "render_physical_fused_variant", "chip_plane_split", "policy",
    "contract_physical_jacobian", "render_physical_kernel_vjp",
    "render_physical_bwd", "render_physical_bwd_reference", "render_physical_bwd_variant",
    "bwd_atomics", "BWD_SITES", "BWD_SITE_VALUES", "BWD_COUNTS", "BWD_VARIANTS",
    "cone_w_chain", "cone_w_adjoint", "tri_w_chain", "tri_w_adjoint",
    "MAX_BOUNCES", "EVENTS", "COUNTERS", "KERNEL_POLICY", "VARIANTS", "POLICY_VARIANTS",
    "CHIP_PLANE_FLOATS",
    "MAX_CHIP_MATERIALS", "SOURCE", "REPLACES", "SOURCE_BWD", "REPLACES_BWD",
    "PHYS_FUSED_TILE", "PHYS_BWD_TILE", "phys_fused_tile",
]

SOURCE = "path_tracer_c_tpu_torch/csrc/render_phys_fused.cu"
REPLACES = "path_tracer_c_tpu/ops/pallas_physical.py:1348"
SOURCE_BWD = "path_tracer_c_tpu_torch/csrc/render_phys_bwd.cu"
REPLACES_BWD = "path_tracer_c_tpu/ops/pallas_physical.py:931"

# Both kernels keep their per-bounce stores in thread-private arrays of a
# compile-time size (csrc/pt_phys.cuh, kMaxRounds = MAX_BOUNCES + 1).
MAX_BOUNCES = 31
_RATIO_FLOOR = _f32(1e-6)
_INV_PI = _rp._INV_PI
_TWO_PI = _rp._TWO_PI
_D2_FLOOR = _rp._D2_FLOOR
_PDF_FLOOR = _rp._PDF_FLOOR
_SIN2_CAP = _rp._SIN2_CAP
_AREA_FLOOR = _rp._AREA_FLOOR

# The scene leaves that carry a gradient, as (table or None, field), in the
# order of the autograd function's tensor arguments.
_GRAD_LEAVES = (
    ("materials", "albedo"), ("materials", "emission_color"),
    ("materials", "emission_strength"), ("materials", "transparency"),
    ("materials", "roughness"), (None, "sky_color"),
    ("spheres", "center"), ("spheres", "radius"),
    ("triangles", "v0"), ("triangles", "v1"), ("triangles", "v2"),
)


# -- the weight chains and their hand-derived adjoints -------------------------
#
# All arguments are tensors of one shape (or broadcastable): 3-tuples for
# points and vectors. The chains return w; the adjoints return dw/d(input)
# for dw = 1, in the expression order of csrc/pt_phys.cuh.


def cone_w_chain(c, r, so, n, v1, cp, sp, pool_f):
    """``w = cos_surf / pdf * pool`` of a sphere emitter (centre ``c``,
    radius ``r``) sampled from ``so`` with surface normal ``n``, cone draw
    ``v1`` and azimuth ``(cp, sp)``, guards included: the light sample's
    weight as a function of the emitter's geometry."""
    dcx, dcy, dcz = c[0] - so[0], c[1] - so[1], c[2] - so[2]
    d2 = dcx * dcx + dcy * dcy + dcz * dcz
    dist = torch.sqrt(torch.clamp_min(d2, _D2_FLOOR))
    wzx, wzy, wzz = dcx / dist, dcy / dist, dcz / dist
    sin2max = torch.clamp(r * r / torch.clamp_min(d2, _D2_FLOOR), 0.0, _SIN2_CAP)
    cosmax = torch.sqrt(1.0 - sin2max)
    cth = 1.0 - v1 * (1.0 - cosmax)
    sth = torch.sqrt(torch.clamp_min(1.0 - cth * cth, _D2_FLOOR))
    (tax, tay, taz), (bax, bay, baz) = _rp._onb(wzx, wzy, wzz)
    omx = sth * cp * tax + sth * sp * bax + cth * wzx
    omy = sth * cp * tay + sth * sp * bay + cth * wzy
    omz = sth * cp * taz + sth * sp * baz + cth * wzz
    cos_surf = n[0] * omx + n[1] * omy + n[2] * omz
    return cos_surf * torch.clamp_min(_TWO_PI * (1.0 - cosmax), _PDF_FLOOR) * pool_f


def cone_w_adjoint(c, r, so, n, v1, cp, sp, pool_f):
    """``(dw/dcx, dw/dcy, dw/dcz, dw/dr)`` of ``cone_w_chain``, by hand. A
    floor that wins and a clip that binds pass nothing; the sign in the
    basis is a constant."""
    zero = torch.zeros((), dtype=torch.float32, device=r.device)
    # -- the chain, forward --
    dcx, dcy, dcz = c[0] - so[0], c[1] - so[1], c[2] - so[2]
    d2 = dcx * dcx + dcy * dcy + dcz * dcz
    d2s = torch.clamp_min(d2, _D2_FLOOR)
    dist = sqrt_rn(d2s)
    wzx, wzy, wzz = dcx / dist, dcy / dist, dcz / dist
    qq = r * r / d2s
    sin2max = torch.clamp(qq, 0.0, _SIN2_CAP)
    cosmax = sqrt_rn(1.0 - sin2max)
    cth = 1.0 - v1 * (1.0 - cosmax)
    s2 = 1.0 - cth * cth
    sth = sqrt_rn(torch.clamp_min(s2, _D2_FLOOR))
    sign = torch.where(wzz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + wzz)
    b = wzx * wzy * a
    tax, tay, taz = 1.0 + sign * wzx * wzx * a, sign * b, -sign * wzx
    bax, bay, baz = b, sign + wzy * wzy * a, -wzy
    omx = sth * cp * tax + sth * sp * bax + cth * wzx
    omy = sth * cp * tay + sth * sp * bay + cth * wzy
    omz = sth * cp * taz + sth * sp * baz + cth * wzz
    cos_surf = n[0] * omx + n[1] * omy + n[2] * omz
    cone = _TWO_PI * (1.0 - cosmax)
    pdfinv = torch.clamp_min(cone, _PDF_FLOOR)
    # -- and back, from dw = 1 --
    g_cs = pool_f * pdfinv
    g_pdfinv = pool_f * cos_surf
    g_cosmax = torch.where(cone > _PDF_FLOOR, -(_TWO_PI * g_pdfinv), zero)
    g_omx, g_omy, g_omz = g_cs * n[0], g_cs * n[1], g_cs * n[2]
    g_cth = g_omx * wzx + g_omy * wzy + g_omz * wzz
    g_sth = (g_omx * (cp * tax + sp * bax) + g_omy * (cp * tay + sp * bay)
             + g_omz * (cp * taz + sp * baz))
    g_wzx, g_wzy, g_wzz = cth * g_omx, cth * g_omy, cth * g_omz
    kt, kb = sth * cp, sth * sp
    g_tax, g_tay, g_taz = kt * g_omx, kt * g_omy, kt * g_omz
    g_bax, g_bay, g_baz = kb * g_omx, kb * g_omy, kb * g_omz
    # the basis
    g_b = sign * g_tay + g_bax
    g_a = sign * wzx * wzx * g_tax + wzy * wzy * g_bay + wzx * wzy * g_b
    g_wzx = g_wzx + (2.0 * sign * wzx * a * g_tax - sign * g_taz + wzy * a * g_b)
    g_wzy = g_wzy + (2.0 * wzy * a * g_bay - g_baz + wzx * a * g_b)
    g_wzz = g_wzz + a * a * g_a
    # sth, cth, cosmax
    g_s2 = torch.where(s2 > _D2_FLOOR, 0.5 * g_sth / sth, zero)
    g_cth = g_cth - 2.0 * cth * g_s2
    g_cosmax = g_cosmax + v1 * g_cth
    g_sin2 = -(0.5 * g_cosmax / cosmax)
    g_qq = torch.where((qq > 0.0) & (qq < _SIN2_CAP), g_sin2, zero)
    d_r = 2.0 * r * g_qq / d2s
    g_d2s = -(r * r * g_qq / (d2s * d2s))
    # the unit vector to the centre
    g_dcx, g_dcy, g_dcz = g_wzx / dist, g_wzy / dist, g_wzz / dist
    g_dist = -((g_wzx * dcx + g_wzy * dcy + g_wzz * dcz) / (dist * dist))
    g_d2s = g_d2s + 0.5 * g_dist / dist
    g_d2 = torch.where(d2 > _D2_FLOOR, g_d2s, zero)
    return (g_dcx + 2.0 * dcx * g_d2, g_dcy + 2.0 * dcy * g_d2,
            g_dcz + 2.0 * dcz * g_d2, d_r)


def _tri_forward(tv, so, v1, v2, root):
    """The part of the triangle chain both functions below share; ``tv``
    holds the nine vertex components, ``root`` the square root to take."""
    su = root(v1)
    b1 = su * (1.0 - v2)
    b2 = su * v2
    b0 = 1.0 - su
    dqx = b0 * tv[0] + b1 * tv[3] + b2 * tv[6] - so[0]
    dqy = b0 * tv[1] + b1 * tv[4] + b2 * tv[7] - so[1]
    dqz = b0 * tv[2] + b1 * tv[5] + b2 * tv[8] - so[2]
    d2t = dqx * dqx + dqy * dqy + dqz * dqz
    d2s = torch.clamp_min(d2t, _D2_FLOOR)
    dist = root(d2s)
    ot = (dqx / dist, dqy / dist, dqz / dist)
    e1 = (tv[3] - tv[0], tv[4] - tv[1], tv[5] - tv[2])
    e2 = (tv[6] - tv[0], tv[7] - tv[1], tv[8] - tv[2])
    cr = (e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
          e1[0] * e2[1] - e1[1] * e2[0])
    cr2 = cr[0] * cr[0] + cr[1] * cr[1] + cr[2] * cr[2]
    two_area = root(torch.clamp_min(cr2, _AREA_FLOOR))
    tn = (cr[0] / two_area, cr[1] / two_area, cr[2] / two_area)
    area = 0.5 * two_area
    dotl = tn[0] * ot[0] + tn[1] * ot[1] + tn[2] * ot[2]
    return types.SimpleNamespace(
        b=(b0, b1, b2), dq=(dqx, dqy, dqz), d2t=d2t, d2s=d2s, dist=dist, ot=ot,
        e1=e1, e2=e2, cr=cr, cr2=cr2, two_area=two_area, tn=tn, area=area, dotl=dotl)


def tri_w_chain(tv, so, n, v1, v2, pool_f):
    """``w = cos_surf * area * |cos_l| / d^2 * pool`` of a triangle emitter
    (``tv``: its nine vertex components, v0 xyz, v1 xyz, v2 xyz) sampled
    from ``so`` with surface normal ``n`` and the draws ``(v1, v2)``,
    guards included."""
    f = _tri_forward(tv, so, v1, v2, torch.sqrt)
    w_geom = f.area * torch.abs(f.dotl) / f.d2s
    cos_surf = n[0] * f.ot[0] + n[1] * f.ot[1] + n[2] * f.ot[2]
    return cos_surf * w_geom * pool_f


def tri_w_adjoint(tv, so, n, v1, v2, pool_f):
    """The nine ``dw/d(vertex component)`` of ``tri_w_chain``, by hand;
    ``abs`` differentiates to the sign, floors as in ``cone_w_adjoint``."""
    zero = torch.zeros((), dtype=torch.float32, device=v1.device)
    f = _tri_forward(tv, so, v1, v2, sqrt_rn)
    b0, b1, b2 = f.b
    dqx, dqy, dqz = f.dq
    otx, oty, otz = f.ot
    crx, cry, crz = f.cr
    tnx, tny, tnz = f.tn
    d2s, dist, two_area, area = f.d2s, f.dist, f.two_area, f.area
    cos_l = torch.abs(f.dotl)
    w_geom = area * cos_l / d2s
    cos_surf = n[0] * otx + n[1] * oty + n[2] * otz
    # -- back, from dw = 1 --
    g_cs = pool_f * w_geom
    g_wg = pool_f * cos_surf
    g_area = g_wg * cos_l / d2s
    g_cosl = g_wg * area / d2s
    g_d2s = -(g_wg * area * cos_l / (d2s * d2s))
    sgn = torch.where(f.dotl > 0.0, 1.0, torch.where(f.dotl < 0.0, -1.0, 0.0))
    g_dotl = sgn * g_cosl
    g_tnx, g_tny, g_tnz = g_dotl * otx, g_dotl * oty, g_dotl * otz
    g_otx = g_dotl * tnx + g_cs * n[0]
    g_oty = g_dotl * tny + g_cs * n[1]
    g_otz = g_dotl * tnz + g_cs * n[2]
    # the normal and the area
    g_two = 0.5 * g_area - (g_tnx * crx + g_tny * cry + g_tnz * crz) / (two_area * two_area)
    g_cr2 = torch.where(f.cr2 > _AREA_FLOOR, 0.5 * g_two / two_area, zero)
    g_crx = g_tnx / two_area + 2.0 * crx * g_cr2
    g_cry = g_tny / two_area + 2.0 * cry * g_cr2
    g_crz = g_tnz / two_area + 2.0 * crz * g_cr2
    e1x, e1y, e1z = f.e1
    e2x, e2y, e2z = f.e2
    g_e1x = e2y * g_crz - e2z * g_cry
    g_e1y = e2z * g_crx - e2x * g_crz
    g_e1z = e2x * g_cry - e2y * g_crx
    g_e2x = g_cry * e1z - g_crz * e1y
    g_e2y = g_crz * e1x - g_crx * e1z
    g_e2z = g_crx * e1y - g_cry * e1x
    # the unit vector to the sampled point
    g_dist = -((g_otx * dqx + g_oty * dqy + g_otz * dqz) / (dist * dist))
    g_d2s = g_d2s + 0.5 * g_dist / dist
    g_d2t = torch.where(f.d2t > _D2_FLOOR, g_d2s, zero)
    g_qx = g_otx / dist + 2.0 * dqx * g_d2t
    g_qy = g_oty / dist + 2.0 * dqy * g_d2t
    g_qz = g_otz / dist + 2.0 * dqz * g_d2t
    return (b0 * g_qx - g_e1x - g_e2x, b0 * g_qy - g_e1y - g_e2y, b0 * g_qz - g_e1z - g_e2z,
            b1 * g_qx + g_e1x, b1 * g_qy + g_e1y, b1 * g_qz + g_e1z,
            b2 * g_qx + g_e2x, b2 * g_qy + g_e2y, b2 * g_qz + g_e2z)


# -- the fused kernel's wrapper ------------------------------------------------


def _check_grad_inputs(scene, camera, height, width, spp, max_bounces, seed, sample_offset,
                       n_em_cap=0, tri_em_cap=0, tri_nee=False, row_start=0, rows=None) -> int:
    """``render_kernel._check_inputs`` and the caps; returns the row
    count of the block."""
    rows = _rk._check_inputs(scene, camera, height, width, spp, max_bounces, seed,
                             sample_offset, row_start, rows)
    if max_bounces > MAX_BOUNCES:
        raise ValueError(f"max_bounces {max_bounces} is above the physical gradient "
                         f"kernels' cap of {MAX_BOUNCES}")
    if n_em_cap < 0 or tri_em_cap < 0:
        raise ValueError(f"negative cap: n_em_cap {n_em_cap}, tri_em_cap {tri_em_cap}")
    if tri_em_cap and not tri_nee:
        raise ValueError("tri_em_cap (the triangle-vertex planes) requires tri_nee=True: "
                         "the chain only exists in the tri_nee estimator")
    return rows


# B4's and B5's tiles (the JAX package's names;
# ``render_kernel.KIND_DEFAULTS``): 8 x 32 pixels, warps of one row of 32. No
# point beat them at every shape measured on an H100 (PERF.md, tile sweep).
PHYS_FUSED_TILE = _rk.KIND_DEFAULTS["phys_fused"]
PHYS_BWD_TILE = _rk.KIND_DEFAULTS["phys_bwd"]


def phys_fused_tile(scene: Scene, rows: int, width: int, max_bounces: int, tile=None):
    """The point (``render_kernel.Tile``) ``render_physical_fused`` launches
    at for this workload (``tile``, default ``PHYS_FUSED_TILE``, as
    ``render_kernel.fit_tile`` fits it), as the JAX package's
    ``phys_fused_tile``: the one sizing call of the wrapper and its counting
    twin. The JAX function also takes the emitter caps and ``rough_grad``,
    which size its kernel's VMEM; B4 keeps its planes in device memory and
    its records in local memory, so nothing of them sizes a block here."""
    return _rk.fit_tile("phys_fused", scene, rows, width, max_bounces,
                        PHYS_FUSED_TILE if tile is None else tile)


def _load_library():
    from .build import load_library

    lib = load_library()
    if lib.render_phys_grad_max_bounces() != MAX_BOUNCES:
        raise RuntimeError("csrc/pt_phys.cuh and MAX_BOUNCES disagree")
    return lib


# What B4's counting instantiation counts, in the order of its counter: the
# bounce rounds run; the light samples among them that counted (each runs a
# weight chain's adjoint where its ordinal is tracked); its plane adds by
# family: the material sweep's (albedo, transparency and, with
# ``rough_grad``, roughness planes of the hit material), the emission planes'
# of the hit's own emission and of the sampled emitter's, the sphere and the
# triangle geometry planes'; and the warp lane-rounds. ``count_events``
# returns all but the last (``EVENTS``).
COUNTERS = ("rounds", "valid_samples", "adds_material", "adds_hit_emission",
            "adds_emitter_emission", "adds_sphere_geometry", "adds_triangle_geometry",
            "warp_lane_rounds")
EVENTS = COUNTERS[:-1]


def _fused_outputs(img, jac, jgeo, jtri, n_em_cap, tri_em_cap, counter, count_rounds,
                   count_events):
    out = (img, jac)
    if n_em_cap:
        out += (jgeo,)
    if tri_em_cap:
        out += (jtri,)
    if count_events:
        out += (dict(zip(EVENTS, counter.tolist())),)
    elif count_rounds:
        out += (int(counter[0]),)
    return out


# B4's policies (csrc/render_phys_fused.cu ``KernelPolicy``, pt_fused.cuh):
# its loops over the rounds ("lane": a lane leaves at its own last round;
# "warp": warp-uniform), where its pixel-constant planes live ("device":
# read-modify-writes of device memory; "shared" or "local": slots in shared
# or local memory until the pixel's end, ``PlaneSlots``) and the blocks a
# multiprocessor ptxas budgets its registers for.
KERNEL_POLICY = {"loops": "lane", "planes": "device", "blocks": 4}
# The floats a thread keeps in slots where the planes live there, by
# placement (local: csrc/render_phys_fused.cu kMaxLocalSlots, the most it
# takes), and the most emitter materials whose emission planes a launch
# keeps there (kMaxChipMats).
CHIP_PLANE_FLOATS = {"shared": 32, "local": 48}
MAX_CHIP_MATERIALS = 16


# B4's measurement instantiations (csrc/pt_fused.cuh ``Variant``), each one
# policy away from the kernel: its plane adds, the geometry planes' included,
# into one register; its records in registers (max_bounces <= 3); its records
# in shared memory (these three without tri_nee); then, with or without
# tri_nee (``POLICY_VARIANTS``), warp-uniform loops, registers budgeted for
# three blocks a multiprocessor, and its pixel-constant planes in slots in
# shared memory and in local memory.
_VARIANT_POLICIES = {
    "sink": (0, KERNEL_POLICY), "registers": (1, {**KERNEL_POLICY, "blocks": 1}),
    "shared_records": (2, KERNEL_POLICY),
    "warp_loops": (3, {**KERNEL_POLICY, "loops": "warp"}),
    "three_blocks": (4, {**KERNEL_POLICY, "blocks": 3}),
    "shared_planes": (5, {**KERNEL_POLICY, "planes": "shared"}),
    "local_planes": (6, {**KERNEL_POLICY, "planes": "local"}),
}
VARIANTS = {name: code for name, (code, _) in _VARIANT_POLICIES.items()}
POLICY_VARIANTS = tuple(name for name, code in VARIANTS.items() if code >= 3)


def policy(variant: str | None = None) -> dict:
    """The loops, planes and blocks of B4 (``variant`` None) or of one of
    its measurement instantiations."""
    return dict(KERNEL_POLICY if variant is None else _VARIANT_POLICIES[variant][1])


def chip_plane_split(n_em_cap: int, tri_em_cap: int, n_mat: int, floats: int | None = None,
                     planes: str = "shared") -> tuple[int, int, int]:
    """``(k, kt, e)``: how many sphere ordinals (12 floats each), triangle
    ordinals (27 each) and emitter materials (3 each: their emission planes)
    a thread keeps in slots out of ``floats`` (default
    ``CHIP_PLANE_FLOATS[planes]``). In shared memory: in that order of
    claim, each up to its cap (the materials up to ``n_mat`` and
    ``MAX_CHIP_MATERIALS``); which materials, the kernel finds on the device
    from the emitter tables (the first distinct ones). In local memory:
    geometry only, each family whole or not at all (the sphere ordinals if
    all fit, then the triangle ordinals if all fit in the rest), so that no
    warp runs both the slots' adds and the device planes' of one family.
    None in device memory."""
    if planes == "device":
        return 0, 0, 0
    floats = CHIP_PLANE_FLOATS[planes] if floats is None else floats
    if planes == "local":
        k = n_em_cap if 12 * n_em_cap <= floats else 0
        kt = tri_em_cap if 27 * tri_em_cap <= floats - 12 * k else 0
        return k, kt, 0
    k = max(0, min(n_em_cap, floats // 12))
    kt = max(0, min(tri_em_cap, (floats - 12 * k) // 27))
    e = max(0, min(n_mat, MAX_CHIP_MATERIALS, (floats - 12 * k - 27 * kt) // 3))
    return k, kt, e


def _chip_split(scene, n_em_cap, tri_em_cap, variant, floats=None):
    """The split a launch of the measurement instantiation ``variant``
    passes to the kernel."""
    return chip_plane_split(n_em_cap, tri_em_cap, scene.num_materials, floats,
                            policy(variant)["planes"])


def render_physical_fused(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    sample_offset: int = 0,
    jitter: bool = True,
    nee: bool = True,
    n_em_cap: int = 0,
    tri_nee: bool = False,
    tri_em_cap: int = 0,
    count_rounds: bool = False,
    rough_grad: bool = False,
    count_events: bool = False,
    row_start: int = 0,
    rows: int | None = None,
    tile=None,
):
    """``(image (H, W, 3), jac (mp * M + 3, H, W))`` float32 on the scene's
    device (H: the ``rows`` rows from ``row_start`` of a row block, as
    ``render_kernel.render_kernel`` takes it; default the whole image), ``mp`` = 9, or 12 with ``rough_grad``; then, for whichever cap is
    nonzero, ``jac_geo (12 * n_em_cap, H, W)`` (layout ``[k, comp (cx, cy,
    cz, r), colour]``) and ``jac_tri (27 * tri_em_cap, H, W)`` (``[k, comp
    (v0 xyz, v1 xyz, v2 xyz), colour]``; requires ``tri_nee``); then, with
    ``count_rounds``, the executed thread-rounds, or with ``count_events`` a
    dict of one count per name in ``EVENTS``. The image equals
    ``render_physical_kernel``'s. A thread stops at a miss or a death only,
    so it runs more rounds than that kernel where an albedo is exactly
    black.

    CUDA tensors go to the hand kernel, built on first use (``ops.build``);
    the counter ``launch.render_phys_fused`` (``utils/tracing.py``) counts
    its launches, and ``planes.render_phys_fused`` the geometry planes each
    call writes, on either device. CPU tensors go to
    ``render_physical_fused_reference``. Any other device raises, and so
    does ``max_bounces > MAX_BOUNCES`` on every device.

    The planes take ``(mp * M + 3 + 12 * n_em_cap + 27 * tri_em_cap) * H * W
    * 4`` bytes (629 MB at 1024 x 1024 with 15 materials and one tracked
    emitter). The wrapper allocates them zero-filled; the kernel adds.

    ``tile``: the launch shape (``render_kernel.TILES``; default
    ``PHYS_FUSED_TILE``) as ``phys_fused_tile`` fits it; no output depends
    on it.
    """
    with span("pt.check.render_phys_fused"):
        rows = _check_grad_inputs(scene, camera, height, width, spp, max_bounces, seed,
                                  sample_offset, n_em_cap, tri_em_cap, tri_nee, row_start, rows)
        t = phys_fused_tile(scene, rows, width, max_bounces, tile)
    count("planes.render_phys_fused", 12 * n_em_cap + 27 * tri_em_cap)
    if scene.device.type == "cpu":
        return render_physical_fused_reference(
            scene, camera, height, width, spp, max_bounces, seed, sample_offset=sample_offset,
            jitter=jitter, nee=nee, n_em_cap=n_em_cap, tri_nee=tri_nee, tri_em_cap=tri_em_cap,
            count_rounds=count_rounds, rough_grad=rough_grad, count_events=count_events,
            row_start=row_start, rows=rows)
    img, jac, jgeo, jtri, counter = _launch_fused(
        scene, camera, height, width, spp, max_bounces, seed, sample_offset, jitter, nee,
        n_em_cap, tri_nee, tri_em_cap, rough_grad, count_rounds or count_events,
        row_start=row_start, rows=rows, tile=t)
    if not (count_rounds or count_events):
        return _fused_outputs(img, jac, jgeo, jtri, n_em_cap, tri_em_cap, None, False, False)
    with wait("count_events" if count_events else "count_rounds"):
        return _fused_outputs(img, jac, jgeo, jtri, n_em_cap, tri_em_cap, counter, count_rounds,
                              count_events)


render_physical_fused.SOURCE = SOURCE
render_physical_fused.REPLACES = REPLACES


def _launch_fused(scene, camera, height, width, spp, max_bounces, seed, sample_offset, jitter,
                  nee, n_em_cap, tri_nee, tri_em_cap, rough_grad, count_on, variant=None,
                  row_start=0, rows=None, chip_floats=None, tile=None):
    """Launch B4 on the scene's CUDA device over the block of ``rows`` rows
    (None: all) from ``row_start``: the timed kernel at point ``tile``
    (None: the default), its counting
    instantiation (``count_on``: the ``COUNTERS`` come back beside the planes),
    or a measurement variant; where the planes live in slots, with
    ``chip_floats`` a thread (default ``CHIP_PLANE_FLOATS``)."""
    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"render_physical_fused runs on CUDA or CPU tensors, not {device}")
    with span("pt.pack.render_phys_fused"):
        lib = _load_library()
        t = _rk.tile_point(tile, "phys_fused")
        _rk._library("render_phys_fused", t)
        operands = _rk._scene_operands(scene)
        ph = _rp._phys_operands(scene, operands)
    with wait("camera_params"):
        par = _rk._camera_params(camera, scene, height, width)
    with span("pt.launch.render_phys_fused"):
        rows = height if rows is None else rows
        planes = lambda n: torch.zeros((n, rows, width), dtype=torch.float32, device=device)
        img = torch.empty((rows, width, 3), dtype=torch.float32, device=device)
        jac = planes((12 if rough_grad else 9) * scene.num_materials + 3)
        jgeo = planes(12 * n_em_cap) if n_em_cap else None
        jtri = planes(27 * tri_em_cap) if tri_em_cap else None
        counter = None
        if count_on:
            counter = torch.zeros(len(COUNTERS), dtype=torch.int64, device=device)
        split = None
        if variant is not None:
            split = _chip_split(scene, n_em_cap, tri_em_cap, variant, chip_floats)
        tables = (*_rk._table_args(operands), *_rp._emitter_args(ph), _ptr(par), _ptr(img),
                  _ptr(jac), _ptr(jgeo), _ptr(jtri))
        run = _rk._run_args(height, width, spp, max_bounces, seed, sample_offset, jitter,
                            device, row_start, rows)
        if variant is None:
            err = _rk._entry("render_phys_fused", t)(
                *tables, _ptr(counter), int(bool(nee)), int(bool(tri_nee)),
                int(bool(rough_grad)), n_em_cap, tri_em_cap, *run)
            name = f"render_phys_fused at {t.name}"
        else:
            err = lib.render_phys_fused_variant(VARIANTS[variant], *tables, int(bool(nee)),
                                                int(bool(tri_nee)), n_em_cap, tri_em_cap,
                                                *split, *run)
            name = f"render_phys_fused variant {variant}"
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
        count("launch.render_phys_fused" if variant is None
              else "launch.render_phys_fused.variant")
    return img, jac, jgeo, jtri, counter


def render_physical_fused_round_counts(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    sample_offset: int = 0,
    jitter: bool = True,
    nee: bool = True,
    tri_nee: bool = False,
    row_start: int = 0,
    rows: int | None = None,
    tile=None,
) -> dict:
    """The rounds B4 runs for one render (of a row block, as
    ``render_physical_fused`` takes it), as
    ``render_grad.render_fused_round_counts``: ``thread_rounds`` and
    ``warp_lane_rounds`` (CUDA tensors: the counting instantiation, a launch
    counted in ``launch.render_phys_fused``); CPU tensors take the
    twin, which also gives ``warp_lane_rounds_regen``. The planes do not
    change the rounds, so no cap is taken. A warp is the footprint of the
    launch's point (``phys_fused_tile`` of ``tile``)."""
    with span("pt.check.render_phys_fused"):
        rows = _check_grad_inputs(scene, camera, height, width, spp, max_bounces, seed,
                                  sample_offset, tri_nee=tri_nee, row_start=row_start, rows=rows)
        t = phys_fused_tile(scene, rows, width, max_bounces, tile)
    if scene.device.type == "cpu":
        return render_physical_fused_round_counts_reference(
            scene, camera, height, width, spp, max_bounces, seed, sample_offset, jitter, nee,
            tri_nee, row_start, rows, tile=t)
    *_, counter = _launch_fused(scene, camera, height, width, spp, max_bounces, seed,
                                sample_offset, jitter, nee, 0, tri_nee, 0, False, True,
                                row_start=row_start, rows=rows, tile=t)
    with wait("count_rounds"):
        counts = dict(zip(COUNTERS, counter.tolist()))
    return {"thread_rounds": counts["rounds"], "warp_lane_rounds": counts["warp_lane_rounds"]}


def render_physical_fused_round_counts_reference(scene, camera, height, width, spp,
                                                 max_bounces, seed, sample_offset=0,
                                                 jitter=True, nee=True, tri_nee=False,
                                                 row_start=0, rows=None, tile=None) -> dict:
    """Plain twin of ``render_physical_fused_round_counts``: the twin's rounds
    of every (sample, pixel), grouped by warp under both schedules
    (``render_kernel.round_groupings``), a warp the footprint of the point
    ``phys_fused_tile`` gives ``tile``."""
    t = phys_fused_tile(scene, height if rows is None else rows, width, max_bounces, tile)
    per_sample = []
    render_physical_fused_reference(scene, camera, height, width, spp, max_bounces, seed,
                                    sample_offset=sample_offset, jitter=jitter, nee=nee,
                                    tri_nee=tri_nee, on_sample=per_sample.append,
                                    row_start=row_start, rows=rows)
    return _rk.round_groupings(torch.stack(per_sample), t.footprint)


def render_physical_fused_variant(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    variant: str,
    sample_offset: int = 0,
    jitter: bool = True,
    nee: bool = True,
    n_em_cap: int = 0,
    row_start: int = 0,
    rows: int | None = None,
    tri_nee: bool = False,
    tri_em_cap: int = 0,
    chip_floats: int | None = None,
):
    """``(image, jac[, jac_geo][, jac_tri])`` of a measurement instantiation
    of B4 (of a row block, as ``render_physical_fused`` takes it)
    (``VARIANTS``; without rough_grad; ``tri_nee`` only for the variants of
    B4's own policies), on CUDA tensors only: as
    ``render_grad.render_fused_variant``, for
    ``utils/sol_decompose.fused_decompose``. Where the variant's planes live
    in slots, ``chip_floats`` a thread (default ``CHIP_PLANE_FLOATS``). No
    user path runs it. Counts its launches in
    ``launch.render_phys_fused.variant``."""
    with span("pt.check.render_phys_fused"):
        rows = _check_grad_inputs(scene, camera, height, width, spp, max_bounces, seed,
                                  sample_offset, n_em_cap, tri_em_cap, tri_nee,
                                  row_start=row_start, rows=rows)
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; one of {', '.join(VARIANTS)}")
        if tri_nee and variant not in POLICY_VARIANTS:
            raise ValueError(f"variant {variant} is built without tri_nee")
        cap = _rg.REGISTER_ROUNDS - 1 if variant == "registers" else MAX_BOUNCES
        if max_bounces > cap:
            raise ValueError(f"max_bounces {max_bounces} is above variant {variant}'s cap "
                             f"of {cap}")
    img, jac, jgeo, jtri, _ = _launch_fused(scene, camera, height, width, spp, max_bounces, seed,
                                            sample_offset, jitter, nee, n_em_cap, tri_nee,
                                            tri_em_cap, False, False, variant=variant,
                                            row_start=row_start, rows=rows,
                                            chip_floats=chip_floats)
    return (img, jac) + ((jgeo,) if n_em_cap else ()) + ((jtri,) if tri_em_cap else ())


# -- the replay both twins share -----------------------------------------------


def _replay_setup(scene, camera, height, width, nee, tri_nee, row_start=0, rows=None):
    """What both twins replay the row block of ``rows`` rows (None: all)
    from ``row_start`` with: tables, camera, the pixels' global indices and
    rows (``rows``: as float32) and columns."""
    device = scene.device
    tabs = _rk._scene_operands(scene)
    ph = _rp._phys_operands(scene, tabs)
    par = _rk._camera_params(camera, scene, height, width)
    n = (height if rows is None else rows) * width
    pix, rows, cols = _rk._pixel_grid(height, width, row_start, rows, device)
    fw, fh = (torch.tensor(float(v), device=device) for v in (width, height))
    return types.SimpleNamespace(
        device=device, tabs=tabs, ph=ph, par=par, sky=(par[2], par[3], par[4]), n=n,
        pix=pix, rows=rows, cols=cols, fw=fw, fh=fh, n_mat=tabs[4].shape[0],
        pd=_rk._camera_dir(par, cols + 0.5, rows + 0.5, fw, fh),
        origin=tuple(par[i].expand(n) for i in (5, 6, 7)),
        zero=torch.zeros(n, dtype=torch.float32, device=device),
        one=torch.ones(n, dtype=torch.float32, device=device),
        nee=nee, tri_nee=tri_nee)


def _replay_sample(cx, s, seed, sample_offset, jitter, max_bounces):
    """The forward rounds of sample ``s`` for every pixel, as the kernels'
    threads run them: ``_bounce`` of the forward twin, with a path's rounds
    after its structural death (a miss, or total internal reflection)
    masked out. Returns the rounds' records, the sample's radiance with the
    sky at the end of the budget, the throughput at the end, and the
    thread-rounds run."""
    sph, sph_m, tri, tri_m, mat_tab = cx.tabs
    st = _rng.seed_state(cx.pix, s + sample_offset, seed)
    d = cx.pd
    if jitter:
        st, jx = _rng.uniform(st)
        st, jy = _rng.uniform(st)
        d = _rk._camera_dir(cx.par, cx.cols + jx, cx.rows + jy, cx.fw, cx.fh)
    o, thr, rad = cx.origin, (cx.one,) * 3, (cx.zero,) * 3
    prevd = torch.zeros(cx.n, dtype=torch.bool, device=cx.device)
    alive = torch.ones(cx.n, dtype=torch.bool, device=cx.device)
    n_rounds = torch.zeros((), dtype=torch.int64, device=cx.device)
    records = []
    for _ in range(max_bounces + 1):
        n_rounds = n_rounds + alive.sum()
        hit = _rk._closest_hit(sph, sph_m, tri, tri_m, o, d)
        m = hit[2]
        mats = _rk._fetch_materials(mat_tab, m)
        est = torch.where((m >= 0) & (m < cx.n_mat),
                          cx.ph["mat_est"][m.clamp(0, cx.n_mat - 1).long()], 0.0)
        before = thr
        o, d, thr, rad, st, prevd, (hitm, diffuse, _), info = _rp._bounce(
            cx.tabs, cx.ph, hit, mats, est, o, d, thr, rad, st, prevd, cx.sky,
            cx.nee, cx.tri_nee)
        hit_ev = alive & hitm
        light = info["light"]
        records.append(types.SimpleNamespace(
            P=before, m=m, in_table=(m >= 0) & (m < cx.n_mat), normal=hit[1],
            alb=mats[0:3], em=mats[3:6], rgh=mats[6], trn=mats[7],
            hit=hit_ev, miss=alive & ~hitm, died=hit_ev & info["died"],
            addle=hit_ev & ~info["nee_counted"], refracted=info["refracted"],
            diffuse=diffuse, so=info["so"], v1=info["v1"], v2=info["v2"], light=light,
            valid=(hit_ev & light["valid"]) if light is not None else torch.zeros_like(hit_ev)))
        # Structural death only: a miss, or total internal reflection.
        alive = hit_ev & ~info["died"]
    rad = tuple(r + t * k for r, t, k in zip(rad, thr, cx.sky))
    return records, rad, thr, n_rounds


def _swept_terms(rec):
    """Per unit of throughput, what the light sample of a round adds:
    ``nee_c = valid le_c w / pi`` and ``emw_c = valid P_c albedo_c w / pi``
    (zeros with next-event estimation off)."""
    if rec.light is None:
        zero = torch.zeros_like(rec.P[0])
        return (zero,) * 3, (zero,) * 3
    w = rec.light["w"]
    nee = tuple(torch.where(rec.valid, le * w * _INV_PI, 0.0) for le in rec.light["le"])
    emw = tuple(torch.where(rec.valid, p * a * w * _INV_PI, 0.0) for p, a in zip(rec.P, rec.alb))
    return nee, emw


def _ratio_dr(rec):
    return torch.where(
        rec.refracted,
        1.0 / torch.clamp_min(rec.trn, _RATIO_FLOOR),
        -1.0 / torch.clamp_min(1.0 - rec.trn, _RATIO_FLOOR),
    )


def _lobe_drg(rec):
    return torch.where(
        rec.refracted, 0.0,
        torch.where(
            rec.diffuse,
            1.0 / torch.clamp_min(rec.rgh, _RATIO_FLOOR),
            -1.0 / torch.clamp_min(1.0 - rec.rgh, _RATIO_FLOOR),
        ))


def _sphere_lanes(rec):
    """The pixels whose light sample of a round is a valid sphere pick."""
    return rec.valid & ~rec.light["is_tri"] if "is_tri" in rec.light else rec.valid


def _sphere_dw(cx, rec):
    """The cone chain's adjoint at every pixel's light sample of a round,
    and the mask of valid sphere picks."""
    light = rec.light
    sph = cx.tabs[0]
    e = light["e_idx"]
    lanes = _sphere_lanes(rec)
    dw = cone_w_adjoint((sph[e, 0], sph[e, 1], sph[e, 2]), sph[e, 3], rec.so, rec.normal,
                        rec.v1, light["cp"], light["sp"], light["pool_f"])
    return dw, lanes


def _closure(rec):
    """``F_c = P_c albedo_c le_c / pi`` of a round's light sample."""
    return tuple(p * a * le * _INV_PI for p, a, le in zip(rec.P, rec.alb, rec.light["le"]))


def _add_ordinal_planes(planes, ordinal, lanes, cap, closure, dw):
    """``planes[k, comp, c] += F_c dw_comp`` at the pixels in ``lanes`` whose
    sampled ordinal ``k`` is below ``cap``: one index per pixel and plane, so
    the scatter is deterministic."""
    lanes = lanes & (ordinal < cap)
    per = 3 * len(dw)
    vals = torch.stack([torch.where(lanes, f * d, 0.0) for d in dw for f in closure])
    base = per * torch.where(lanes, ordinal, 0).long()
    planes.scatter_add_(0, base[None, :] + torch.arange(per, device=base.device)[:, None], vals)


def _count_adds(records, n_mat, mp, n_em_cap, tri_em_cap):
    """The plane adds of one sample's rounds by family, as B4's counting
    instantiation counts them (``COUNTERS`` from ``adds_material``): the
    material sweep's, the emission planes' of the hit's own emission and of
    the sampled emitter's, the sphere and triangle geometry planes'."""
    mat = hit_em = emitter_em = sph = tri = 0
    for rec in records:
        lanes = rec.hit & rec.in_table
        mat = mat + (mp - 3) * lanes.sum()
        hit_em = hit_em + 3 * (lanes & rec.addle).sum()
        light = rec.light
        if light is None:
            continue
        emat = light["emat"]
        emitter_em = emitter_em + 3 * (rec.valid & (emat >= 0) & (emat < n_mat)).sum()
        sph = sph + 12 * (_sphere_lanes(rec) & (light["kk"] < n_em_cap)).sum()
        if tri_em_cap:
            tri = tri + 27 * (rec.valid & light["is_tri"] & (light["kt"] < tri_em_cap)).sum()
    zero = torch.zeros((), dtype=torch.int64, device=records[0].m.device)
    return [zero + c for c in (mat, hit_em, emitter_em, sph, tri)]


# -- the fused kernel's plain twin ----------------------------------------------


def render_physical_fused_reference(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    sample_offset: int = 0,
    jitter: bool = True,
    nee: bool = True,
    n_em_cap: int = 0,
    tri_nee: bool = False,
    tri_em_cap: int = 0,
    count_rounds: bool = False,
    rough_grad: bool = False,
    count_events: bool = False,
    on_sample=None,
    row_start: int = 0,
    rows: int | None = None,
):
    """Plain PyTorch twin of the fused physical kernel, on the scene's
    device: the forward rounds of ``render_physical_kernel_reference`` with
    per-bounce records, the geometry planes added in the rounds' order, then
    the sweep, in the kernel's order of additions (samples ascending; per
    sample ``P_end`` first, then bounces descending; at a hit the hit
    material's planes, then the sampled emitter's), so that on one device
    the two round alike. Every round runs for every pixel; a dead path's
    rounds are masked out, which adds the exact zeros the kernel skips. The
    adjoints are the hand-derived ones, not ``torch.autograd``.
    ``on_sample``, where given, receives each sample's (H, W) int64 rounds
    of every pixel (those its path begins alive: a hit or a miss), in
    sample order. Over the row block of ``render_physical_fused``."""
    rows = _check_grad_inputs(scene, camera, height, width, spp, max_bounces, seed,
                              sample_offset, n_em_cap, tri_em_cap, tri_nee, row_start, rows)
    cx = _replay_setup(scene, camera, height, width, nee, tri_nee, row_start, rows)
    device, n, n_mat = cx.device, cx.n, cx.n_mat
    mp = 12 if rough_grad else 9
    plane = torch.arange(mp, device=device)[:, None]
    jac = torch.zeros((mp * n_mat + 3, n), dtype=torch.float32, device=device)
    jgeo = torch.zeros((12 * n_em_cap, n), dtype=torch.float32, device=device)
    jtri = torch.zeros((27 * tri_em_cap, n), dtype=torch.float32, device=device)
    acc = (cx.zero,) * 3
    k_sky = [cx.zero] * 3
    counter = torch.zeros(len(EVENTS), dtype=torch.int64, device=device)
    tri = cx.tabs[2]
    for s in range(spp):
        records, rad, thr_end, n_rounds = _replay_sample(
            cx, s, seed, sample_offset, jitter, max_bounces)
        if count_rounds or count_events:
            counter = counter + torch.stack(
                [n_rounds, sum(rec.valid.sum() for rec in records),
                 *_count_adds(records, n_mat, mp, n_em_cap, tri_em_cap)])
        if on_sample is not None:
            on_sample(sum((rec.hit | rec.miss).long() for rec in records).reshape(rows, width))
        acc = tuple(a + r for a, r in zip(acc, rad))
        k_sky = [k + t for k, t in zip(k_sky, thr_end)]  # P_end

        if nee and (n_em_cap or tri_em_cap):
            for rec in records:
                light = rec.light
                if n_em_cap:
                    dw, lanes = _sphere_dw(cx, rec)
                    _add_ordinal_planes(jgeo, light["kk"], lanes, n_em_cap, _closure(rec), dw)
                if tri_em_cap:
                    tv = tri[light["t_idx"]]
                    dwt = tri_w_adjoint(tuple(tv[:, i] for i in range(9)), rec.so, rec.normal,
                                        rec.v1, rec.v2, light["pool_f"])
                    _add_ordinal_planes(jtri, light["kt"], rec.valid & light["is_tri"],
                                        tri_em_cap, _closure(rec), dwt)

        carry = tuple(k.expand(n) for k in cx.sky)
        for rec in reversed(records):
            k_sky = [k + torch.where(rec.miss, p, 0.0) for k, p in zip(k_sky, rec.P)]
            nee_c, emw = _swept_terms(rec)
            held = tuple(torch.where(rec.died, 0.0, t) + x for t, x in zip(carry, nee_c))
            lanes = rec.hit & rec.in_table
            c_a = [torch.where(lanes, p * t, 0.0) for p, t in zip(rec.P, held)]
            c_s = [torch.where(lanes & rec.addle, p, 0.0) for p in rec.P]
            dr = _ratio_dr(rec)
            c_r = [c * dr for c in c_a]
            if rough_grad:
                drg = _lobe_drg(rec)
                c_r = c_r + [c * drg for c in c_a]
            base = mp * torch.where(lanes, rec.m, 0).long()
            jac.scatter_add_(0, base[None, :] + plane, torch.stack(c_a + c_s + c_r))
            if rec.light is not None:
                # The sampled emitter's emission, into its own material's planes.
                emat = rec.light["emat"]
                lanes_e = rec.valid & (emat >= 0) & (emat < n_mat)
                base = mp * torch.where(lanes_e, emat, 0).long() + 3
                jac.scatter_add_(0, base[None, :] + plane[:3],
                                 torch.stack([torch.where(lanes_e, e, 0.0) for e in emw]))
            carry = tuple(
                torch.where(rec.hit, torch.where(rec.addle, em, 0.0) + alb * t,
                            torch.where(rec.miss, k, c))
                for em, alb, t, k, c in zip(rec.em, rec.alb, held, cx.sky, carry))
    jac[mp * n_mat:] = torch.stack(k_sky)
    inv = _f32(1.0 / spp)
    img = torch.stack([a * inv for a in acc], dim=-1).reshape(rows, width, 3)
    shaped = lambda t: t.reshape(-1, rows, width)
    return _fused_outputs(img, shaped(jac), shaped(jgeo), shaped(jtri), n_em_cap, tri_em_cap,
                          counter, count_rounds, count_events)


# -- the backward pass ------------------------------------------------------------


def _plane_dots(planes, g_cp):
    """``sum_p planes[3 i + c, p] g[c, p]`` as (n, 3), for planes (3 n, hw)
    grouped by colour: one matrix-vector product per colour on strided
    views (no copy of the planes)."""
    v = planes.reshape(-1, 3, g_cp.shape[1])
    return torch.stack([v[:, c] @ g_cp[c] for c in range(3)], dim=-1)


def _contract(jac, jgeo, jtri, g, spp, albedo, emission_color, emission_strength):
    """The cotangents from the planes and the image cotangent ``g`` (H, W,
    3): albedo, emission colour, emission strength, transparency, roughness
    (None without its planes), sky, and per tracked ordinal the sphere
    rows (K, 4) and triangle rows (Kt, 9) (None without their planes)."""
    n_mat = albedo.shape[0]
    hw = jac.shape[1] * jac.shape[2]
    mp = (jac.shape[0] - 3) // n_mat if n_mat else 9
    g_cp = g.to(torch.float32).permute(2, 0, 1).reshape(3, hw).contiguous()
    gq = _plane_dots(jac[: mp * n_mat].reshape(-1, hw), g_cp).reshape(n_mat, mp // 3, 3) / spp
    d_alb = gq[:, 0]
    d_eco = gq[:, 1] * emission_strength[:, None]
    d_est = torch.sum(gq[:, 1] * emission_color, dim=1)
    d_trn = torch.sum(gq[:, 2] * albedo, dim=1)
    d_rgh = torch.sum(gq[:, 3] * albedo, dim=1) if mp == 12 else None
    d_sky = _plane_dots(jac[mp * n_mat:].reshape(3, hw), g_cp)[0] / spp
    geo = geo_t = None
    if jgeo is not None and jgeo.shape[0] >= 12:
        geo = torch.sum(_plane_dots(jgeo.reshape(-1, hw), g_cp), dim=1).reshape(-1, 4) / spp
    if jtri is not None and jtri.shape[0] >= 27:
        geo_t = torch.sum(_plane_dots(jtri.reshape(-1, hw), g_cp), dim=1).reshape(-1, 9) / spp
    return d_alb, d_eco, d_est, d_trn, d_rgh, d_sky, geo, geo_t


def _ordinal_rows(cum, count, cap):
    """Table row of every emitter ordinal below ``cap`` (``_pick_list``),
    and whether the ordinal is live, without a host sync."""
    ks = torch.arange(cap, device=cum.device)
    rows = _rp._pick_list(cum)[ks.clamp(max=cum.shape[0] - 1)].long()
    return rows, ks < count


def _scatter_emitter_geometry(scene: Scene, geo, n_em_cap: int):
    """``(d_center (S, 3), d_radius (S,))`` from per-ordinal rows ``geo``
    ((>= n_em_cap, 4): centre xyz and radius): the rows go back onto their
    spheres; rows beyond the live emitter count are dropped."""
    sph = scene.spheres
    d_center, d_radius = torch.zeros_like(sph.center), torch.zeros_like(sph.radius)
    if not n_em_cap or scene.num_spheres == 0:
        return d_center, d_radius
    em_cum, _, n_em = _rp._emitter_operands(scene)
    rows, live = _ordinal_rows(em_cum, n_em, n_em_cap)
    vals = torch.where(live[:, None], geo[:n_em_cap], 0.0)
    return d_center.index_add_(0, rows, vals[:, 0:3]), d_radius.index_add_(0, rows, vals[:, 3])


def _scatter_tri_emitter_geometry(scene: Scene, geo, tri_em_cap: int):
    """``(d_v0, d_v1, d_v2)`` (T, 3) each from per-ordinal rows ``geo``
    ((>= tri_em_cap, 9)): the triangle twin of
    ``_scatter_emitter_geometry``."""
    tri = scene.triangles
    d = [torch.zeros_like(v) for v in (tri.v0, tri.v1, tri.v2)]
    if not tri_em_cap or scene.num_triangles == 0:
        return tuple(d)
    tri_cum, _, _, n_em_t = _rp._tri_emitter_operands(scene)
    rows, live = _ordinal_rows(tri_cum, n_em_t, tri_em_cap)
    vals = torch.where(live[:, None], geo[:tri_em_cap], 0.0)
    return tuple(x.index_add_(0, rows, vals[:, 3 * i:3 * i + 3]) for i, x in enumerate(d))


def _cotangent_scene(scene, d_alb, d_eco, d_est, d_trn, d_rgh, d_sky, geo, geo_t):
    """The scene's cotangent as a ``Scene`` of tensors; leaves without a
    gradient are zeros."""
    leaves = [("materials", "albedo", d_alb), ("materials", "emission_color", d_eco),
              ("materials", "emission_strength", d_est), ("materials", "transparency", d_trn),
              (None, "sky_color", d_sky)]
    if d_rgh is not None:
        leaves.append(("materials", "roughness", d_rgh))
    if geo is not None:
        d_c, d_r = _scatter_emitter_geometry(scene, geo, geo.shape[0])
        leaves += [("spheres", "center", d_c), ("spheres", "radius", d_r)]
    if geo_t is not None:
        leaves += [("triangles", name, v) for name, v in zip(
            ("v0", "v1", "v2"), _scatter_tri_emitter_geometry(scene, geo_t, geo_t.shape[0]))]
    return replace_leaves(zeros_like_scene(scene), leaves)


def contract_physical_jacobian(scene: Scene, jac, g, spp: int, jac_geo=None, jac_tri=None) -> Scene:
    """The scene's cotangent, as a ``Scene`` of tensors, from the fused
    physical kernel's planes and the image cotangent ``g`` (H, W, 3):

        d_albedo[m, c]       = sum_p g[p, c] A[m, c, p] / spp
        d_emission_color     = emission_strength[m] sum_p g S' / spp
        d_emission_strength  = sum_c emission_color[m, c] sum_p g S' / spp
        d_transparency[m]    = sum_c albedo[m, c] sum_p g R / spp
        d_roughness[m]       = sum_c albedo[m, c] sum_p g G / spp   (12 planes
                               a material; zero with 9)
        d_sky[c]             = sum_p g[p, c] K[c, p] / spp
        d_(centre, radius)   = sum_c sum_p g[p, c] jac_geo[k, comp, c, p] / spp,
                               onto the sphere of emitter ordinal k
        d_(v0, v1, v2)       = the same from jac_tri, onto the triangle of
                               triangle-emitter ordinal k

    Ordinals at or above the live emitter count are dropped. Every other
    leaf's cotangent is zero by contract (module docstring). Plain PyTorch
    on every device: the JAX package computes it outside its kernels too.
    """
    mats = scene.materials
    with span("pt.contract.render_phys_fused"):
        return _cotangent_scene(scene, *_contract(
            jac, jac_geo, jac_tri, g, spp, mats.albedo, mats.emission_color,
            mats.emission_strength))


def _check_emitter_cap(scene: Scene, n_em_cap: int, raise_: bool = False):
    """Warn (or raise) when the scene has more live sphere emitters than the
    geometry cap tracks: ordinals at or above ``n_em_cap`` get exactly zero
    centre and radius cotangents by contract, which would silently freeze
    those lights in a fit. Returns the live count (it waits for the
    device)."""
    n_em = _rp.live_emitter_count(scene)
    if n_em > n_em_cap:
        msg = (f"scene has {n_em} emissive spheres but the NEE geometry cotangent cap is "
               f"n_em_cap={n_em_cap}: emitter ordinals >= {n_em_cap} receive exactly-zero "
               "center/radius gradients. Pass a larger n_em_cap to track them.")
        if raise_:
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=3)
    return n_em


def _check_tri_emitter_cap(scene: Scene, tri_em_cap: int):
    """Warn when the scene has more live triangle emitters than the vertex
    cap tracks; returns the live count."""
    n_em_t = _rp.live_tri_emitter_count(scene)
    if n_em_t > tri_em_cap:
        warnings.warn(
            f"scene has {n_em_t} emissive triangles but the vertex cotangent cap is "
            f"tri_em_cap={tri_em_cap}: tri-emitter ordinals >= {tri_em_cap} receive "
            "exactly-zero vertex gradients. Pass a larger tri_em_cap to track them.",
            stacklevel=3)
    return n_em_t


def _with_leaves(scene: Scene, leaves) -> Scene:
    return replace_leaves(scene, [(tb, nm, t) for (tb, nm), t in zip(_GRAD_LEAVES, leaves)])


def _grad_leaves(scene: Scene):
    return tuple(getattr(getattr(scene, table) if table else scene, name)
                 for table, name in _GRAD_LEAVES)


class _RenderPhysicalFused(torch.autograd.Function):
    """Forward: ``render_physical_fused``; backward: ``_contract`` and the
    scatters. ``Function.apply`` does not look into a dataclass, so the
    eleven leaves with a gradient come as tensor arguments and the scene
    and camera beside them."""

    @staticmethod
    def forward(ctx, *args):
        leaves, (scene, camera, height, width, spp, max_bounces, seed, sample_offset,
                 jitter, nee, geo_cap, tri_nee, tri_geo_cap, rough_grad, row_start,
                 rows, tile) = args[:11], args[11:]
        with span("pt.check.render_phys_fused"):
            live = _with_leaves(scene, [t.detach() for t in leaves])
        out = render_physical_fused(
            live, camera, height, width, spp, max_bounces, seed, sample_offset=sample_offset,
            jitter=jitter, nee=nee, n_em_cap=geo_cap, tri_nee=tri_nee,
            tri_em_cap=tri_geo_cap, rough_grad=rough_grad, row_start=row_start, rows=rows,
            tile=tile)
        img, jac, rest = out[0], out[1], list(out[2:])
        jgeo = rest.pop(0) if geo_cap else None
        jtri = rest.pop(0) if tri_geo_cap else None
        ctx.scene, ctx.spp = live, spp
        ctx.planes = (jac, jgeo, jtri)
        return img

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        with span("pt.contract.render_phys_fused"):
            scene, mats = ctx.scene, ctx.scene.materials
            d_alb, d_eco, d_est, d_trn, d_rgh, d_sky, geo, geo_t = _contract(
                *ctx.planes, g, ctx.spp, mats.albedo, mats.emission_color,
                mats.emission_strength)
            d_c = d_r = None
            if geo is not None:
                d_c, d_r = _scatter_emitter_geometry(scene, geo, geo.shape[0])
            d_tri = (None,) * 3
            if geo_t is not None:
                d_tri = _scatter_tri_emitter_geometry(scene, geo_t, geo_t.shape[0])
            return (d_alb, d_eco, d_est, d_trn, d_rgh, d_sky, d_c, d_r, *d_tri, *(None,) * 17)


def render_physical_kernel_vjp(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    sample_offset: int = 0,
    jitter: bool = True,
    nee: bool = True,
    geom: bool = True,
    n_em_cap: int | None = None,
    tri_nee: bool = False,
    tri_em_cap: int | None = None,
    rough_grad: bool = False,
    row_start: int = 0,
    rows: int | None = None,
    tile=None,
) -> torch.Tensor:
    """Differentiable fast render of the physical tier: the image (H, W, 3)
    of ``render_physical_kernel`` (H: the ``rows`` rows from ``row_start``
    of a row block, default the whole image), with a backward pass.

    Under autograd the forward is the fused kernel and the backward its
    planes' contraction, so no ray is traced twice, and both see the same
    RNG streams. Albedo, emission colour and strength, transparency and sky
    get the estimator's exact gradient. ``rough_grad=True`` adds the
    score-function roughness planes (3 per material): roughness then gets
    the same estimate as the eager tier's ``rough_grad``; the image does not
    change. ``geom=True`` (the default) also emits emitter-geometry
    gradients: a sampled sphere emitter's centre and radius through the
    cone weight for the first ``n_em_cap`` emitter ordinals (default
    ``min(num_spheres, 8)``), and with ``tri_nee=True`` a sampled triangle
    emitter's vertices through the area weight for the first ``tri_em_cap``
    ordinals (default ``min(num_triangles, 8)``). Both caps are clamped to
    the scene's live emitter counts, and more live emitters than a cap
    warns. ``geom=False`` skips all geometry planes.

    Geometry gradients carry the light sample's chain only: hit points and
    normals of struck surfaces, and geometry that is no emitter, get none.
    Metallicity, refractive index and the camera get none either (their
    ``.grad`` stays ``None``), although the physical tier does vary
    continuously with the primary ray: fit a camera through
    ``models.physical.render_physical`` or ``grad.diff.fit_camera``.

    Memory: the planes (``render_physical_fused``) are held from forward to
    backward. With no leaf requiring a gradient this is
    ``render_physical_kernel``. ``tile``: the launch shape of the kernel it
    runs (``render_kernel.TILES``; by default ``PHYS_FUSED_TILE``, or
    ``render_physical_kernel``'s own without a gradient).
    """
    leaves = _grad_leaves(scene)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in leaves)):
        return _rp.render_physical_kernel(
            scene, camera, height, width, spp, max_bounces, seed,
            sample_offset=sample_offset, jitter=jitter, nee=nee, tri_nee=tri_nee,
            row_start=row_start, rows=rows, tile=tile)
    if n_em_cap is None:
        n_em_cap = min(scene.num_spheres, 8)
    geo_cap = int(n_em_cap) if (geom and nee) else 0
    if geo_cap:
        # Ordinals beyond the live emitters would only buy planes of zeros.
        with wait("emitter_count"):
            geo_cap = min(geo_cap, _check_emitter_cap(scene, geo_cap))
    if tri_em_cap is None:
        tri_em_cap = min(scene.num_triangles, 8)
    tri_geo_cap = int(tri_em_cap) if (geom and nee and tri_nee) else 0
    if tri_geo_cap:
        with wait("emitter_count"):
            tri_geo_cap = min(tri_geo_cap, _check_tri_emitter_cap(scene, tri_geo_cap))
    return _RenderPhysicalFused.apply(
        *leaves, scene, camera, height, width, spp, max_bounces, seed, sample_offset,
        jitter, nee, geo_cap, tri_nee, tri_geo_cap, rough_grad, row_start, rows, tile)


# -- the two-pass oracle ------------------------------------------------------------


def _bwd_cap(scene, nee, n_em_cap):
    if n_em_cap is None:
        n_em_cap = min(scene.num_spheres, 8)
    return int(n_em_cap) if nee else 0


def _bwd_scene(scene, out, geo, n_em_cap):
    """The two-pass kernel's tables as the scene's cotangent: ``out`` (M + 1,
    8) and ``geo`` (max(K, 1), 4). Triangles and roughness stay zero."""
    n_mat = scene.num_materials
    return _cotangent_scene(
        scene, out[:n_mat, 0:3], out[:n_mat, 3:6], out[:n_mat, 6], out[:n_mat, 7], None,
        out[n_mat, 0:3], geo[:n_em_cap] if n_em_cap else None, None)


# B5's add sites (csrc/render_phys_bwd.cu `Site`) and the values a lane adds
# at each: a hit's material row (albedo and transparency), its emission where
# single counting adds it, the sampled emitter's emission, the emitter's
# geometry (in the forward rounds) and the sky (once a pixel).
BWD_SITES = ("mat", "mat_le", "emitter", "geo", "sky")
BWD_SITE_VALUES = {"mat": 4, "mat_le": 4, "emitter": 4, "geo": 4, "sky": 3}
# What B5's counting instantiation counts (``count_sites``), in the kernel's
# order: the forward rounds' and the sweep's thread-rounds and warp
# lane-rounds, then for each site the lanes that add, the distinct rows among
# a warp's adding lanes, the most of a warp's lanes on one row (the serial
# depth of per-lane atomics) and the warp visits with an adding lane, each
# summed over the warps' visits of the site.
BWD_COUNTS = (("fwd_thread_rounds", "fwd_warp_lane_rounds", "sweep_thread_rounds",
               "sweep_warp_lane_rounds")
              + tuple(f"{s}_{c}" for s in BWD_SITES for c in ("lanes", "groups", "depth", "visits")))
# B5's measurement instantiations (csrc/render_phys_bwd.cu `BwdVariant`),
# built without tri_nee, none on a user path, each one policy away from the
# kernel: its adds into one register a thread; its records in shared memory.
BWD_VARIANTS = {"sink": 0, "shared_records": 1}


def bwd_atomics(counts: dict) -> dict:
    """From B5's counts, the adds of each site under two reductions: every
    adding lane's float atomics (``lanes``: the parent design, four a hit's
    row, four its emission) and the warp groups' adds (``groups``: the
    kernel, whose group leaders add a hit's row and emission as one run of
    eight)."""
    out = {s: {"lanes": counts[f"{s}_lanes"] * v, "groups": counts[f"{s}_groups"] * v}
           for s, v in BWD_SITE_VALUES.items()}
    out["mat"]["groups"] = 8 * counts["mat_groups"]
    out["mat_le"]["groups"] = 0
    return out


def _launch_bwd(scene, camera, g, height, width, spp, max_bounces, seed, sample_offset,
                jitter, nee, n_em_cap, tri_nee, row_start, rows, count_on=False, variant=None,
                tile=None):
    """Launch B5 at point ``tile`` (None: the default; or its counting
    instantiation, or a variant, at the default) and its second pass on the
    scene's CUDA device; returns ``out``, ``geo`` and the counters (or
    None)."""
    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"render_physical_bwd runs on CUDA or CPU tensors, not {device}")
    with span("pt.pack.render_phys_bwd"):
        lib = _load_library()
        t = _rk.tile_point(tile, "phys_bwd")
        at_default = t == _rk.tile_point(None, "phys_bwd")
        if variant is None and not at_default and count_on:
            raise ValueError(f"count_sites: B5 counts at the default tile only, not {t.name}")
        _rk._library("render_phys_bwd", t)
        operands = _rk._scene_operands(scene)
        ph = _rp._phys_operands(scene, operands)
        g32 = g.to(torch.float32).contiguous()
        eco = scene.materials.emission_color.contiguous()
    with wait("camera_params"):
        par = _rk._camera_params(camera, scene, height, width)
    with span("pt.launch.render_phys_bwd"):
        n_mat = scene.num_materials
        out = torch.empty((n_mat + 1, 8), dtype=torch.float32, device=device)
        geo = torch.empty((max(n_em_cap, 1), 4), dtype=torch.float32, device=device)
        n_blocks = -(-width // t.tw) * -(-rows // t.th)
        partials = torch.empty(((out.numel() + geo.numel()) * n_blocks,), dtype=torch.float32,
                               device=device)
        counter = None
        if count_on:
            if lib.render_phys_bwd_counters() != len(BWD_COUNTS):
                raise RuntimeError("csrc/render_phys_bwd.cu and BWD_COUNTS disagree")
            counter = torch.zeros(len(BWD_COUNTS), dtype=torch.int64, device=device)
        args = _rp._emitter_args(ph)
        head = (*_rk._table_args(operands), *args[:-1], _ptr(eco), args[-1], _ptr(par),
                _ptr(g32), _ptr(out), _ptr(geo), _ptr(partials))
        run = _rk._run_args(height, width, spp, max_bounces, seed, sample_offset, jitter,
                            device, row_start, rows)
        if variant is None and not at_default:
            err = _rk._entry("render_phys_bwd", t)(*head, int(bool(nee)), int(bool(tri_nee)),
                                                   n_em_cap, *run)
            name = f"render_phys_bwd at {t.name}"
        elif variant is None:
            err = lib.render_phys_bwd(*head, _ptr(counter), int(bool(nee)), int(bool(tri_nee)),
                                      n_em_cap, *run)
            name = "render_phys_bwd"
        else:
            err = lib.render_phys_bwd_variant(BWD_VARIANTS[variant], *head, int(bool(nee)),
                                              n_em_cap, *run)
            name = f"render_phys_bwd variant {variant}"
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
        count("launch.render_phys_bwd" if variant is None else "launch.render_phys_bwd.variant")
    return out, geo, counter


def render_physical_bwd(
    scene: Scene,
    camera: Camera,
    g,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    sample_offset: int = 0,
    jitter: bool = True,
    nee: bool = True,
    n_em_cap: int | None = None,
    tri_nee: bool = False,
    row_start: int = 0,
    rows: int | None = None,
    count_sites: bool = False,
    tile=None,
):
    """The cotangent of ``render_physical_kernel``'s image for the image
    cotangent ``g`` (H, W, 3; of the row block of ``rows`` rows from
    ``row_start`` where they are given: the blocks' cotangents sum to the
    whole image's), as a ``Scene`` of tensors, by the two-pass
    scheme (replay, then sweep, then a reduction over all pixels inside the
    kernel): the parity oracle of the fused kernel and its contraction,
    which ``render_physical_kernel_vjp`` uses. With ``count_sites``,
    ``(Scene, counts)``: a dict of one count per name in ``BWD_COUNTS``.

    Albedo, emission colour and strength, transparency and sky as the fused
    path; sphere-emitter centre and radius through the cone weight for the
    first ``n_em_cap`` ordinals (default ``min(num_spheres, 8)``, 0 with
    ``nee`` off). Triangle vertices and roughness are zero here.

    CUDA tensors go to the hand kernel (``csrc/render_phys_bwd.cu``; with
    ``count_sites`` its counting instantiation); the counter
    ``launch.render_phys_bwd`` (``utils/tracing.py``) counts its launches.
    It sums in a fixed order, so two runs agree bit for bit; its order is
    not the twin's, so the two agree to float32 rounding.
    CPU tensors go to ``render_physical_bwd_reference``. Any other device
    raises.

    ``tile``: the launch shape (``render_kernel.KIND_TILES["phys_bwd"]``;
    default ``PHYS_BWD_TILE``) as ``render_kernel.fit_tile`` fits it (a
    block keeps a table of its sums a warp). Its blocks' sums, and so the
    last bits of the cotangents, change with it; ``count_sites`` is counted
    at the default tile only.
    """
    with span("pt.check.render_phys_bwd"):
        n_em_cap = _bwd_cap(scene, nee, n_em_cap)
        rows = _check_grad_inputs(scene, camera, height, width, spp, max_bounces, seed,
                                  sample_offset, n_em_cap, row_start=row_start, rows=rows)
        t = _rk.fit_tile("phys_bwd", scene, rows, width, max_bounces,
                         PHYS_BWD_TILE if tile is None else tile, n_em_cap=n_em_cap)
        device = scene.device
        if tuple(g.shape) != (rows, width, 3) or g.device != device:
            raise ValueError(f"g has shape {tuple(g.shape)} on {g.device}, expected "
                             f"{(rows, width, 3)} on {device}")
    if device.type == "cpu":
        return render_physical_bwd_reference(
            scene, camera, g, height, width, spp, max_bounces, seed,
            sample_offset=sample_offset, jitter=jitter, nee=nee, n_em_cap=n_em_cap,
            tri_nee=tri_nee, row_start=row_start, rows=rows, count_sites=count_sites)
    out, geo, counter = _launch_bwd(scene, camera, g, height, width, spp, max_bounces, seed,
                                    sample_offset, jitter, nee, n_em_cap, tri_nee, row_start,
                                    rows, count_on=count_sites, tile=t)
    d = _bwd_scene(scene, out, geo, n_em_cap)
    if not count_sites:
        return d
    with wait("count_sites"):
        return d, dict(zip(BWD_COUNTS, counter.tolist()))


render_physical_bwd.SOURCE = SOURCE_BWD
render_physical_bwd.REPLACES = REPLACES_BWD


def render_physical_bwd_variant(
    scene: Scene,
    camera: Camera,
    g,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    variant: str,
    sample_offset: int = 0,
    jitter: bool = True,
    nee: bool = True,
    n_em_cap: int | None = None,
    row_start: int = 0,
    rows: int | None = None,
) -> Scene:
    """The ``Scene`` of a measurement instantiation of B5
    (``BWD_VARIANTS``; without tri_nee), on CUDA tensors only, for
    ``utils/sol_decompose.fused_decompose``: the kernel's cotangents but for
    the ``sink``'s (its tables are not the cotangents). No user path runs
    it. Counts its launches in ``launch.render_phys_bwd.variant``."""
    with span("pt.check.render_phys_bwd"):
        n_em_cap = _bwd_cap(scene, nee, n_em_cap)
        rows = _check_grad_inputs(scene, camera, height, width, spp, max_bounces, seed,
                                  sample_offset, n_em_cap, row_start=row_start, rows=rows)
        if variant not in BWD_VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; one of {', '.join(BWD_VARIANTS)}")
        if tuple(g.shape) != (rows, width, 3) or g.device != scene.device:
            raise ValueError(f"g has shape {tuple(g.shape)} on {g.device}, expected "
                             f"{(rows, width, 3)} on {scene.device}")
        if scene.device.type != "cuda":
            raise ValueError(f"render_physical_bwd_variant runs on CUDA tensors only, not "
                             f"{scene.device}")
    out, geo, _ = _launch_bwd(scene, camera, g, height, width, spp, max_bounces, seed,
                              sample_offset, jitter, nee, n_em_cap, False, row_start, rows,
                              variant=variant)
    return _bwd_scene(scene, out, geo, n_em_cap)


class _BwdCounts:
    """B5's counts from the twin's replay, as the counting instantiation
    takes them: a warp is 32 consecutive columns of one row from a multiple
    of 32; each sample's forward rounds and sweep run the warp's longest
    lane's rounds; the forward round ``b`` of every lane is one visit of the
    geometry site, step ``i`` of the sweep (each lane's round ``n - 1 - i``)
    one visit of the three sweep sites, and the pixel's end one of the
    sky's."""

    def __init__(self, rows, width, device):
        self.warp, self.n_warps, self.lanes = _rk.warp_map(rows, width, (1, 32), device)
        self.total = torch.zeros(len(BWD_COUNTS), dtype=torch.int64, device=device)

    def site(self, site, on, key, n_keys):
        """A visit of ``site`` by every warp: lanes ``on`` add at row ``key``
        (of ``n_keys``)."""
        idx = self.warp[on] * n_keys + key[on].long()
        per = torch.bincount(idx, minlength=self.n_warps * n_keys).reshape(self.n_warps, n_keys)
        lanes = per.sum(1)
        i = 4 + 4 * BWD_SITES.index(site)
        self.total[i:i + 4] += torch.stack(
            [lanes.sum(), (per > 0).sum(), per.max(1).values.sum(), (lanes > 0).sum()])

    def sample(self, n):
        """One sample's rounds ``n`` (per pixel) in the forward rounds and
        the sweep."""
        widest = torch.zeros(self.n_warps, dtype=torch.int64, device=n.device).scatter_reduce(
            0, self.warp, n, "amax")
        warp = (widest * self.lanes).sum()
        self.total[:4] += torch.stack([n.sum(), warp, n.sum(), warp])

    def counts(self) -> dict:
        return dict(zip(BWD_COUNTS, self.total.tolist()))


def _count_sample(cnt, records, n_mat, n_em_cap):
    """Add one sample's replay to ``cnt`` (``_BwdCounts``)."""
    n = sum((rec.hit | rec.miss).long() for rec in records)
    cnt.sample(n)
    for rec in records:
        if rec.light is not None and n_em_cap:
            kk = rec.light["kk"]
            cnt.site("geo", _sphere_lanes(rec) & (kk < n_em_cap), kk, n_em_cap)
    stack = lambda f: torch.stack([f(rec) for rec in records])
    mat_on = stack(lambda r: r.hit & r.in_table)
    le_on = stack(lambda r: r.hit & r.in_table & r.addle)
    mats = stack(lambda r: torch.where(r.hit & r.in_table, r.m, 0))
    none = torch.zeros_like(mat_on[0])
    em_on = stack(lambda r: none if r.light is None else
                  r.valid & (r.light["emat"] >= 0) & (r.light["emat"] < n_mat))
    emats = stack(lambda r: torch.zeros_like(r.m) if r.light is None else
                  torch.where(r.valid, r.light["emat"], 0).clamp(0, n_mat - 1))
    for i in range(len(records)):
        swept = i < n
        b = (n - 1 - i).clamp(min=0)[None]
        at = lambda t: t.gather(0, b)[0]
        cnt.site("mat", swept & at(mat_on), at(mats), n_mat)
        cnt.site("mat_le", swept & at(le_on), at(mats), n_mat)
        cnt.site("emitter", swept & at(em_on), at(emats), n_mat)


def render_physical_bwd_reference(
    scene: Scene,
    camera: Camera,
    g,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    sample_offset: int = 0,
    jitter: bool = True,
    nee: bool = True,
    n_em_cap: int | None = None,
    tri_nee: bool = False,
    row_start: int = 0,
    rows: int | None = None,
    count_sites: bool = False,
):
    """Plain PyTorch twin of the two-pass kernel, on the scene's device,
    over the row block of ``render_physical_bwd``:
    the replay of ``render_physical_fused_reference``, the kernel's
    per-pixel terms in float32 in its expression order, and the reduction
    over pixels, samples and bounces in float64 (the kernel's order of
    additions, warps' group sums and blocks' partial sums, is another, so the
    twin takes the sum that rounds least). With ``count_sites``, also the
    counting instantiation's counts, from the replay (``_BwdCounts``)."""
    n_em_cap = _bwd_cap(scene, nee, n_em_cap)
    rows = _check_grad_inputs(scene, camera, height, width, spp, max_bounces, seed,
                              sample_offset, n_em_cap, row_start=row_start, rows=rows)
    cx = _replay_setup(scene, camera, height, width, nee, tri_nee, row_start, rows)
    device, n, n_mat = cx.device, cx.n, cx.n_mat
    cnt = _BwdCounts(rows, width, device) if count_sites else None
    mats = scene.materials
    inv_spp = _f32(1.0 / spp)
    gs = tuple((g.to(torch.float32).reshape(n, 3)[:, c] * inv_spp) for c in range(3))
    out = torch.zeros((n_mat + 1, 8), dtype=torch.float64, device=device)
    geo = torch.zeros((max(n_em_cap, 1), 4), dtype=torch.float64, device=device)
    est_tab, eco_tab = mats.emission_strength, mats.emission_color

    def add_rows(table, index, lanes, cols, values):
        vals = torch.stack([torch.where(lanes, v, 0.0) for v in values], dim=1).double()
        table[:, cols] = table[:, cols].index_add(0, torch.where(lanes, index, 0).long(), vals)

    for s in range(spp):
        records, _, thr_end, _ = _replay_sample(cx, s, seed, sample_offset, jitter, max_bounces)
        if cnt is not None:
            _count_sample(cnt, records, n_mat, n_em_cap)
        sky = [(gc * t).double().sum() for gc, t in zip(gs, thr_end)]  # P_end

        if n_em_cap:
            for rec in records:
                dw, lanes = _sphere_dw(cx, rec)
                kk = rec.light["kk"]
                lanes = lanes & (kk < n_em_cap)
                terms = [gc * p * a * le for gc, p, a, le in zip(gs, rec.P, rec.alb, rec.light["le"])]
                cot_w = (terms[0] + terms[1] + terms[2]) * _INV_PI
                add_rows(geo, kk, lanes, slice(0, 4), [cot_w * d for d in dw])

        carry = tuple(k.expand(n) for k in cx.sky)
        for rec in reversed(records):
            gp = [gc * p for gc, p in zip(gs, rec.P)]
            sky = [k + torch.where(rec.miss, x, 0.0).double().sum() for k, x in zip(sky, gp)]
            nee_c, _ = _swept_terms(rec)
            held = tuple(torch.where(rec.died, 0.0, t) + x for t, x in zip(carry, nee_c))
            lanes = rec.hit & rec.in_table
            m = torch.where(lanes, rec.m, 0).long()
            d_a = [x * t for x, t in zip(gp, held)]
            cot_ratio = rec.alb[0] * d_a[0] + rec.alb[1] * d_a[1] + rec.alb[2] * d_a[2]
            add_rows(out, m, lanes, slice(0, 3), d_a)
            add_rows(out, m, lanes, slice(7, 8), [cot_ratio * _ratio_dr(rec)])
            es, eco = est_tab[m], eco_tab[m]
            add_rows(out, m, lanes & rec.addle, slice(3, 7),
                     [x * es for x in gp] + [gp[0] * eco[:, 0] + gp[1] * eco[:, 1] + gp[2] * eco[:, 2]])
            if rec.light is not None:
                emat = rec.light["emat"]
                lanes_e = rec.valid & (emat >= 0) & (emat < n_mat)
                e = torch.where(lanes_e, emat, 0).long()
                w = rec.light["w"]
                d_le = [x * a * _INV_PI * w for x, a in zip(gp, rec.alb)]
                es, eco = est_tab[e], eco_tab[e]
                add_rows(out, e, lanes_e, slice(3, 7),
                         [x * es for x in d_le]
                         + [d_le[0] * eco[:, 0] + d_le[1] * eco[:, 1] + d_le[2] * eco[:, 2]])
            carry = tuple(
                torch.where(rec.hit, torch.where(rec.addle, em, 0.0) + alb * t,
                            torch.where(rec.miss, k, c))
                for em, alb, t, k, c in zip(rec.em, rec.alb, held, cx.sky, carry))
        out[n_mat, 0:3] += torch.stack(sky)
    d = _bwd_scene(scene, out.float(), geo.float(), n_em_cap)
    if cnt is None:
        return d
    cnt.site("sky", torch.ones(n, dtype=torch.bool, device=device),
             torch.zeros(n, dtype=torch.int64, device=device), 1)
    return d, cnt.counts()
