"""The plain reference of the fused physical kernel B4
(``csrc/render_phys_fused.cu``) as the emitter-geometry fit reads it, and of
that fit's first steps.

B4 gives the physical tier's image (B3's, ``tracer.render_physical``) and,
for the geometry of sphere emitters, that image's gradient along the light
sample's chain only. A diffuse vertex's light sample adds
``F_c w`` to a pixel, with ``F_c = P_c albedo_c le_c / pi`` (the throughput
before the bounce, the vertex's albedo, the sampled emitter's radiance) and
the cone weight

    w(c, r) = cos_surf * max(2 pi (1 - cos theta_max), 1e-8) * pool

of the sampled emitter's centre ``c`` and radius ``r``: the cone's axis and
opening follow ``c`` and ``r``, the sampled direction turns with the axis,
and ``cos_surf`` is that direction against the surface's normal. Only
``w`` is differentiated. The shadow origin, the normal, the draws, the
pick and the visibility are held; hit points and normals of struck
surfaces carry no geometry gradient; a light sample that did not count
(not diffuse, facing away, shadowed) adds nothing. So the image's gradient
with respect to ``(c, r)`` is ``sum F_c dw/d(c, r) / spp`` over the valid
light samples of a pixel, and a loss's is that contracted with the image's
cotangent. Written from the contract (``render_physical_kernel_vjp``'s
docstring, ``cone_w_adjoint`` in ``csrc/pt_phys.cuh``, the JAX package's
``_cone_w_chain``), not from the port's code; ``torch.autograd`` takes the
derivative, where the kernel runs a hand-derived adjoint.

Departures from the kernel, none of which changes a value the fit reads
but by rounding:

- The chain enters the image as ``F (w - detach(w))``: its value is zero,
  so the image is B3's, value for value, and only its gradient carries the
  chain.
- Which light samples counted, and their inputs, are found by drawing each
  sample again on the lanes where the bounce scanned for a shadow, from
  the random state the bounce started with (its fifth to seventh draws:
  the pick and the cone's two), and scanning again; the kernel keeps them
  from its one scan.
- The chain's guards (a floor that wins, a clip that binds) pass no
  gradient in the kernel; torch's clamps also pass one at a tie, a set of
  measure zero.
- Events (``count=True``) are B3's four, whose paths run until their
  throughput is zero, and B4's ``valid_samples``, the light samples that
  counted, taken in those rounds. B4's threads run until a miss or a death:
  the two agree wherever no albedo is black, as in every scene here.

``follow`` runs a geometry fit's first steps (variables ``center`` and
``radius_raw``, the inverse softplus of the radius, of one sphere), the
mean squared error against B3's image of the true scene without jitter,
and Adam (betas 0.9 and 0.999, eps 1e-8 outside the root, bias-corrected as
``optax.adam``), in blocks of rows whose gradients add up; each step from
the reference's own variables or from those another run took.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import rng as _rng
from . import tracer
from .fit import _inv_softplus
from .rng import sqrt_rn

EVENTS = tracer.EVENTS["physical"] + ("valid_samples",)
VARIABLES = ("center", "radius_raw")


def cone_w(c, r, so, n, v1, cp, sp, pool_f):
    """``(w, omega)``: the light sample's weight as a function of the
    sampled emitter's centre ``c`` and radius ``r`` (3-tuples for points
    and vectors), from shadow origin ``so`` with surface normal ``n``, cone
    draw ``v1``, azimuth ``(cp, sp)`` and pool size ``pool_f``, guards
    included, and the sampled direction ``omega``."""
    dcx, dcy, dcz = c[0] - so[0], c[1] - so[1], c[2] - so[2]
    d2 = dcx * dcx + dcy * dcy + dcz * dcz
    dist = sqrt_rn(torch.clamp_min(d2, tracer._D2_FLOOR))
    wzx, wzy, wzz = dcx / dist, dcy / dist, dcz / dist
    sin2max = torch.clamp(r * r / torch.clamp_min(d2, tracer._D2_FLOOR), 0.0, tracer._SIN2_CAP)
    cosmax = sqrt_rn(1.0 - sin2max)
    cth = 1.0 - v1 * (1.0 - cosmax)
    sth = sqrt_rn(torch.clamp_min(1.0 - cth * cth, tracer._D2_FLOOR))
    (tax, tay, taz), (bax, bay, baz) = tracer._onb(wzx, wzy, wzz)
    omx = sth * cp * tax + sth * sp * bax + cth * wzx
    omy = sth * cp * tay + sth * sp * bay + cth * wzy
    omz = sth * cp * taz + sth * sp * baz + cth * wzz
    cos_surf = n[0] * omx + n[1] * omy + n[2] * omz
    w = cos_surf * torch.clamp_min(tracer._TWO_PI * (1.0 - cosmax), tracer._PDF_FLOOR) * pool_f
    return w, (omx, omy, omz)


def _light_lanes(tabs, em, hit, mats, path, scan):
    """The light samples of one bounce on the lanes ``scan`` (a diffuse
    vertex that faces a live emitter: the bounce's shadow scans), drawn
    again from ``path``, the origins, directions, throughputs and random
    states the bounce started with. Returns the lanes
    and, at each, what the chain holds (the emitter's row, the shadow
    origin, the normal, the cone draw, the azimuth, the pool size and ``F``)
    and whether the sample counted (``valid``: not shadowed). The lanes are
    found by the one wait for the card a bounce; the rest stays on it."""
    sph, _, tri, _, _ = tabs
    pick, le_sph, n_em = em
    o, d, thr, st = path
    lanes = torch.nonzero(scan).squeeze(1)
    st = st[lanes]
    for _ in range(4):  # the transparency, lobe and direction draws
        st, _ = _rng.uniform(st, d[0].dtype)
    st, u_pick = _rng.uniform(st, d[0].dtype)
    st, v1 = _rng.uniform(st, d[0].dtype)
    _, v2 = _rng.uniform(st, d[0].dtype)
    best = hit[0][lanes]
    n = tuple(c[lanes] for c in hit[1])
    p = tuple(oc[lanes] + best * dc[lanes] for oc, dc in zip(o, d))
    offs = tracer._EPS_OFFSET + tracer._EPS_SCALE * sqrt_rn(p[0] * p[0] + p[1] * p[1] + p[2] * p[2])
    so = tuple(pc + offs * nc for pc, nc in zip(p, n))

    pool_f = n_em.to(u_pick.dtype)
    kf = torch.floor(u_pick * pool_f).to(torch.int32)
    kk = torch.minimum(torch.clamp_min(kf, 0), torch.clamp_min(n_em - 1, 0))
    n_sph = sph.shape[0]
    row = torch.where(kk < n_sph, pick[kk.clamp(max=n_sph - 1).long()], n_sph - 1).long()
    c, r = (sph[row, 0], sph[row, 1], sph[row, 2]), sph[row, 3]
    cp, sp = _rng.sincos_2pi(v2)
    _, om = cone_w(c, r, so, n, v1, cp, sp, pool_f)
    t_e = tracer._emitter_distance(so, om, c, r)
    s_bt = tracer._closest_t(sph, tri, so, om)
    valid = (s_bt < tracer._INF) & (s_bt >= t_e * tracer._VIS_SCALE - tracer._VIS_SLACK) \
        & (t_e < tracer._INF)
    le = le_sph[row]
    f = torch.stack([thr[k][lanes] * mats[k][lanes] * tracer._INV_PI * le[:, k] for k in range(3)],
                    dim=1)
    return {"lane": lanes, "valid": valid, "row": row, "so": so, "n": n, "v1": v1, "cp": cp,
            "sp": sp, "pool_f": pool_f, "F": f}


def _detached(scene: dict) -> dict:
    return {k: ({f: t.detach() for f, t in v.items()} if isinstance(v, dict) else v.detach())
            for k, v in scene.items()}


def render_physical_fused(scene, cam, height, width, spp, max_bounces, seed, jitter=False,
                          row_ids=None, count=False, radius_chain=True):
    """B3's image (rows, W, 3) of ``scene`` (``tracer.tensors``), with a
    live chain from the spheres' ``center`` and ``radius``, where they
    require a gradient, through the cone weight of every light sample that
    counted (module docstring); with ``count``, ``(image, events)``: B3's
    four and ``valid_samples``. ``radius_chain=False`` holds the radius in
    the chain (a fault the controls plant)."""
    flat = _detached(scene)
    f = tracer._Frame(flat, cam, height, width, row_ids)
    sph, sph_m, tri, tri_m, mat_tab = f.tabs
    em = tracer._emitters(flat)
    mat_est = flat["materials"]["emission_strength"]
    n_mat = mat_tab.shape[0]
    device = f.zero.device
    acc = (f.zero, f.zero, f.zero)
    counter = torch.zeros(len(EVENTS), dtype=torch.int64, device=device)
    sp = scene["spheres"]
    live = sp["center"].requires_grad or sp["radius"].requires_grad
    samples = []
    for s in range(spp):
        st, d = f.start(s, seed, jitter)
        o, thr, rad = f.origin, (f.one, f.one, f.one), (f.zero, f.zero, f.zero)
        prevd = torch.zeros(f.n, dtype=torch.bool, device=device)
        for _ in range(max_bounces + 1):
            running = (thr[0] != 0.0) | (thr[1] != 0.0) | (thr[2] != 0.0)
            hit = tracer._closest_hit(sph, sph_m, tri, tri_m, o, d)
            m = hit[2]
            mats = tracer._fetch_materials(mat_tab, m)
            est = torch.where((m >= 0) & (m < n_mat), mat_est[m.clamp(0, n_mat - 1).long()], 0.0)
            path = (o, d, thr, st)  # as the bounce starts
            o, d, thr, rad, st, prevd, (hitm, diffuse, faces) = tracer._bounce_physical(
                f.tabs, em, hit, mats, est, o, d, thr, rad, st, prevd, f.sky)
            if not (live or count):
                continue
            diffuse = running & hitm & diffuse
            light = _light_lanes(f.tabs, em, hit, mats, path, diffuse & faces)
            samples.append(light)
            if count:
                counter = counter + torch.stack(
                    [running.sum(), diffuse.sum(), (diffuse & (em[2] > 0)).sum(),
                     (diffuse & faces).sum(), light["valid"].sum()])
        acc = tuple(a + (r + t * k) for a, r, t, k in zip(acc, rad, thr, f.sky))
    img = f.image(acc, spp)
    if live:
        img = img + _chain(sp, samples, f.n, spp, radius_chain).reshape(img.shape)
    if count:
        return img, dict(zip(EVENTS, counter.tolist()))
    return img


def _chain(spheres, samples, n, spp, radius_chain=True):
    """``sum F (w - detach(w)) / spp`` a pixel over the light samples that
    counted, ``w`` from the spheres' live centre and radius (the radius
    held without ``radius_chain``): zero, with the chain's gradient."""
    valid = torch.cat([s["valid"] for s in samples])
    cat = lambda key: torch.cat([s[key] for s in samples])[valid]
    cat3 = lambda key: tuple(torch.cat([s[key][i] for s in samples])[valid] for i in range(3))
    row = cat("row")
    c = spheres["center"][row]
    r = spheres["radius"][row] if radius_chain else spheres["radius"][row].detach()
    w, _ = cone_w(c.unbind(1), r, cat3("so"), cat3("n"), cat("v1"),
                  cat("cp"), cat("sp"), samples[0]["pool_f"])
    term = cat("F") * (w - w.detach())[:, None]
    out = torch.zeros((n, 3), dtype=term.dtype, device=term.device).index_add(0, cat("lane"), term)
    return out * _rng.f32(1.0 / spp)


def _live_scene(scene, var, sphere):
    """``scene`` with the sphere ``sphere``'s centre and radius from the
    fit's variables (the radius through softplus)."""
    sp = scene["spheres"]
    idx = torch.tensor([sphere], device=sp["center"].device)
    radius = F.softplus(var["radius_raw"])
    return {**scene, "spheres": {**sp, "center": sp["center"].index_copy(0, idx, var["center"]),
                                 "radius": sp["radius"].index_copy(0, idx, radius)}}


def follow(true_tables: dict, init_tables: dict, cam_arrays: dict, shape, seed0: int,
           target_seed: int, sphere: int = 0, steps: int = 3, lr: float = 0.05, device="cpu",
           dt=torch.float32, path=None, block_rows: int = 1024, row_step: int = 1,
           radius_chain: bool = True) -> dict:
    """The first ``steps`` steps of a fit of sphere ``sphere``'s centre and
    radius from ``init_tables`` towards B3's image of ``true_tables``
    rendered at ``target_seed`` without jitter, step ``i`` at ``seed0 + i +
    1``, in the precision ``dt``. With ``path`` (the variables before each
    step as another run took them, dicts of ``VARIABLES``), step ``i``
    starts from ``path[i]``, not from the reference's own last step: the
    loss is rough in the light's position (a last-place difference in the
    variables moves a later step's loss by tenths), so two runs are
    compared at the same points; Adam's moments stay the reference's own.
    Returns ``losses`` (one a step), ``grad`` (the first step's gradient of
    each variable), ``start``, ``end`` (``start`` plus the reference's
    updates) and ``path`` (the variables before each step), all as float64
    on the CPU. Rendered ``block_rows`` rows at a time. The controls'
    faults: ``row_step=2`` takes the loss over every other row, the mean
    over those; ``radius_chain=False`` holds the radius in the chain."""
    height, width, spp, max_bounces = shape
    cam = tracer.camera_tensors(cam_arrays, device, dt)
    blocks = torch.arange(0, height, row_step).split(block_rows)
    with torch.no_grad():
        true_scene = tracer.tensors(true_tables, device, dt)
        target = torch.cat([tracer.render_physical(true_scene, cam, height, width, spp,
                                                   max_bounces, target_seed, jitter=False,
                                                   row_ids=b) for b in blocks])
    scene = tracer.tensors(init_tables, device, dt)
    sp = scene["spheres"]
    var = {"center": sp["center"][sphere:sphere + 1].clone().requires_grad_(),
           "radius_raw": _inv_softplus(sp["radius"][sphere:sphere + 1]).requires_grad_()}
    host = lambda d: {k: v.detach().double().cpu() for k, v in d.items()}
    start = host(var)
    end = dict(start)
    m = {k: torch.zeros_like(v) for k, v in var.items()}
    v2 = {k: torch.zeros_like(v) for k, v in var.items()}
    losses, first, taken = [], None, []
    n_values = sum(len(b) for b in blocks) * width * 3
    for i in range(steps):
        if path is not None:
            with torch.no_grad():
                for k, v in var.items():
                    v.copy_(path[i][k])
        taken.append(host(var))
        seed = (seed0 + i + 1) & 0xFFFFFFFF
        grads = {k: torch.zeros_like(v) for k, v in var.items()}
        imgs, at = [], 0
        for b in blocks:
            live = _live_scene(scene, var, sphere)
            img = render_physical_fused(live, cam, height, width, spp, max_bounces, seed,
                                        row_ids=b, radius_chain=radius_chain)
            part = torch.sum((img - target[at:at + len(b)]) ** 2) / n_values
            if part.requires_grad:
                got = torch.autograd.grad(part, [var[k] for k in VARIABLES], allow_unused=True)
                for k, g in zip(VARIABLES, got):
                    if g is not None:
                        grads[k] += g
            imgs.append(img.detach())
            at += len(b)
        value = torch.mean((torch.cat(imgs) - target) ** 2)
        losses.append(float(value))
        if first is None:
            first = host(grads)
        t = i + 1
        with torch.no_grad():
            for k, g in grads.items():
                m[k] = 0.9 * m[k] + 0.1 * g
                v2[k] = 0.999 * v2[k] + 0.001 * g * g
                m_hat = m[k] / (1.0 - 0.9 ** t)
                v_hat = v2[k] / (1.0 - 0.999 ** t)
                var[k] -= lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
        end = {k: end[k] + (v - taken[-1][k]) for k, v in host(var).items()}
    return {"losses": losses, "grad": first, "start": start, "end": end, "path": taken}
