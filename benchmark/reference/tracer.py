"""The plain reference of the three render kernels the cells time, in
plain PyTorch: what each computes, written out again from the benchmark's
own tables (``scenes.py``), operation for operation as the kernels'
arithmetic is specified, so that on the card a sound kernel gives the
same image.

- ``forward``: the reference tier's estimator (the kernel B1,
  ``csrc/render_fwd.cu``): the half-b sphere quadratic, Moller-Trumbore,
  sphere normals normalised once after the closest-hit selection, one
  perturbed-normal reflection or refraction a bounce, termination as zero
  throughput.
- ``fused``: the same estimator with the image's Jacobian with respect to
  every material's albedo, emission and transparency and the sky (the
  kernel B2, ``csrc/render_fused.cu``): a path stops at a miss or a death
  by total internal reflection only.
- ``physical``: the physical tier (the kernel B3, ``csrc/render_phys.cu``):
  cosine-weighted diffuse, mirror and refraction lobes and one light
  sample of an emissive sphere a diffuse vertex, with its shadow scan.

Every function takes ``dt``, the floating-point type it computes in:
float32 is the reference, bfloat16 its control (the nearest precision
below the configuration's). Integer work (the random stream, indices)
is the same in both. The images are of the rows ``row_ids`` (default the
whole image; the random streams and the rays are keyed on global pixels,
so a row is the same wherever it is rendered), and each renderer can
count the events its kernel runs (``count=True``).
"""

from __future__ import annotations

import math

import torch

from . import rng as _rng
from .rng import f32, sqrt_rn

_INF = float("inf")
_TRI_EPS = f32(1e-6)
_EPS_OFFSET = f32(1e-4)
_EPS_SCALE = f32(4e-6)
_K_FLOOR = f32(1e-12)
_N_FLOOR = f32(1e-20)
_RATIO_FLOOR = f32(1e-6)
_J_PLANES = 9  # Jacobian planes a material: albedo, emission, transparency (x3)

_INV_PI = f32(1.0 / math.pi)
_TWO_PI = f32(2.0 * math.pi)
_SIN2_CAP = f32(1.0 - 1e-7)
_VIS_SCALE = f32(1.0 - 1e-3)
_VIS_SLACK = f32(1e-4)
_D2_FLOOR = f32(1e-12)
_PDF_FLOOR = f32(1e-8)
_DET_FLOOR = f32(1e-30)

# The events each renderer counts, as its kernel's counters name them.
EVENTS = {"forward": ("rounds",), "fused": ("rounds",),
          "physical": ("rounds", "diffuse_vertices", "light_samples", "shadow_scans")}


# -- tables ---------------------------------------------------------------------


def tensors(tables: dict, device, dt=torch.float32) -> dict:
    """The numpy tables of ``scenes.py`` as tensors on ``device``: floats
    in ``dt``, material indices int32, masks bool."""
    def conv(a):
        t = torch.as_tensor(a).to(device)
        return t.to(dt) if t.is_floating_point() else t

    out = {k: {f: conv(v) for f, v in tables[k].items()}
           for k in ("materials", "spheres", "triangles")}
    out["sky_color"] = conv(tables["sky_color"])
    return out


def camera_tensors(cam: dict, device, dt=torch.float32) -> dict:
    return {k: torch.as_tensor(v).to(device=device, dtype=dt) for k, v in cam.items()}


def _face_normals(v0, v1, v2):
    e1 = v0 - v1
    e2 = v0 - v2
    n = torch.stack(
        [e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
         e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
         e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]],
        dim=-1,
    )
    return n * torch.rsqrt(torch.clamp_min(torch.sum(n * n, -1, keepdim=True), _N_FLOOR))


def pack(scene: dict):
    """Row-major tables: spheres (S, 5) centre, radius, active; triangles
    (T, 13) vertices, unit face normal, active; materials (M, 9) albedo,
    emission colour x strength, roughness, transparency, ior; and every
    object's material index."""
    sp, tr, m = scene["spheres"], scene["triangles"], scene["materials"]
    dt = m["albedo"].dtype
    sph = torch.cat([sp["center"], sp["radius"][:, None], sp["active"].to(dt)[:, None]], 1)
    tri = torch.cat([tr["v0"], tr["v1"], tr["v2"], _face_normals(tr["v0"], tr["v1"], tr["v2"]),
                     tr["active"].to(dt)[:, None]], 1)
    mat = torch.cat([m["albedo"], m["emission_color"] * m["emission_strength"][:, None],
                     m["roughness"][:, None], m["transparency"][:, None],
                     m["refractive_index"][:, None]], 1)
    return sph, sp["material"], tri, tr["material"], mat


def camera_params(cam: dict, scene: dict, height: int, width: int):
    """(17,): tan(fov/2), aspect, sky rgb, origin, right, up, forward."""
    dt = cam["origin"].dtype
    tan2 = torch.tan(cam["fov"] * 0.5).reshape(1)
    aspect = torch.tensor([f32(width / height)], dtype=dt, device=cam["origin"].device)
    return torch.cat([tan2, aspect, scene["sky_color"], cam["origin"], cam["right"],
                      cam["up"], cam["forward"]])


def _pixel_grid(width, row_ids, dt):
    """Global pixel indices of the rows ``row_ids``, row-major, with each
    pixel's row and column in ``dt``."""
    pix = (row_ids[:, None] * width
           + torch.arange(width, dtype=torch.int64, device=row_ids.device)).reshape(-1)
    prow = torch.div(pix, width, rounding_mode="floor").to(dt)
    return pix, prow, (pix % width).to(dt)


def _camera_dir(par, px, py, fw, fh):
    x = px / fw * 2.0 - 1.0
    y = -(py / fh * 2.0 - 1.0)
    cx = x * par[0]
    cy = y * par[0] / par[1]
    dx = cx * par[8] + cy * par[11] + par[14]
    dy = cx * par[9] + cy * par[12] + par[15]
    dz = cx * par[10] + cy * par[13] + par[16]
    n = torch.rsqrt(dx * dx + dy * dy + dz * dz)
    return dx * n, dy * n, dz * n


# -- intersection -----------------------------------------------------------------


def _sphere_ts(sph, o, d):
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    dd = dx * dx + dy * dy + dz * dz
    invdd = 1.0 / dd
    cx, cy, cz, r, act = sph.unbind(1)
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    h = ocx * dx + ocy * dy + ocz * dz
    cq = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    det = h * h - dd * cq
    sq = sqrt_rn(torch.clamp_min(det, 0.0))
    t1 = (-h - sq) * invdd
    t2 = (-h + sq) * invdd
    t = torch.where(t1 >= 0.0, t1, torch.where(t2 >= 0.0, t2, _INF))
    return torch.where((det >= 0.0) & (act > 0.0), t, _INF)


def _triangle_ts(tri, o, d):
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    v0x, v0y, v0z = tri[:, 0], tri[:, 1], tri[:, 2]
    e1x, e1y, e1z = tri[:, 3] - v0x, tri[:, 4] - v0y, tri[:, 5] - v0z
    e2x, e2y, e2z = tri[:, 6] - v0x, tri[:, 7] - v0y, tri[:, 8] - v0z
    rcx = dy * e2z - dz * e2y
    rcy = dz * e2x - dx * e2z
    rcz = dx * e2y - dy * e2x
    tdet = e1x * rcx + e1y * rcy + e1z * rcz
    nonpar = torch.abs(tdet) >= _TRI_EPS
    inv = 1.0 / torch.where(nonpar, tdet, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = inv * (sx * rcx + sy * rcy + sz * rcz)
    scx = sy * e1z - sz * e1y
    scy = sz * e1x - sx * e1z
    scz = sx * e1y - sy * e1x
    v = inv * (dx * scx + dy * scy + dz * scz)
    tt = inv * (e2x * scx + e2y * scy + e2z * scz)
    ok = (nonpar & (u >= _TRI_EPS) & (u <= 1.0) & (v >= _TRI_EPS)
          & (u + v <= 1.0) & (tt >= _TRI_EPS) & (tri[:, 12] > 0.0))
    return torch.where(ok, tt, _INF)


def _closest_hit(sph, sph_m, tri, tri_m, o, d):
    """Closest hit over the spheres, then the triangles (a tie keeps the
    first object, a sphere over a triangle): ``(t, normal, material,
    sphere won)``, t = +inf on a miss."""
    best, si = torch.min(_sphere_ts(sph, o, d), dim=1)
    hit = best < _INF
    cx, cy, cz = sph[:, 0], sph[:, 1], sph[:, 2]
    ts = torch.where(hit, best, 0.0)
    nx = o[0] + ts * d[0] - torch.where(hit, cx[si], 0.0)
    ny = o[1] + ts * d[1] - torch.where(hit, cy[si], 0.0)
    nz = o[2] + ts * d[2] - torch.where(hit, cz[si], 0.0)
    hn = torch.rsqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, _N_FLOOR))
    nx, ny, nz = nx * hn, ny * hn, nz * hn
    mat = torch.where(hit, sph_m[si], 0)

    tbest, ti = torch.min(_triangle_ts(tri, o, d), dim=1)
    upd = tbest < best
    fnx, fny, fnz = tri[ti, 9], tri[ti, 10], tri[ti, 11]
    sgn = torch.where(fnx * d[0] + fny * d[1] + fnz * d[2] < 0.0, 1.0, -1.0)
    best = torch.where(upd, tbest, best)
    nx = torch.where(upd, sgn * fnx, nx)
    ny = torch.where(upd, sgn * fny, ny)
    nz = torch.where(upd, sgn * fnz, nz)
    mat = torch.where(upd, tri_m[ti], mat)
    return best, (nx, ny, nz), mat, hit & ~upd


def _closest_t(sph, tri, o, d):
    return torch.minimum(_sphere_ts(sph, o, d).min(dim=1).values,
                         _triangle_ts(tri, o, d).min(dim=1).values)


def _fetch_materials(mat_tab, m):
    n_mat = mat_tab.shape[0]
    valid = (m >= 0) & (m < n_mat)
    rows = mat_tab[m.clamp(0, n_mat - 1).long()]
    default = torch.zeros(9, dtype=rows.dtype, device=rows.device)
    default[8] = 1.0
    return torch.where(valid[:, None], rows, default).unbind(1)


# -- the reference tier (B1, B2) ----------------------------------------------------


def _shade(hit, mats, o, d, thr, rad, st, sky):
    """One bounce of every path; dead ones add exact zeros. Returns the
    next origin, direction, throughput, radiance, state and the round's
    ``(hit, refracted, died)`` masks."""
    best, (nx, ny, nz) = hit[:2]
    dx, dy, dz = d
    tr, tg, tb = thr
    ar, ag, ab = rad
    dt = dx.dtype
    hitmask = best < _INF
    ar = ar + torch.where(hitmask, 0.0, tr * sky[0])
    ag = ag + torch.where(hitmask, 0.0, tg * sky[1])
    ab = ab + torch.where(hitmask, 0.0, tb * sky[2])
    ts = torch.where(hitmask, best, 0.0)
    px = o[0] + ts * dx
    py = o[1] + ts * dy
    pz = o[2] + ts * dz

    alb_r, alb_g, alb_b, em_r, em_g, em_b, rgh, trn, ior = mats
    ar = ar + torch.where(hitmask, tr * em_r, 0.0)
    ag = ag + torch.where(hitmask, tg * em_g, 0.0)
    ab = ab + torch.where(hitmask, tb * em_b, 0.0)
    tr = torch.where(hitmask, tr * alb_r, 0.0)
    tg = torch.where(hitmask, tg * alb_g, 0.0)
    tb = torch.where(hitmask, tb * alb_b, 0.0)

    st, (sx, sy, sz) = _rng.unit_sphere(st, dt)
    st, u_branch = _rng.uniform(st, dt)

    wnx = nx + rgh * sx
    wny = ny + rgh * sy
    wnz = nz + rgh * sz
    wn = torch.rsqrt(torch.clamp_min(wnx * wnx + wny * wny + wnz * wnz, _N_FLOOR))
    wnx, wny, wnz = wnx * wn, wny * wn, wnz * wn

    ndot = dx * wnx + dy * wny + dz * wnz
    rfx = dx - 2.0 * ndot * wnx
    rfy = dy - 2.0 * ndot * wny
    rfz = dz - 2.0 * ndot * wnz
    entering = ndot < 0.0
    eta = torch.where(entering, 1.0 / ior, ior)
    rnx = torch.where(entering, wnx, -wnx)
    rny = torch.where(entering, wny, -wny)
    rnz = torch.where(entering, wnz, -wnz)
    ni = rnx * dx + rny * dy + rnz * dz
    k = 1.0 - eta * eta * (1.0 - ni * ni)
    tirm = k < 0.0
    coef = eta * ni + sqrt_rn(torch.where(tirm, 1.0, torch.clamp_min(k, _K_FLOOR)))
    txx = torch.where(tirm, 0.0, eta * dx - coef * rnx)
    txy = torch.where(tirm, 0.0, eta * dy - coef * rny)
    txz = torch.where(tirm, 0.0, eta * dz - coef * rnz)

    choose_refr = u_branch < trn
    ndx = torch.where(choose_refr, txx, rfx)
    ndy = torch.where(choose_refr, txy, rfy)
    ndz = torch.where(choose_refr, txz, rfz)
    died = choose_refr & tirm
    tr = torch.where(died, 0.0, tr)
    tg = torch.where(died, 0.0, tg)
    tb = torch.where(died, 0.0, tb)
    ndx = torch.where(died, dx, ndx)
    ndy = torch.where(died, dy, ndy)
    ndz = torch.where(died, dz, ndz)

    offs = _EPS_OFFSET + _EPS_SCALE * sqrt_rn(px * px + py * py + pz * pz)
    side = torch.where(ndx * nx + ndy * ny + ndz * nz >= 0.0, 1.0, -1.0)
    o = (px + offs * side * nx, py + offs * side * ny, pz + offs * side * nz)
    return o, (ndx, ndy, ndz), (tr, tg, tb), (ar, ag, ab), st, (hitmask, choose_refr, died)


class _Frame:
    """What every renderer sets up for a block of rows: the packed tables,
    the camera parameters, the pixels' primary directions and constants."""

    def __init__(self, scene, cam, height, width, row_ids):
        self.dt = dt = scene["materials"]["albedo"].dtype
        device = scene["sky_color"].device
        if row_ids is None:
            row_ids = torch.arange(height)
        row_ids = torch.as_tensor(row_ids, dtype=torch.int64).to(device)
        self.rows = len(row_ids)
        self.tabs = pack(scene)
        self.par = par = camera_params(cam, scene, height, width)
        self.sky = (par[2], par[3], par[4])
        self.n = n = self.rows * width
        self.pix, self.prow, self.cols = _pixel_grid(width, row_ids, dt)
        self.fw, self.fh = (torch.tensor(float(v), dtype=dt, device=device)
                            for v in (width, height))
        self.pd = _camera_dir(par, self.cols + 0.5, self.prow + 0.5, self.fw, self.fh)
        self.origin = tuple(par[i].expand(n) for i in (5, 6, 7))
        self.zero = torch.zeros(n, dtype=dt, device=device)
        self.one = torch.ones(n, dtype=dt, device=device)
        self.width = width

    def start(self, s, seed, jitter):
        """A sample's RNG state and primary direction."""
        st = _rng.seed_state(self.pix, s, seed)
        d = self.pd
        if jitter:
            st, jx = _rng.uniform(st, self.dt)
            st, jy = _rng.uniform(st, self.dt)
            d = _camera_dir(self.par, self.cols + jx, self.prow + jy, self.fw, self.fh)
        return st, d

    def image(self, acc, spp):
        inv = f32(1.0 / spp)
        return torch.stack([a * inv for a in acc], dim=-1).reshape(self.rows, self.width, 3)


def render_forward(scene, cam, height, width, spp, max_bounces, seed, jitter=False,
                   row_ids=None, count=False):
    """B1's image (rows, W, 3); with ``count``, ``(image, {"rounds"})``:
    the rounds a kernel thread runs, those a path begins with nonzero
    throughput."""
    f = _Frame(scene, cam, height, width, row_ids)
    sph, sph_m, tri, tri_m, mat_tab = f.tabs
    acc = (f.zero, f.zero, f.zero)
    rounds = torch.zeros((), dtype=torch.int64, device=f.zero.device)
    for s in range(spp):
        st, d = f.start(s, seed, jitter)
        o, thr, rad = f.origin, (f.one, f.one, f.one), (f.zero, f.zero, f.zero)
        for _ in range(max_bounces + 1):
            if count:
                rounds = rounds + ((thr[0] != 0.0) | (thr[1] != 0.0) | (thr[2] != 0.0)).sum()
            hit = _closest_hit(sph, sph_m, tri, tri_m, o, d)
            mats = _fetch_materials(mat_tab, hit[2])
            o, d, thr, rad, st, _ = _shade(hit, mats, o, d, thr, rad, st, f.sky)
        acc = tuple(a + (r + t * k) for a, r, t, k in zip(acc, rad, thr, f.sky))
    img = f.image(acc, spp)
    return (img, {"rounds": int(rounds)}) if count else img


def render_fused(scene, cam, height, width, spp, max_bounces, seed, jitter=False,
                 row_ids=None, count=False):
    """B2's ``(image, jac)``: the image equals ``render_forward``'s, ``jac``
    (9 M + 3, rows, W) holds per material the albedo, emission and
    transparency planes and then the three sky planes; with ``count`` also
    ``{"rounds"}``, the rounds a path is alive (a miss or a death ends it,
    zero throughput does not)."""
    f = _Frame(scene, cam, height, width, row_ids)
    sph, sph_m, tri, tri_m, mat_tab = f.tabs
    n, sky, device = f.n, f.sky, f.zero.device
    n_mat = mat_tab.shape[0]
    plane = torch.arange(_J_PLANES, device=device)[:, None]
    acc = (f.zero, f.zero, f.zero)
    jac = torch.zeros((_J_PLANES * n_mat + 3, n), dtype=f.dt, device=device)
    k_sky = [f.zero, f.zero, f.zero]
    rounds = torch.zeros((), dtype=torch.int64, device=device)
    for s in range(spp):
        st, d = f.start(s, seed, jitter)
        o, thr, rad = f.origin, (f.one, f.one, f.one), (f.zero, f.zero, f.zero)
        alive = torch.ones(n, dtype=torch.bool, device=device)
        stores = []
        for _ in range(max_bounces + 1):
            if count:
                rounds = rounds + alive.sum()
            hit = _closest_hit(sph, sph_m, tri, tri_m, o, d)
            mats = _fetch_materials(mat_tab, hit[2])
            before = thr
            o, d, thr, rad, st, (hitmask, refracted, died) = _shade(
                hit, mats, o, d, thr, rad, st, sky)
            hit_ev = alive & hitmask
            stores.append((before, hit[2], mats[:6], mats[7], hit_ev,
                           alive & ~hitmask, hit_ev & died, refracted))
            alive = hit_ev & ~died
        acc = tuple(a + (r + t * k) for a, r, t, k in zip(acc, rad, thr, sky))
        k_sky = [k + t for k, t in zip(k_sky, thr)]

        carry = tuple(k.expand(n) for k in sky)
        for before, m, (alb_r, alb_g, alb_b, em_r, em_g, em_b), trn, hit_ev, \
                miss_ev, died_ev, refracted in reversed(stores):
            k_sky = [k + torch.where(miss_ev, p, 0.0) for k, p in zip(k_sky, before)]
            held = tuple(torch.where(died_ev, 0.0, t) for t in carry)
            valid = hit_ev & (m >= 0) & (m < n_mat)
            c_a = [torch.where(valid, p * t, 0.0) for p, t in zip(before, held)]
            c_s = [torch.where(valid, p, 0.0) for p in before]
            dr = torch.where(
                refracted,
                1.0 / torch.clamp_min(trn, _RATIO_FLOOR),
                -1.0 / torch.clamp_min(1.0 - trn, _RATIO_FLOOR),
            )
            c_r = [c * dr for c in c_a]
            base = _J_PLANES * torch.where(valid, m, 0).long()
            jac.scatter_add_(0, base[None, :] + plane, torch.stack(c_a + c_s + c_r))
            carry = tuple(
                torch.where(hit_ev, em + alb * t, torch.where(miss_ev, k, c))
                for em, alb, t, k, c in zip(
                    (em_r, em_g, em_b), (alb_r, alb_g, alb_b), held, sky, carry)
            )
    jac[_J_PLANES * n_mat:] = torch.stack(k_sky)
    img = f.image(acc, spp)
    jac = jac.reshape(-1, f.rows, width)
    return (img, jac, {"rounds": int(rounds)}) if count else (img, jac)


# -- the physical tier (B3) ---------------------------------------------------------


def _emitters(scene):
    """The emitter pool of spheres: the row of the k-th emitter (a pick
    list; entries from the emitter count on hold the last row), each
    sphere's premultiplied radiance, and the pool's size."""
    mats, sp = scene["materials"], scene["spheres"]
    m = sp["material"].long()
    mask = (sp["active"] & (mats["emission_strength"][m] > 0.0)).to(torch.int32)
    cum = torch.cumsum(mask, 0).to(torch.int32)
    le = mats["emission_color"][m] * mats["emission_strength"][m][:, None]
    k1 = torch.arange(1, cum.shape[0] + 1, dtype=cum.dtype, device=cum.device)
    pick = torch.searchsorted(cum, k1, right=False).clamp(max=cum.shape[0] - 1).to(torch.int32)
    return pick, le, mask.sum().to(torch.int32)


def _onb(nx, ny, nz):
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    return (1.0 + sign * nx * nx * a, sign * b, -sign * nx), (b, sign + ny * ny * a, -ny)


def _emitter_distance(so, om, c, r):
    odd = om[0] * om[0] + om[1] * om[1] + om[2] * om[2]
    ocx, ocy, ocz = so[0] - c[0], so[1] - c[1], so[2] - c[2]
    be = 2.0 * (ocx * om[0] + ocy * om[1] + ocz * om[2])
    cqe = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    dete = be * be - 4.0 * odd * cqe
    vale = dete >= 0.0
    sqe = sqrt_rn(torch.where(vale, torch.clamp_min(dete, _DET_FLOOR), 1.0))
    oinv2 = 0.5 / odd
    te1 = (-be - sqe) * oinv2
    te2 = (-be + sqe) * oinv2
    t_e = torch.where(te1 >= 0.0, te1, torch.where(te2 >= 0.0, te2, _INF))
    return torch.where(vale, t_e, _INF)


def _light_sample(sph, tri, em, n, so, thr, alb, hitm, choose_diff, u_pick, v1, v2):
    """One diffuse vertex's sample of an emissive sphere by its cone of
    directions: the radiance it adds (zero where not valid) and the mask
    of samples that face the surface and the emitter (the shadow scans)."""
    pick, le_sph, n_em = em
    nx, ny, nz = n
    sox, soy, soz = so
    pool_f = n_em.to(u_pick.dtype)
    kf = torch.floor(u_pick * pool_f).to(torch.int32)
    kk = torch.minimum(torch.clamp_min(kf, 0), torch.clamp_min(n_em - 1, 0))
    n_sph = sph.shape[0]
    e_idx = torch.where(kk < n_sph, pick[kk.clamp(max=n_sph - 1).long()], n_sph - 1).long()
    cex, cey, cez, rer = sph[e_idx, 0], sph[e_idx, 1], sph[e_idx, 2], sph[e_idx, 3]
    le = le_sph[e_idx].unbind(1)

    dcx, dcy, dcz = cex - sox, cey - soy, cez - soz
    d2 = dcx * dcx + dcy * dcy + dcz * dcz
    dist = sqrt_rn(torch.clamp_min(d2, _D2_FLOOR))
    wzx, wzy, wzz = dcx / dist, dcy / dist, dcz / dist
    sin2max = torch.clamp(rer * rer / torch.clamp_min(d2, _D2_FLOOR), 0.0, _SIN2_CAP)
    cosmax = sqrt_rn(1.0 - sin2max)
    outside = d2 > rer * rer
    cth = 1.0 - v1 * (1.0 - cosmax)
    sth = sqrt_rn(torch.clamp_min(1.0 - cth * cth, _D2_FLOOR))
    cp, sp = _rng.sincos_2pi(v2)
    (tax, tay, taz), (bax, bay, baz) = _onb(wzx, wzy, wzz)
    cphi = sth * cp
    sphi = sth * sp
    omx = cphi * tax + sphi * bax + cth * wzx
    omy = cphi * tay + sphi * bay + cth * wzy
    omz = cphi * taz + sphi * baz + cth * wzz
    pdf_omega = 1.0 / torch.clamp_min(_TWO_PI * (1.0 - cosmax), _PDF_FLOOR)
    cos_surf = nx * omx + ny * omy + nz * omz
    t_e = _emitter_distance(so, (omx, omy, omz), (cex, cey, cez), rer)
    w = cos_surf / pdf_omega * pool_f

    s_bt = _closest_t(sph, tri, so, (omx, omy, omz))
    visible = (s_bt < _INF) & (s_bt >= t_e * _VIS_SCALE - _VIS_SLACK) & (t_e < _INF)
    faces = (n_em > 0) & outside & (cos_surf > 0.0) & (t_e < _INF)
    valid = hitm & choose_diff & faces & visible
    return tuple(torch.where(valid, t * a * _INV_PI * l * w, 0.0)
                 for t, a, l in zip(thr, alb, le)), faces


def _bounce_physical(tabs, em, hit, mats, est, o, d, thr, rad, st, prevd, sky):
    best, (nx, ny, nz), _, sphm = hit
    dx, dy, dz = d
    tr, tg, tb = thr
    ar, ag, ab = rad
    dt = dx.dtype
    hitm = best < _INF
    ar = ar + torch.where(hitm, 0.0, tr * sky[0])
    ag = ag + torch.where(hitm, 0.0, tg * sky[1])
    ab = ab + torch.where(hitm, 0.0, tb * sky[2])
    tr = torch.where(hitm, tr, 0.0)
    tg = torch.where(hitm, tg, 0.0)
    tb = torch.where(hitm, tb, 0.0)

    alb_r, alb_g, alb_b, em_r, em_g, em_b, rgh, trn, ior = mats
    # Le, skipped where a diffuse-sampled ray arrives at an emitter that the
    # previous vertex could have light-sampled.
    nee_counted = prevd & sphm & (est > 0.0) & (em[2] > 0)
    ar = ar + torch.where(nee_counted, 0.0, tr * em_r)
    ag = ag + torch.where(nee_counted, 0.0, tg * em_g)
    ab = ab + torch.where(nee_counted, 0.0, tb * em_b)

    st, u_transp = _rng.uniform(st, dt)
    st, u_lobe = _rng.uniform(st, dt)
    st, u1 = _rng.uniform(st, dt)
    st, u2 = _rng.uniform(st, dt)
    st, u_pick = _rng.uniform(st, dt)
    st, v1 = _rng.uniform(st, dt)
    st, v2 = _rng.uniform(st, dt)

    choose_refr = u_transp < trn
    choose_diff = ~choose_refr & (u_lobe < rgh)

    ndot = dx * nx + dy * ny + dz * nz
    entering = ndot < 0.0
    eta = torch.where(entering, 1.0 / ior, ior)
    rnx = torch.where(entering, nx, -nx)
    rny = torch.where(entering, ny, -ny)
    rnz = torch.where(entering, nz, -nz)
    ni = rnx * dx + rny * dy + rnz * dz
    k = 1.0 - eta * eta * (1.0 - ni * ni)
    tirm = k < 0.0
    coef = eta * ni + sqrt_rn(torch.where(tirm, 1.0, torch.clamp_min(k, _K_FLOOR)))
    txx = torch.where(tirm, 0.0, eta * dx - coef * rnx)
    txy = torch.where(tirm, 0.0, eta * dy - coef * rny)
    txz = torch.where(tirm, 0.0, eta * dz - coef * rnz)
    rfx = dx - 2.0 * ndot * nx
    rfy = dy - 2.0 * ndot * ny
    rfz = dz - 2.0 * ndot * nz
    rdiff = sqrt_rn(u1)
    cphi_d, sphi_d = _rng.sincos_2pi(u2)
    lx = rdiff * cphi_d
    ly = rdiff * sphi_d
    lz = sqrt_rn(torch.clamp_min(1.0 - u1, 0.0))
    (tx, ty, tz), (bx, by, bz) = _onb(nx, ny, nz)
    ddx = lx * tx + ly * bx + lz * nx
    ddy = lx * ty + ly * by + lz * ny
    ddz = lx * tz + ly * bz + lz * nz

    ndx = torch.where(choose_refr, txx, torch.where(choose_diff, ddx, rfx))
    ndy = torch.where(choose_refr, txy, torch.where(choose_diff, ddy, rfy))
    ndz = torch.where(choose_refr, txz, torch.where(choose_diff, ddz, rfz))
    died = choose_refr & tirm
    tr = torch.where(died, 0.0, tr)
    tg = torch.where(died, 0.0, tg)
    tb = torch.where(died, 0.0, tb)
    ndx = torch.where(died, dx, ndx)
    ndy = torch.where(died, dy, ndy)
    ndz = torch.where(died, dz, ndz)

    ts = torch.where(hitm, best, 0.0)
    px = o[0] + ts * dx
    py = o[1] + ts * dy
    pz = o[2] + ts * dz
    offs = _EPS_OFFSET + _EPS_SCALE * sqrt_rn(px * px + py * py + pz * pz)

    so = (px + offs * nx, py + offs * ny, pz + offs * nz)
    (nr, ng, nb), faces = _light_sample(
        tabs[0], tabs[2], em, (nx, ny, nz), so, (tr, tg, tb), (alb_r, alb_g, alb_b), hitm,
        choose_diff, u_pick, v1, v2)
    ar, ag, ab = ar + nr, ag + ng, ab + nb

    tr = tr * alb_r
    tg = tg * alb_g
    tb = tb * alb_b
    side = torch.where(ndx * nx + ndy * ny + ndz * nz >= 0.0, 1.0, -1.0)
    o = (px + offs * side * nx, py + offs * side * ny, pz + offs * side * nz)
    prevd = torch.where(hitm & ~died, choose_diff, prevd)
    return o, (ndx, ndy, ndz), (tr, tg, tb), (ar, ag, ab), st, prevd, (hitm, choose_diff, faces)


def render_physical(scene, cam, height, width, spp, max_bounces, seed, jitter=True,
                    row_ids=None, count=False):
    """B3's image (next-event estimation on, sphere emitters); with
    ``count``, ``(image, events)``: rounds (a path begins the round with
    nonzero throughput), diffuse vertices, light samples and shadow
    scans among them."""
    f = _Frame(scene, cam, height, width, row_ids)
    sph, sph_m, tri, tri_m, mat_tab = f.tabs
    em = _emitters(scene)
    mat_est = scene["materials"]["emission_strength"]
    n_mat = mat_tab.shape[0]
    device = f.zero.device
    acc = (f.zero, f.zero, f.zero)
    counter = torch.zeros(4, dtype=torch.int64, device=device)
    for s in range(spp):
        st, d = f.start(s, seed, jitter)
        o, thr, rad = f.origin, (f.one, f.one, f.one), (f.zero, f.zero, f.zero)
        prevd = torch.zeros(f.n, dtype=torch.bool, device=device)
        for _ in range(max_bounces + 1):
            running = (thr[0] != 0.0) | (thr[1] != 0.0) | (thr[2] != 0.0)
            hit = _closest_hit(sph, sph_m, tri, tri_m, o, d)
            m = hit[2]
            mats = _fetch_materials(mat_tab, m)
            est = torch.where((m >= 0) & (m < n_mat), mat_est[m.clamp(0, n_mat - 1).long()], 0.0)
            o, d, thr, rad, st, prevd, (hitm, diffuse, faces) = _bounce_physical(
                f.tabs, em, hit, mats, est, o, d, thr, rad, st, prevd, f.sky)
            if count:
                diffuse = running & hitm & diffuse
                light = diffuse & (em[2] > 0)
                counter = counter + torch.stack(
                    [running.sum(), diffuse.sum(), light.sum(), (light & faces).sum()])
        acc = tuple(a + (r + t * k) for a, r, t, k in zip(acc, rad, thr, f.sky))
    img = f.image(acc, spp)
    if count:
        return img, dict(zip(EVENTS["physical"], counter.tolist()))
    return img


def count_events(render, scene, cam, height, width, spp, max_bounces, seed, jitter,
                 stride: int = 16):
    """The events a kernel runs in one render, as its reference ``render``
    (one of the renderers here, or of a module beside them) counts them
    (``count=True``), on every ``stride``-th row (the middle row of each
    band of ``stride`` rows, rendered together) and scaled to the whole
    image. Returns ``(events, share of the rows counted)``."""
    row_ids = torch.arange(height // stride) * stride + stride // 2 if stride > 1 else None
    out = render(scene, cam, height, width, spp, max_bounces, seed, jitter=jitter,
                 row_ids=row_ids, count=True)[-1]
    share = (height // stride) / height if stride > 1 else 1.0
    return {k: v / share for k, v in out.items()}, share
