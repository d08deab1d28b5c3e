"""The gradient of the render: the fused primal + Jacobian kernel (hand-
written CUDA), its plain PyTorch twin, the backward contraction, and the
``torch.autograd.Function`` that joins them.

``render_fused`` launches ``csrc/render_fused.cu`` on CUDA tensors, which
replaces the Pallas TPU kernel ``_fused_kernel`` of
``path_tracer_c_tpu/ops/pallas_grad.py``; on CPU tensors it runs
``render_fused_reference``. One pass gives the radiance image, equal to
``render_kernel``'s, and a per-pixel Jacobian of ``9 * M + 3`` planes: per
material A[3] (albedo), S[3] (emission), R[3] (transparency), then the 3
sky planes K. Radiance is a product of albedos and branch ratios times
emissions picked by discrete path events, so every material cotangent is
linear in the image cotangent ``g`` with these per-pixel weights, and the
backward pass is ``contract_jacobian``: a few matrix-vector products.

Per sample, with ``P_b`` the throughput before bounce ``b`` and ``T_b``
the radiance collected after it per unit of throughput (built by a sweep
from the last round down: the sky at the end of the budget and at a miss,
0 after a death by total internal reflection, ``Le + albedo * T`` at a
hit), a hit on material ``m`` adds ``A[m] += P_b T_b``, ``S[m] += P_b``,
``R[m] += P_b T_b dr_b`` (``dr`` is ``1/t`` where the path refracted and
``-1/(1-t)`` where it reflected), a miss adds ``K += P_b``, and the end of
the path adds ``K += P_end``. The bounce loop ends on a miss or a death
only, never on zero throughput: a path that a black albedo killed still
owes ``d_albedo = g P_b T_b`` from the rounds after it.

Cotangents that are zero by contract: roughness, metallicity, refractive
index, every sphere and triangle leaf, and the camera. They enter the
radiance through discrete events only.
"""

from __future__ import annotations

import dataclasses

import torch

from . import rng as _rng
from . import render_kernel as _rk
from .camera import Camera
from .rng import _f32
from ..scene.scene import Scene
from ..utils.tracing import count, span, wait

__all__ = [
    "render_fused", "render_fused_reference", "render_fused_round_counts",
    "render_fused_round_counts_reference", "render_fused_variant", "contract_jacobian",
    "render_kernel_vjp", "replace_leaves", "zeros_like_scene", "MAX_BOUNCES", "VARIANTS",
    "SOURCE", "REPLACES", "FUSED_TILE", "BWD_TILE", "fused_tile",
]

SOURCE = "path_tracer_c_tpu_torch/csrc/render_fused.cu"
REPLACES = "path_tracer_c_tpu/ops/pallas_grad.py:96"

# Jacobian planes per material: A[3] + S[3] + R[3].
_MAT_J_PLANES = 9
# The kernel stores at most kMaxRounds = MAX_BOUNCES + 1 rounds of
# per-bounce records (csrc/render_fused.cu).
MAX_BOUNCES = 31
# B2 keeps a round's material index as int16 (csrc/render_fused.cu).
MAX_MATERIALS = 32767
_RATIO_FLOOR = _f32(1e-6)

# B2's measurement instantiations (csrc/pt_fused.cuh `Variant`), each one
# policy away from the kernel: its plane adds into one register; its records
# in registers (max_bounces <= 3); its records in local memory.
VARIANTS = {"sink": 0, "registers": 1, "local_records": 2}
REGISTER_ROUNDS = 4  # the records of "registers" (csrc/pt_fused.cuh kRegisterRounds)

# B2's tile (the JAX package's name; ``render_kernel.KIND_DEFAULTS``): 8 x 32
# pixels, warps of one row of 32. No point beat it at every shape measured on
# an H100 (PERF.md, tile sweep).
FUSED_TILE = _rk.KIND_DEFAULTS["fused"]
# The tile of ``render_kernel_vjp``'s backward: in the port it is the
# contraction of B2's Jacobian (the JAX package's reference tier has a
# two-pass backward kernel of its own), so B2's.
BWD_TILE = FUSED_TILE


def fused_tile(scene: Scene, rows: int, width: int, max_bounces: int, tile=FUSED_TILE):
    """The point (``render_kernel.Tile``) ``render_fused`` launches at for
    this workload: ``tile`` shrunk where its records would pass what a block
    may hold (``render_kernel.fit_tile``), as the JAX package's
    ``fused_tile``; the one sizing call of the wrapper and its counting
    twin."""
    return _rk.fit_tile("fused", scene, rows, width, max_bounces, tile)

# The scene leaves that carry a gradient, as (table or None, field).
_GRAD_LEAVES = (
    ("materials", "albedo"), ("materials", "emission_color"),
    ("materials", "emission_strength"), ("materials", "transparency"),
    (None, "sky_color"),
)


def render_fused(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    sample_offset: int = 0,
    jitter: bool = False,
    count_rounds: bool = False,
    row_start: int = 0,
    rows: int | None = None,
    tile=None,
):
    """``(image (rows, W, 3), jac (9 * M + 3, rows, W))`` float32, on the
    scene's device, of the block of ``rows`` rows (default: all) from
    ``row_start``, as ``render_kernel`` takes it; with ``count_rounds`` also
    the executed thread-rounds (see ``render_kernel``; this kernel stops a
    thread at a miss or a death only, so it runs more rounds where a
    material is exactly black).

    CUDA tensors go to the hand kernel, built on first use (``ops.build``);
    the counter ``launch.render_fused`` (``utils/tracing.py``) counts its
    launches. CPU tensors go to ``render_fused_reference``. Any other
    device raises, and so does ``max_bounces > MAX_BOUNCES`` on every
    device.

    ``jac`` takes ``(9 * M + 3) * H * W * 4`` bytes (579 MB at 1024 x 1024
    with 15 materials). The wrapper allocates it zero-filled; the kernel
    adds into it.

    ``tile``: the launch shape (``render_kernel.TILES``; default
    ``FUSED_TILE``) as ``fused_tile`` fits it; no output depends on it.
    """
    with span("pt.check.render_fused"):
        rows, t = _fused_inputs(scene, camera, height, width, spp, max_bounces, seed,
                                sample_offset, row_start, rows, tile)
    if scene.device.type == "cpu":
        return render_fused_reference(
            scene, camera, height, width, spp, max_bounces, seed,
            sample_offset=sample_offset, jitter=jitter, count_rounds=count_rounds,
            row_start=row_start, rows=rows,
        )
    img, jac, counter = _launch(scene, camera, height, width, spp, max_bounces, seed,
                                sample_offset, jitter, count_rounds, row_start=row_start,
                                rows=rows, tile=t)
    if not count_rounds:
        return img, jac
    with wait("count_rounds"):
        return img, jac, int(counter[0])


def _fused_inputs(scene, camera, height, width, spp, max_bounces, seed, sample_offset,
                  row_start, rows, tile):
    """``render_kernel._check_inputs`` and B2's cap on the bounces; returns
    the block's row count and the point ``fused_tile`` fits ``tile`` to."""
    rows = _rk._check_inputs(scene, camera, height, width, spp, max_bounces, seed,
                             sample_offset, row_start, rows)
    if max_bounces > MAX_BOUNCES:
        raise ValueError(f"max_bounces {max_bounces} is above the fused kernel's "
                         f"cap of {MAX_BOUNCES}")
    return rows, fused_tile(scene, rows, width, max_bounces, FUSED_TILE if tile is None else tile)


def _launch(scene, camera, height, width, spp, max_bounces, seed, sample_offset, jitter,
            count_on, variant=None, row_start=0, rows=None, tile=None):
    """Launch B2 on the scene's CUDA device over the block of ``rows`` rows
    (None: all) from ``row_start``: the timed kernel at point ``tile``
    (None: the default), its counting
    instantiation (``count_on``: the counters, thread-rounds and warp
    lane-rounds, come back beside the planes), or a measurement variant."""
    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"render_fused runs on CUDA or CPU tensors, not {device}")
    with span("pt.pack.render_fused"):
        from .build import load_library

        lib = load_library()
        if lib.render_fused_max_bounces() != MAX_BOUNCES:
            raise RuntimeError("csrc/render_fused.cu and MAX_BOUNCES disagree")
        if scene.num_materials > MAX_MATERIALS:
            raise ValueError(f"{scene.num_materials} materials: render_fused stores a "
                             f"material index as int16, at most {MAX_MATERIALS}")
        t = _rk.tile_point(tile, "fused")
        _rk._library("render_fused", t)
        operands = _rk._scene_operands(scene)
    with wait("camera_params"):
        par = _rk._camera_params(camera, scene, height, width)
    with span("pt.launch.render_fused"):
        n_j = _MAT_J_PLANES * scene.num_materials + 3
        rows = height if rows is None else rows
        img = torch.empty((rows, width, 3), dtype=torch.float32, device=device)
        jac = torch.zeros((n_j, rows, width), dtype=torch.float32, device=device)
        counter = torch.zeros(2, dtype=torch.int64, device=device) if count_on else None
        args = (*_rk._table_args(operands), _rk._ptr(par), _rk._ptr(img), _rk._ptr(jac))
        run = _rk._run_args(height, width, spp, max_bounces, seed, sample_offset, jitter,
                            device, row_start, rows)
        if variant is None:
            err = _rk._entry("render_fused", t)(*args, _rk._ptr(counter), *run)
            name = f"render_fused at {t.name}"
        else:
            err = lib.render_fused_variant(VARIANTS[variant], *args, *run)
            name = f"render_fused variant {variant}"
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
        count("launch.render_fused" if variant is None else "launch.render_fused.variant")
    return img, jac, counter


def render_fused_round_counts(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    sample_offset: int = 0,
    jitter: bool = False,
    row_start: int = 0,
    rows: int | None = None,
    tile=None,
) -> dict:
    """The rounds B2 runs for one render (of a row block, as
    ``render_fused`` takes it: the blocks' counts sum to the whole's): ``thread_rounds`` (as
    ``count_rounds``) and ``warp_lane_rounds``, the rounds each warp runs
    times its lanes in the image, summed over warps: per sample, as many as
    that sample's longest lane (every lane waits at the end of a sample).
    CUDA tensors run the kernel's counting instantiation (a launch: it
    counts in ``launch.render_fused``), CPU tensors the plain twin, which
    also gives ``warp_lane_rounds_regen``, the rounds path regeneration
    would run (each warp as many as its busiest lane's total over all
    samples). A warp is the footprint of the launch's point (``fused_tile``
    of ``tile``)."""
    with span("pt.check.render_fused"):
        rows, t = _fused_inputs(scene, camera, height, width, spp, max_bounces, seed,
                                sample_offset, row_start, rows, tile)
    if scene.device.type == "cpu":
        return render_fused_round_counts_reference(
            scene, camera, height, width, spp, max_bounces, seed, sample_offset, jitter,
            row_start, rows, tile=t)
    _, _, counter = _launch(scene, camera, height, width, spp, max_bounces, seed,
                            sample_offset, jitter, True, row_start=row_start, rows=rows,
                            tile=t)
    with wait("count_rounds"):
        thread_rounds, warp_rounds = counter.tolist()
    return {"thread_rounds": thread_rounds, "warp_lane_rounds": warp_rounds}


def render_fused_round_counts_reference(scene, camera, height, width, spp, max_bounces, seed,
                                        sample_offset=0, jitter=False, row_start=0,
                                        rows=None, tile=None) -> dict:
    """Plain twin of ``render_fused_round_counts``, on the scene's device:
    the twin's rounds of every (sample, pixel), grouped by warp under both
    schedules (``render_kernel.round_groupings``), a warp the footprint of
    the point ``fused_tile`` gives ``tile``."""
    n_rows = height if rows is None else rows
    t = fused_tile(scene, n_rows, width, max_bounces, FUSED_TILE if tile is None else tile)
    per_sample = []
    render_fused_reference(scene, camera, height, width, spp, max_bounces, seed,
                           sample_offset=sample_offset, jitter=jitter,
                           on_sample=per_sample.append, row_start=row_start, rows=rows)
    return _rk.round_groupings(torch.stack(per_sample), t.footprint)


def render_fused_variant(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    variant: str,
    sample_offset: int = 0,
    jitter: bool = False,
    row_start: int = 0,
    rows: int | None = None,
):
    """``(image, jac)`` of a measurement instantiation of B2 (``VARIANTS``),
    of a row block as ``render_fused`` takes it,
    on CUDA tensors only: what the decomposition of B2's time
    (``utils/sol_decompose.fused_decompose``) times beside the kernel. No
    user path runs it. The image and, but for ``sink`` (whose planes hold
    one sum a pixel), the planes equal ``render_fused``'s.
    ``registers`` takes ``max_bounces <= 3``. Counts its launches in
    ``launch.render_fused.variant``."""
    with span("pt.check.render_fused"):
        rows = _rk._check_inputs(scene, camera, height, width, spp, max_bounces, seed,
                                 sample_offset, row_start, rows)
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; one of {', '.join(VARIANTS)}")
        cap = REGISTER_ROUNDS - 1 if variant == "registers" else MAX_BOUNCES
        if max_bounces > cap:
            raise ValueError(f"max_bounces {max_bounces} is above variant {variant}'s cap "
                             f"of {cap}")
    img, jac, _ = _launch(scene, camera, height, width, spp, max_bounces, seed, sample_offset,
                          jitter, False, variant=variant, row_start=row_start, rows=rows)
    return img, jac


# -- the plain twin --------------------------------------------------------


def render_fused_reference(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    sample_offset: int = 0,
    jitter: bool = False,
    count_rounds: bool = False,
    on_sample=None,
    row_start: int = 0,
    rows: int | None = None,
):
    """Plain PyTorch twin of the fused kernel, on the scene's device: the
    forward rounds of ``render_kernel_reference`` with per-bounce stores,
    then the sweep, in the kernel's order of additions (samples ascending;
    per sample ``P_end`` first, then bounces descending), so that on one
    device the two round alike. Every round runs for every pixel; a dead
    path's rounds are masked out, which adds the exact zeros the kernel
    skips. The material planes are updated with one ``scatter_add_`` per
    swept bounce, one index per pixel and plane, so it is deterministic.
    ``on_sample``, where given, receives each sample's (H, W) int64 rounds
    of every pixel (those its path begins alive), in sample order. Over the
    row block of ``render_fused``: (rows, W) planes and rounds."""
    rows = _rk._check_inputs(scene, camera, height, width, spp, max_bounces, seed,
                             sample_offset, row_start, rows)
    if max_bounces > MAX_BOUNCES:
        raise ValueError(f"max_bounces {max_bounces} is above the fused kernel's "
                         f"cap of {MAX_BOUNCES}")
    device = scene.device
    sph, sph_m, tri, tri_m, mat_tab = _rk._scene_operands(scene)
    par = _rk._camera_params(camera, scene, height, width)
    sky = (par[2], par[3], par[4])
    n = rows * width
    n_mat = mat_tab.shape[0]
    pix, prow, cols = _rk._pixel_grid(height, width, row_start, rows, device)
    fw, fh = (torch.tensor(float(v), device=device) for v in (width, height))
    pd = _rk._camera_dir(par, cols + 0.5, prow + 0.5, fw, fh)
    origin = tuple(par[i].expand(n) for i in (5, 6, 7))
    zero = torch.zeros(n, dtype=torch.float32, device=device)
    one = torch.ones(n, dtype=torch.float32, device=device)
    plane = torch.arange(_MAT_J_PLANES, device=device)[:, None]  # (9, 1)

    acc = (zero, zero, zero)
    jac = torch.zeros((_MAT_J_PLANES * n_mat + 3, n), dtype=torch.float32, device=device)
    k_sky = [zero, zero, zero]
    rounds = torch.zeros((), dtype=torch.int64, device=device)
    for s in range(spp):
        st = _rng.seed_state(pix, s + sample_offset, seed)
        d = pd
        if jitter:
            st, jx = _rng.uniform(st)
            st, jy = _rng.uniform(st)
            d = _rk._camera_dir(par, cols + jx, prow + jy, fw, fh)
        o, thr, rad = origin, (one, one, one), (zero, zero, zero)
        alive = torch.ones(n, dtype=torch.bool, device=device)
        pixel_rounds = torch.zeros(n, dtype=torch.int64, device=device)
        stores = []
        for _ in range(max_bounces + 1):
            if count_rounds:
                rounds = rounds + alive.sum()
            if on_sample is not None:
                pixel_rounds = pixel_rounds + alive
            hit = _rk._closest_hit(sph, sph_m, tri, tri_m, o, d)
            mats = _rk._fetch_materials(mat_tab, hit[2])
            before = thr
            o, d, thr, rad, st, (hitmask, refracted, died) = _rk._shade(
                hit, mats, o, d, thr, rad, st, sky)
            hit_ev = alive & hitmask
            died_ev = hit_ev & died
            stores.append((before, hit[2], mats[:6], mats[7], hit_ev,
                           alive & ~hitmask, died_ev, refracted))
            # Structural death only: a miss, or total internal reflection.
            alive = hit_ev & ~died
        if on_sample is not None:
            on_sample(pixel_rounds.reshape(rows, width))
        acc = tuple(a + (r + t * k) for a, r, t, k in zip(acc, rad, thr, sky))
        k_sky = [k + t for k, t in zip(k_sky, thr)]  # P_end

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
            base = _MAT_J_PLANES * torch.where(valid, m, 0).long()
            jac.scatter_add_(0, base[None, :] + plane, torch.stack(c_a + c_s + c_r))
            carry = tuple(
                torch.where(hit_ev, em + alb * t, torch.where(miss_ev, k, c))
                for em, alb, t, k, c in zip(
                    (em_r, em_g, em_b), (alb_r, alb_g, alb_b), held, sky, carry)
            )
    jac[_MAT_J_PLANES * n_mat:] = torch.stack(k_sky)
    inv = _f32(1.0 / spp)
    img = torch.stack([a * inv for a in acc], dim=-1).reshape(rows, width, 3)
    jac = jac.reshape(-1, rows, width)
    return (img, jac, int(rounds)) if count_rounds else (img, jac)


# -- the backward pass -----------------------------------------------------


def _contract(jac, g, spp, albedo, emission_color, emission_strength):
    """The five cotangents from the Jacobian planes and the image
    cotangent ``g`` (H, W, 3): one matrix-vector product per colour over
    the material planes, taken on strided views (no copy of ``jac``)."""
    n_mat = albedo.shape[0]
    hw = jac.shape[1] * jac.shape[2]
    g_cp = g.to(torch.float32).permute(2, 0, 1).reshape(3, hw).contiguous()
    jm = jac[: _MAT_J_PLANES * n_mat].reshape(n_mat * 3, 3, hw)  # (m kind, c, hw)
    gq = torch.stack([jm[:, c] @ g_cp[c] for c in range(3)], dim=-1)
    gq = gq.reshape(n_mat, 3, 3) / spp  # (m, kind {A, S, R}, c)
    d_alb = gq[:, 0]
    d_eco = gq[:, 1] * emission_strength[:, None]
    d_est = torch.sum(gq[:, 1] * emission_color, dim=1)
    d_trn = torch.sum(gq[:, 2] * albedo, dim=1)
    d_sky = torch.sum(jac[_MAT_J_PLANES * n_mat:].reshape(3, hw) * g_cp, dim=1) / spp
    return d_alb, d_eco, d_est, d_trn, d_sky


def replace_leaves(scene: Scene, leaves) -> Scene:
    """``scene`` with the ``(table or None, field, tensor)`` leaves set."""
    tables, top = {}, {}
    for table, name, t in leaves:
        (tables.setdefault(table, {}) if table else top)[name] = t
    for table, fields in tables.items():
        top[table] = dataclasses.replace(getattr(scene, table), **fields)
    return dataclasses.replace(scene, **top)


def zeros_like_scene(scene: Scene) -> Scene:
    """A ``Scene`` of zeros (False for masks) in the shape of ``scene``."""
    zeros = lambda table: dataclasses.replace(table, **{
        f.name: torch.zeros_like(getattr(table, f.name)) for f in dataclasses.fields(table)})
    return Scene(zeros(scene.materials), zeros(scene.spheres), zeros(scene.triangles),
                 torch.zeros_like(scene.sky_color))


def _with_leaves(scene: Scene, leaves) -> Scene:
    """``scene`` with its five gradient-carrying leaves replaced."""
    return replace_leaves(scene, [(tb, nm, t) for (tb, nm), t in zip(_GRAD_LEAVES, leaves)])


def _grad_leaves(scene: Scene):
    return tuple(getattr(getattr(scene, table) if table else scene, name)
                 for table, name in _GRAD_LEAVES)


def contract_jacobian(scene: Scene, jac, g, spp: int) -> Scene:
    """The scene's cotangent, as a ``Scene`` of tensors, from the fused
    kernel's Jacobian and the image cotangent ``g`` (H, W, 3). This is the
    whole backward pass:

        d_albedo[m, c]       = sum_p g[p, c] A[m, c, p] / spp
        d_emission_color     = emission_strength[m] sum_p g S / spp
        d_emission_strength  = sum_c emission_color[m, c] sum_p g S / spp
        d_transparency[m]    = sum_c albedo[m, c] sum_p g R / spp
        d_sky[c]             = sum_p g[p, c] K[c, p] / spp

    Every other leaf's cotangent is zero by contract (module docstring).
    """
    mats = scene.materials
    with span("pt.contract.render_fused"):
        five = _contract(jac, g, spp, mats.albedo, mats.emission_color, mats.emission_strength)
        return _with_leaves(zeros_like_scene(scene), five)


class _RenderFused(torch.autograd.Function):
    """Forward: ``render_fused``; backward: ``_contract``. ``Function.apply``
    does not look into a dataclass, so the five leaves with a gradient come
    as tensor arguments and the scene and camera beside them."""

    @staticmethod
    def forward(ctx, albedo, emission_color, emission_strength, transparency,
                sky_color, scene, camera, height, width, spp, max_bounces, seed,
                sample_offset, jitter, row_start, rows, tile):
        with span("pt.check.render_fused"):
            leaves = (albedo, emission_color, emission_strength, transparency, sky_color)
            scene = _with_leaves(scene, leaves)
        img, jac = render_fused(
            scene, camera, height, width, spp, max_bounces, seed, sample_offset=sample_offset,
            jitter=jitter, row_start=row_start, rows=rows, tile=tile)
        ctx.save_for_backward(jac, albedo, emission_color, emission_strength)
        ctx.spp = spp
        return img

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        with span("pt.contract.render_fused"):
            jac, albedo, emission_color, emission_strength = ctx.saved_tensors
            return (*_contract(jac, g, ctx.spp, albedo, emission_color, emission_strength),
                    *(None,) * 12)


def render_kernel_vjp(
    scene: Scene,
    camera: Camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    sample_offset: int = 0,
    jitter: bool = False,
    row_start: int = 0,
    rows: int | None = None,
    tile=None,
) -> torch.Tensor:
    """Differentiable fast render: the image (rows, W, 3) of
    ``render_kernel`` (a row block where ``row_start`` and ``rows`` say so),
    with a backward pass for ``albedo``, ``emission_color``,
    ``emission_strength``, ``transparency`` and ``sky_color``.

    Under autograd the forward is the fused kernel and the backward its
    Jacobian's contraction, so no ray is traced twice. The forward and the
    backward see the same RNG streams: the result is the exact gradient of
    this estimator. Roughness, metallicity, refractive index, the sphere
    and triangle leaves and the camera get no gradient (their ``.grad``
    stays ``None``): their cotangents are zero by contract.

    Memory: the Jacobian, ``(9 * M + 3) * H * W * 4`` bytes (579 MB at
    1024 x 1024 with 15 materials), is held from forward to backward.

    With no leaf requiring a gradient this is ``render_kernel``. ``tile``:
    the launch shape of the kernel it runs (``render_kernel.TILES``; by
    default ``BWD_TILE``, or ``render_kernel``'s own without a gradient).
    """
    leaves = _grad_leaves(scene)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in leaves)):
        return _rk.render_kernel(
            scene, camera, height, width, spp, max_bounces, seed,
            sample_offset=sample_offset, jitter=jitter, row_start=row_start, rows=rows,
            tile=tile)
    return _RenderFused.apply(
        *leaves, scene, camera, height, width, spp, max_bounces, seed,
        sample_offset, jitter, row_start, rows, BWD_TILE if tile is None else tile)
