"""The physical tier's forward kernel: hand-written CUDA, and its plain
PyTorch twin.

``render_physical_kernel`` renders the estimator of ``models/physical.py``
(importance-sampled BRDF, next-event estimation). On CUDA tensors it
launches ``csrc/render_phys.cu``, which replaces the Pallas TPU kernel
``_phys_kernel`` of ``path_tracer_c_tpu/ops/pallas_physical.py``; on CPU
tensors it runs ``render_physical_kernel_reference``, the plain PyTorch
transcription of the same math, which the tests hold against the JAX
package.

Per bounce: one closest hit that also says whether a sphere won, 7 draws,
refract / mirror / cosine-weighted diffuse, one emitter sample (a sphere by
its cone of directions; with ``tri_nee`` also a triangle by area) and one
distance-only shadow query. The arithmetic's shape is the TPU kernel's:
the half-b sphere quadratic in both scene scans, the full-b quadratic for
the distance to the sampled emitter (the visibility test compares the two
and sits on a knife edge at the cone's rim), termination as zero
throughput. The twin works on (H*W,) planes and reuses the reference
tier's per-object tests (``ops/render_kernel.py``).

The emitter tables are built from the scene on its device, without a host
sync: the kernel reads the emitter counts from device memory.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import render_kernel as _rk
from . import rng as _rng
from .camera import Camera
from .render_kernel import _ptr
from .rng import _f32, sqrt_rn
from ..scene.scene import Scene
from ..utils.tracing import count, span, wait

__all__ = [
    "render_physical_kernel", "render_physical_kernel_reference",
    "render_physical_kernel_variant", "packed_launcher", "render_physical_kernel_round_counts",
    "render_physical_kernel_round_counts_reference", "live_emitter_mask", "live_emitter_count",
    "live_tri_emitter_mask", "live_tri_emitter_count",
    "SOURCE", "REPLACES", "EVENTS", "WARP_EVENTS",
]

SOURCE = "path_tracer_c_tpu_torch/csrc/render_phys.cu"
REPLACES = "path_tracer_c_tpu/ops/pallas_physical.py:772"

# What ``count_events`` counts, in the order of the kernel's counter: bounce
# rounds run, diffuse vertices among them, light samples computed (diffuse
# vertices with NEE on and a non-empty pool), shadow scans run (light
# samples that face the surface and the emitter).
EVENTS = ("rounds", "diffuse_vertices", "light_samples", "shadow_scans")
# What the counting instantiation counts after EVENTS, under the schedule it
# runs (``render_kernel.VARIANTS``): the rounds the warps run times their
# lanes in the image (warp lane-rounds), and of them the rounds in which some
# lane of the warp computed a light sample, and ran a shadow scan. The keys of
# the regenerating schedule end in ``_regen``.
WARP_EVENTS = ("warp_lane_rounds", "light_warp_lane_rounds", "shadow_warp_lane_rounds")

_INF = float("inf")
_INV_PI = _f32(1.0 / math.pi)
_TWO_PI = _f32(2.0 * math.pi)
_SIN2_CAP = _f32(1.0 - 1e-7)
_VIS_SCALE = _f32(1.0 - 1e-3)
_VIS_SLACK = _f32(1e-4)
_D2_FLOOR = _f32(1e-12)
_PDF_FLOOR = _f32(1e-8)
_DET_FLOOR = _f32(1e-30)
_COS_L_MIN = _f32(1e-6)
_AREA_FLOOR = _f32(1e-20)


# -- emitter tables ----------------------------------------------------------


def _emitter_mask(mats, table):
    return table.active & (mats.emission_strength[table.material.long()] > 0.0)


def live_emitter_mask(scene: Scene) -> np.ndarray:
    """Per-sphere mask of the emitter pool (active and emission strength
    > 0), on the host."""
    return _emitter_mask(scene.materials, scene.spheres).cpu().numpy()


def live_emitter_count(scene: Scene) -> int:
    return int(live_emitter_mask(scene).sum())


def live_tri_emitter_mask(scene: Scene) -> np.ndarray:
    """Per-triangle mask of the ``tri_nee`` emitter pool, on the host."""
    return _emitter_mask(scene.materials, scene.triangles).cpu().numpy()


def live_tri_emitter_count(scene: Scene) -> int:
    return int(live_tri_emitter_mask(scene).sum())


def _radiance(mats, table):
    m = table.material.long()
    return mats.emission_color[m] * mats.emission_strength[m][:, None]


def _emitter_operands(scene: Scene):
    """Emissive-sphere table: the cumulative emitter count (S,) int32, the
    premultiplied radiance of every sphere (S, 3) float32, and the number
    of emitters, a scalar tensor."""
    mask = _emitter_mask(scene.materials, scene.spheres).to(torch.int32)
    cum = torch.cumsum(mask, 0).to(torch.int32)
    return cum, _radiance(scene.materials, scene.spheres), mask.sum().to(torch.int32)


def _tri_emitter_operands(scene: Scene):
    """Emissive-triangle table for ``tri_nee``: cumulative count (T,)
    int32, premultiplied radiance (T, 3), area (T,), emitter count."""
    tri = scene.triangles
    mask = _emitter_mask(scene.materials, tri).to(torch.int32)
    cum = torch.cumsum(mask, 0).to(torch.int32)
    cr = torch.linalg.cross(tri.v1 - tri.v0, tri.v2 - tri.v0)
    area = 0.5 * sqrt_rn(torch.clamp_min(torch.sum(cr * cr, -1), _AREA_FLOOR))
    return cum, _radiance(scene.materials, tri), area, mask.sum().to(torch.int32)


def _pick_list(cum):
    """Row of the k-th emitter, for k = 0 .. rows-1, (rows,) int32: the
    number of rows whose cumulative count is <= k, clipped to the last
    row. It is the TPU kernel's count over the table, done once per table
    in place of once per bounce; the kernel reads entry k. Entries from
    the emitter count on hold the last row, which is what the count gives
    when there is no k-th emitter."""
    rows = cum.shape[0]
    k1 = torch.arange(1, rows + 1, dtype=cum.dtype, device=cum.device)
    return torch.searchsorted(cum, k1, right=False).clamp(max=rows - 1).to(torch.int32)


def _phys_operands(scene: Scene, operands):
    """The kernel's operands beyond the reference tier's tables
    (``operands``, of ``_scene_operands``): emitter pick lists and radiances
    for spheres and triangles, triangle areas, the raw emission strength of
    every material, and ``(n_em, n_em_t)`` as an int32 pair on the device;
    for the twins also the tables' material indices. An empty object table
    becomes one row that is no emitter, as in ``_scene_operands``."""
    dev = scene.device
    em_cum, le_sph, n_em = _emitter_operands(scene)
    tri_cum, le_tri, tri_area, n_em_t = _tri_emitter_operands(scene)
    if em_cum.shape[0] == 0:
        em_cum, le_sph = em_cum.new_zeros(1), le_sph.new_zeros(1, 3)
    if tri_cum.shape[0] == 0:
        tri_cum, le_tri, tri_area = tri_cum.new_zeros(1), le_tri.new_zeros(1, 3), tri_area.new_zeros(1)
    return dict(
        em_list=_pick_list(em_cum), le_sph=le_sph.contiguous(),
        tri_list=_pick_list(tri_cum), le_tri=le_tri.contiguous(),
        tri_area=tri_area.contiguous(),
        mat_est=scene.materials.emission_strength.contiguous(),
        sph_m=operands[1], tri_m=operands[3],
        counts=torch.stack([n_em, n_em_t]).to(device=dev, dtype=torch.int32),
    )


def _all_operands(scene: Scene):
    """B3's operands: the reference tier's tables (``_scene_operands``) and
    ``_phys_operands`` of them."""
    operands = _rk._scene_operands(scene)
    return operands, _phys_operands(scene, operands)


# -- the wrapper ---------------------------------------------------------------


def render_physical_kernel(
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
    count_rounds: bool = False,
    tri_nee: bool = False,
    count_events: bool = False,
    row_start: int = 0,
    rows: int | None = None,
    tile=None,
):
    """Physical-tier radiance image (rows, W, 3) float32, on the scene's
    device: the estimator of ``models.physical.render_physical`` on the
    same RNG streams, over the block of ``rows`` rows (default: all) from
    ``row_start``, as ``render_kernel.render_kernel`` takes it.

    CUDA tensors go to the hand kernel, built on first use (``ops.build``);
    the counter ``launch.render_phys`` (``utils/tracing.py``) counts its
    launches. CPU tensors go to ``render_physical_kernel_reference``. Any
    other device raises.

    ``count_rounds=True`` returns ``(image, executed_rounds)``: the bounce
    rounds that ran, summed over threads (one per pixel) and samples, as a
    Python int. A thread stops at a miss or at zero throughput. The JAX
    package counts whole tile rounds, so the two counts are not
    comparable. ``count_events=True`` returns ``(image, counts)`` with one
    count per name in ``EVENTS``: what this render's data made the threads
    do. Counting is a second instantiation of the kernel and waits for the
    device; timed renders leave it off. ``tile``: the launch shape, as
    ``render_kernel.render_kernel`` takes it (``fit_tile("phys", ...)``).
    """
    with span("pt.check.render_phys"):
        rows = _rk._check_inputs(scene, camera, height, width, spp, max_bounces, seed,
                                 sample_offset, row_start, rows)
        t = _rk.fit_tile("phys", scene, rows, width, max_bounces, tile)
    device = scene.device
    if device.type == "cpu":
        return render_physical_kernel_reference(
            scene, camera, height, width, spp, max_bounces, seed,
            sample_offset=sample_offset, jitter=jitter, nee=nee,
            count_rounds=count_rounds, tri_nee=tri_nee, count_events=count_events,
            row_start=row_start, rows=rows,
        )
    out, counter = _launch(scene, camera, height, width, spp, max_bounces, seed, sample_offset,
                           jitter, nee, tri_nee, count_rounds or count_events,
                           row_start=row_start, rows=rows, tile=t)
    if not (count_rounds or count_events):
        return out
    with wait("count_events" if count_events else "count_rounds"):
        return _with_counts(out, counter, count_rounds, count_events)


def _launch(scene, camera, height, width, spp, max_bounces, seed, sample_offset, jitter, nee,
            tri_nee, count_on, variant=None, row_start=0, rows=None, tile=None):
    """Launch B3 on the scene's CUDA device over the block of ``rows`` rows
    (None: all) from ``row_start``: the timed kernel at point ``tile``
    (None: the default), or with
    ``variant`` an instantiation of ``render_kernel.VARIANTS``; with
    ``count_on``, its counting instantiation, whose counters (``EVENTS``, then
    ``WARP_EVENTS`` of its schedule) come back beside the image. The
    operands are ``render_kernel._pack``'s (``_all_operands``), reused while
    the scene and the camera are unchanged."""
    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"render_physical_kernel runs on CUDA or CPU tensors, not {device}")
    t, lib, (operands, ph), par = _rk._pack("phys", tile, scene, camera, height, width,
                                            _all_operands,
                                            torch.cuda.current_stream(device).cuda_stream)
    with span("pt.launch.render_phys"):
        rows = height if rows is None else rows
        out = torch.empty((rows, width, 3), dtype=torch.float32, device=device)
        counter = None
        if count_on:
            counter = torch.zeros(len(EVENTS) + len(WARP_EVENTS), dtype=torch.int64,
                                  device=device)
        args = (*_rk._table_args(operands), *_emitter_args(ph), _ptr(par), _ptr(out),
                _ptr(counter), int(bool(nee)), int(bool(tri_nee)),
                *_rk._run_args(height, width, spp, max_bounces, seed, sample_offset, jitter,
                               device, row_start, rows))
        if variant is None:
            err, name = _rk._entry("render_phys", t)(*args), f"render_phys at {t.name}"
        else:
            err = lib.render_phys_variant(_rk.VARIANTS[variant], *args)
            name = f"render_phys {variant}"
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
        count("launch.render_phys" if variant is None else "launch.render_phys.variant")
    return out, counter


def render_physical_kernel_variant(
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
    tri_nee: bool = False,
    row_start: int = 0,
    rows: int | None = None,
):
    """The image of an instantiation of B3 (``render_kernel.VARIANTS``), on
    CUDA tensors only: what the decomposition of B3's time
    (``utils/sol_decompose.sol_decompose``) times beside the kernel. No
    user path runs it; its image equals ``render_physical_kernel``'s, row
    blocks included. One that stages its tables raises where they exceed
    the shared budget. Counts its launches in
    ``launch.render_phys.variant``."""
    with span("pt.check.render_phys"):
        rows = _rk._check_inputs(scene, camera, height, width, spp, max_bounces, seed,
                                 sample_offset, row_start, rows)
        _rk._check_variant(scene, variant, physical=True)
        _rk._cuda_only(scene, "render_physical_kernel_variant")
    return _launch(scene, camera, height, width, spp, max_bounces, seed, sample_offset, jitter,
                   nee, tri_nee, False, variant, row_start, rows)[0]


def packed_launcher(scene: Scene, camera: Camera, height: int, width: int, spp: int,
                    max_bounces: int, variant: str | None = None, jitter: bool = True,
                    nee: bool = True, tri_nee: bool = False, tile=None):
    """B3 at point ``tile`` (``render_kernel.fit_tile``), or its
    instantiation ``variant`` (built at the default point: it takes no
    ``tile``), on operands packed once, on CUDA tensors only:
    ``launch(seed)`` runs it into one image, which it returns (the same
    tensor each call), without the checks, the cache's lookups and the
    allocation that ``render_physical_kernel`` makes on every call. What the
    measurement scripts time as the kernel alone; no user path runs it, and
    its launches count nowhere. Each launch is a ``pt.launch.render_phys``
    span."""
    _rk._variant_or_tile(variant, tile)
    t = _rk.fit_tile("phys", scene, height, width, max_bounces, tile)
    _rk._cuda_only(scene, "packed_launcher")
    if variant is not None:
        _rk._check_variant(scene, variant, physical=True)
    from .build import load_library

    lib = load_library()
    device = scene.device
    operands = _rk._scene_operands(scene)
    ph = _phys_operands(scene, operands)
    par = _rk._camera_params(camera, scene, height, width)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    head = (*_rk._table_args(operands), *_emitter_args(ph), _ptr(par), _ptr(out), None,
            int(bool(nee)), int(bool(tri_nee)))
    if variant is None:
        entry, name = _rk._entry("render_phys", t), f"render_phys at {t.name}"
    else:
        entry, name = lib.render_phys_variant, f"render_phys {variant}"
        head = (_rk.VARIANTS[variant], *head)

    def launch(seed):
        with span("pt.launch.render_phys"):
            err = entry(*head, *_rk._run_args(height, width, spp, max_bounces, seed, 0, jitter,
                                              device))
            if err != 0:
                raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
        return out

    launch.keep = (operands, ph, par)  # the pointers' tensors, kept alive
    return launch


def render_physical_kernel_round_counts(
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
    variant: str | None = None,
    row_start: int = 0,
    rows: int | None = None,
    tile=None,
) -> dict:
    """The rounds and branch events B3 runs for one render:
    ``thread_rounds``, ``light_samples`` and ``shadow_scans`` (as
    ``count_events``), and ``WARP_EVENTS`` of a schedule: the rounds its
    warps run times their lanes in the image, and those in which the light
    sample and the shadow scan run for some lane of the warp (the others
    wait). Without a ``_regen`` suffix, the warp runs each sample for as many
    rounds as its longest lane; with it, it regenerates paths. CUDA tensors
    run the counting instantiation of the timed kernel (a launch: it counts
    in ``launch.render_phys``), or of ``variant`` (in
    ``launch.render_phys.variant``), which give the keys of
    their own schedule; CPU tensors the plain twin, which gives both
    (``render_physical_kernel_round_counts_reference``). ``row_start`` and
    ``rows``: a row block, as in ``render_physical_kernel``; the blocks'
    counts sum to the whole image's. A warp is the footprint of the
    launch's point ``tile`` (``render_kernel.fit_tile``)."""
    with span("pt.check.render_phys"):
        _rk._variant_or_tile(variant, tile)
        rows = _rk._check_inputs(scene, camera, height, width, spp, max_bounces, seed,
                                 sample_offset, row_start, rows)
        t = _rk.fit_tile("phys", scene, rows, width, max_bounces, tile)
        if variant is not None and scene.device.type != "cpu":
            _rk._check_variant(scene, variant, physical=True)
    kw = dict(sample_offset=sample_offset, jitter=jitter, nee=nee, tri_nee=tri_nee,
              row_start=row_start, rows=rows)
    if scene.device.type == "cpu":
        return render_physical_kernel_round_counts_reference(
            scene, camera, height, width, spp, max_bounces, seed, **kw, tile=t)
    _, counter = _launch(scene, camera, height, width, spp, max_bounces, seed, sample_offset,
                         jitter, nee, tri_nee, True, variant, row_start, rows, tile=t)
    with wait("count_events"):
        c = counter.tolist()
    suffix = _rk._warp_key(variant)[len("warp_lane_rounds"):]
    return {"thread_rounds": c[0], "light_samples": c[2], "shadow_scans": c[3],
            **{k + suffix: v for k, v in zip(WARP_EVENTS, c[len(EVENTS):])}}


def render_physical_kernel_round_counts_reference(scene, camera, height, width, spp,
                                                  max_bounces, seed, sample_offset=0,
                                                  jitter=True, nee=True,
                                                  tri_nee=False, row_start=0,
                                                  rows=None, tile=None) -> dict:
    """Plain twin of ``render_physical_kernel_round_counts``, on the scene's
    device: the twin's rounds and branch events of every (sample, round,
    pixel) of the row block, grouped by warp under both schedules
    (``WarpGroupings``), a warp the footprint of ``tile``'s point."""
    rows = _rk._check_inputs(scene, camera, height, width, spp, max_bounces, seed,
                             sample_offset, row_start, rows)
    t = _rk.fit_tile("phys", scene, rows, width, max_bounces, tile)
    groups = WarpGroupings(rows, width, spp, max_bounces, scene.device, t.footprint)
    render_physical_kernel_reference(scene, camera, height, width, spp, max_bounces, seed,
                                     sample_offset=sample_offset, jitter=jitter, nee=nee,
                                     tri_nee=tri_nee, on_round=groups.add_round,
                                     row_start=row_start, rows=rows)
    return groups.counts()


class WarpGroupings:
    """Warp lane-rounds of the twin's rounds and of its branch events (a
    light sample computed, a shadow scan run), fed one round of every pixel
    at a time (``add_round``; samples ascending, rounds ascending). A warp is
    a ``footprint`` of pixels (``render_kernel.warp_map``; by default 32
    consecutive columns of one row from a multiple of 32). Per sample, a
    warp runs round b of sample s, and the branch in it, if some lane of the
    warp does; under path regeneration a lane's rounds follow one another
    across its samples, so its k-th round overall runs in the warp's k-th
    iteration, and the warp runs an iteration, and the branch in it, if some
    lane does. Each counts the warp's lanes in the image."""

    _KEYS = dict(zip(("rounds", "light", "shadow"), WARP_EVENTS))

    def __init__(self, height, width, spp, max_bounces, device, footprint=(1, 32)):
        self.warp, self.n_warps, self.lanes = _rk.warp_map(height, width, footprint, device)
        self.bounces = max_bounces + 1
        # Per warp, the iterations in which some lane ran a round or event.
        self.iters = {k: torch.zeros((self.n_warps, spp * self.bounces), dtype=torch.bool,
                                     device=device) for k in self._KEYS}
        self.per_sample = dict.fromkeys(self._KEYS, 0)
        self.thread = {"rounds": 0, "light": 0, "shadow": 0}
        self.done = torch.zeros(height * width, dtype=torch.int64, device=device)
        self.sample_rounds = torch.zeros_like(self.done)
        self.b = 0

    def add_round(self, running, light, shadow):
        """Round ``b`` of the current sample: (H*W,) masks of the pixels that
        ran it, computed a light sample in it, ran a shadow scan in it."""
        it = self.done + self.b
        for key, m in (("rounds", running), ("light", light), ("shadow", shadow)):
            w = self.warp[m]
            some = torch.zeros(self.n_warps, dtype=torch.bool, device=m.device)
            some[w] = True
            self.per_sample[key] += int((some * self.lanes).sum())
            self.iters[key][w, it[m]] = True
            self.thread[key] += int(m.sum())
        self.sample_rounds += running
        self.b += 1
        if self.b == self.bounces:
            self.done += self.sample_rounds
            self.sample_rounds.zero_()
            self.b = 0

    def counts(self) -> dict:
        out = {"thread_rounds": self.thread["rounds"], "light_samples": self.thread["light"],
               "shadow_scans": self.thread["shadow"]}
        for k, name in self._KEYS.items():
            out[name] = self.per_sample[k]
            out[name + "_regen"] = int((self.iters[k].sum(1) * self.lanes).sum())
        return out


def _emitter_args(ph):
    """The emitter tables of ``_phys_operands`` as the physical kernels'
    arguments after the scene tables."""
    return tuple(_ptr(ph[k]) for k in (
        "em_list", "le_sph", "tri_list", "le_tri", "tri_area", "mat_est", "counts"))


def _with_counts(img, counter, count_rounds, count_events):
    if count_events:
        return img, dict(zip(EVENTS, counter.tolist()))
    return (img, int(counter[0])) if count_rounds else img


# -- the plain twin ------------------------------------------------------------


def _onb(nx, ny, nz):
    """Branchless orthonormal basis around a unit vector (Duff et al.
    2017), plane-wise."""
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    return (1.0 + sign * nx * nx * a, sign * b, -sign * nx), (b, sign + ny * ny * a, -ny)


def _emitter_distance(so, om, c, r):
    """Distance along the shadow ray ``so + t om`` to the sampled sphere:
    the full-b quadratic of ``ops.intersect.ray_sphere_t``, operation for
    operation."""
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


def _nee(tabs, ph, n, so, thr, alb, hitm, choose_diff, u_pick, v1, v2, tri_nee):
    """The light sample of one bounce: the radiance it adds per channel
    (zero where it is not valid), the mask of samples that face the
    surface and the emitter, for which the kernel runs its shadow scan, and
    what the gradient twins (``ops/render_physical_grad.py``) read of the
    sample: ``valid``, the weight ``w``, the emitter's radiance ``le`` and
    material ``emat``, its sphere row ``e_idx`` and ordinal ``kk``, the
    cone's azimuth ``(cp, sp)`` and the pool size ``pool_f``; with
    ``tri_nee`` also ``is_tri``, the triangle's row ``t_idx`` and ordinal
    ``kt``. ``n`` is the surface normal, ``so`` the shadow ray's origin,
    ``thr`` the throughput before the albedo."""
    sph, tri = tabs
    nx, ny, nz = n
    sox, soy, soz = so
    n_em, n_em_t = ph["counts"][0], ph["counts"][1]
    pool = n_em + n_em_t if tri_nee else n_em
    pool_f = pool.to(torch.float32)
    kf = torch.floor(u_pick * pool_f).to(torch.int32)
    kk = torch.minimum(torch.clamp_min(kf, 0), torch.clamp_min(pool - 1, 0))
    n_sph = sph.shape[0]
    e_idx = torch.where(kk < n_sph, ph["em_list"][kk.clamp(max=n_sph - 1).long()], n_sph - 1).long()
    cex, cey, cez, rer = sph[e_idx, 0], sph[e_idx, 1], sph[e_idx, 2], sph[e_idx, 3]
    le = ph["le_sph"][e_idx].unbind(1)
    emat = ph["sph_m"][e_idx]
    info = dict(e_idx=e_idx, kk=kk, pool_f=pool_f)

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
    info.update(cp=cp, sp=sp)
    (tax, tay, taz), (bax, bay, baz) = _onb(wzx, wzy, wzz)
    cphi = sth * cp
    sphi = sth * sp
    omx = cphi * tax + sphi * bax + cth * wzx
    omy = cphi * tay + sphi * bay + cth * wzy
    omz = cphi * taz + sphi * baz + cth * wzz
    pdf_omega = 1.0 / torch.clamp_min(_TWO_PI * (1.0 - cosmax), _PDF_FLOOR)
    cos_surf = nx * omx + ny * omy + nz * omz
    t_e = _emitter_distance(so, (omx, omy, omz), (cex, cey, cez), rer)

    if tri_nee:
        kt = torch.minimum(torch.clamp_min(kk - n_em, 0), torch.clamp_min(n_em_t - 1, 0))
        is_tri = (kk >= n_em) & (n_em_t > 0)
        t_idx = ph["tri_list"][kt.long()].long()
        tv = tri[t_idx]
        su = sqrt_rn(v1)
        b1c = su * (1.0 - v2)
        b2c = su * v2
        b0c = 1.0 - su
        qx = b0c * tv[:, 0] + b1c * tv[:, 3] + b2c * tv[:, 6]
        qy = b0c * tv[:, 1] + b1c * tv[:, 4] + b2c * tv[:, 7]
        qz = b0c * tv[:, 2] + b1c * tv[:, 5] + b2c * tv[:, 8]
        dqx, dqy, dqz = qx - sox, qy - soy, qz - soz
        d2t = dqx * dqx + dqy * dqy + dqz * dqz
        dist_t = sqrt_rn(torch.clamp_min(d2t, _D2_FLOOR))
        otx, oty, otz = dqx / dist_t, dqy / dist_t, dqz / dist_t
        cos_l = torch.abs(tv[:, 9] * otx + tv[:, 10] * oty + tv[:, 11] * otz)
        w_geom_t = ph["tri_area"][t_idx] * cos_l / torch.clamp_min(d2t, _D2_FLOOR)
        omx = torch.where(is_tri, otx, omx)
        omy = torch.where(is_tri, oty, omy)
        omz = torch.where(is_tri, otz, omz)
        cos_surf = torch.where(is_tri, nx * otx + ny * oty + nz * otz, cos_surf)
        t_e = torch.where(is_tri, dist_t, t_e)
        le = tuple(torch.where(is_tri, lt, ls) for lt, ls in zip(ph["le_tri"][t_idx].unbind(1), le))
        emat = torch.where(is_tri, ph["tri_m"][t_idx], emat)
        info.update(is_tri=is_tri, t_idx=t_idx, kt=kt)
        branch_ok = torch.where(is_tri, cos_l > _COS_L_MIN, outside)
        w = torch.where(is_tri, cos_surf * w_geom_t, cos_surf / pdf_omega) * pool_f
    else:
        branch_ok = outside
        w = cos_surf / pdf_omega * pool_f

    s_bt = _rk._closest_t(sph, tri, so, (omx, omy, omz))
    visible = (s_bt < _INF) & (s_bt >= t_e * _VIS_SCALE - _VIS_SLACK) & (t_e < _INF)
    # `pool > 0` switches the term off by a select, never by a multiply.
    faces = (pool > 0) & branch_ok & (cos_surf > 0.0) & (t_e < _INF)
    valid = hitm & choose_diff & faces & visible
    info.update(valid=valid, w=w, le=le, emat=emat)
    return tuple(torch.where(valid, t * a * _INV_PI * l * w, 0.0)
                 for t, a, l in zip(thr, alb, le)), faces, info


def _bounce(tabs, ph, hit, mats, est, o, d, thr, rad, st, prevd, sky, nee, tri_nee):
    """One bounce of every path, dead ones (zero throughput) included: all
    they add is exact zeros. Returns the new origin, direction, throughput,
    radiance, RNG state and diffuse-arrival flag, the round's events
    ``(hit, diffuse lobe chosen, shadow scan wanted)`` as bool masks, and
    for the gradient twins what else the round decided: ``nee_counted``
    (the hit's own emission was skipped), ``refracted``, ``died``, the
    shadow origin ``so``, the emitter draws ``v1`` and ``v2``, and the
    light sample's dict (``_nee``; None with next-event estimation off)."""
    best, (nx, ny, nz), _, sphm = hit
    dx, dy, dz = d
    tr, tg, tb = thr
    ar, ag, ab = rad
    hitm = best < _INF
    # A miss: the sky, and the path ends.
    ar = ar + torch.where(hitm, 0.0, tr * sky[0])
    ag = ag + torch.where(hitm, 0.0, tg * sky[1])
    ab = ab + torch.where(hitm, 0.0, tb * sky[2])
    tr = torch.where(hitm, tr, 0.0)
    tg = torch.where(hitm, tg, 0.0)
    tb = torch.where(hitm, tb, 0.0)

    alb_r, alb_g, alb_b, em_r, em_g, em_b, rgh, trn, ior = mats
    # Le, skipped where a diffuse-sampled ray arrives at an emitter that
    # the previous vertex could have light-sampled.
    nee_counted = torch.zeros_like(hitm)
    if nee:
        n_em, n_em_t = ph["counts"][0], ph["counts"][1]
        nee_counted = prevd & sphm & (est > 0.0) & (n_em > 0)
        if tri_nee:
            nee_counted = nee_counted | (prevd & hitm & ~sphm & (est > 0.0) & (n_em_t > 0))
    ar = ar + torch.where(nee_counted, 0.0, tr * em_r)
    ag = ag + torch.where(nee_counted, 0.0, tg * em_g)
    ab = ab + torch.where(nee_counted, 0.0, tb * em_b)

    st, u_transp = _rng.uniform(st)
    st, u_lobe = _rng.uniform(st)
    st, u1 = _rng.uniform(st)
    st, u2 = _rng.uniform(st)
    st, u_pick = _rng.uniform(st)
    st, v1 = _rng.uniform(st)
    st, v2 = _rng.uniform(st)

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
    coef = eta * ni + sqrt_rn(torch.where(tirm, 1.0, torch.clamp_min(k, _rk._K_FLOOR)))
    txx = torch.where(tirm, 0.0, eta * dx - coef * rnx)
    txy = torch.where(tirm, 0.0, eta * dy - coef * rny)
    txz = torch.where(tirm, 0.0, eta * dz - coef * rnz)
    rfx = dx - 2.0 * ndot * nx
    rfy = dy - 2.0 * ndot * ny
    rfz = dz - 2.0 * ndot * nz
    # Cosine-weighted diffuse direction about the geometric normal.
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
    # TIR on the refracted branch: the path dies and keeps its direction.
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
    offs = _rk._EPS_OFFSET + _rk._EPS_SCALE * sqrt_rn(px * px + py * py + pz * pz)

    faces = torch.zeros_like(hitm)
    so = (px + offs * nx, py + offs * ny, pz + offs * nz)
    light = None
    if nee:
        (nr, ng, nb), faces, light = _nee(
            (tabs[0], tabs[2]), ph, (nx, ny, nz), so, (tr, tg, tb),
            (alb_r, alb_g, alb_b), hitm, choose_diff, u_pick, v1, v2, tri_nee)
        ar, ag, ab = ar + nr, ag + ng, ab + nb

    # cos / pdf cancels for the diffuse lobe; the others tint by albedo.
    tr = tr * alb_r
    tg = tg * alb_g
    tb = tb * alb_b
    side = torch.where(ndx * nx + ndy * ny + ndz * nz >= 0.0, 1.0, -1.0)
    o = (px + offs * side * nx, py + offs * side * ny, pz + offs * side * nz)
    prevd = torch.where(hitm & ~died, choose_diff, prevd)
    info = dict(nee_counted=nee_counted, refracted=choose_refr, died=died, so=so,
                v1=v1, v2=v2, light=light)
    return (o, (ndx, ndy, ndz), (tr, tg, tb), (ar, ag, ab), st, prevd,
            (hitm, choose_diff, faces), info)


def render_physical_kernel_reference(
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
    count_rounds: bool = False,
    tri_nee: bool = False,
    count_events: bool = False,
    on_sample=None,
    on_round=None,
    row_start: int = 0,
    rows: int | None = None,
):
    """Plain PyTorch twin of the hand kernel, on the scene's device: the
    same math on (H*W,) planes, every round run for every path (no early
    exit). With ``count_rounds`` or ``count_events`` it also counts what
    the kernel's threads do: the rounds a path begins with nonzero
    throughput, and the events of ``EVENTS`` in them. ``on_sample``, where
    given, receives each sample's (H, W) int64 rounds of every pixel;
    ``on_round`` each round's (H*W,) bool masks of the pixels whose thread
    runs it, computes a light sample in it and runs a shadow scan in it.
    Over the row block of ``render_physical_kernel``: (rows, W) rounds and
    (rows*W,) masks."""
    rows = _rk._check_inputs(scene, camera, height, width, spp, max_bounces, seed,
                             sample_offset, row_start, rows)
    device = scene.device
    tabs = _rk._scene_operands(scene)
    sph, sph_m, tri, tri_m, mat_tab = tabs
    ph = _phys_operands(scene, tabs)
    par = _rk._camera_params(camera, scene, height, width)
    sky = (par[2], par[3], par[4])
    n = rows * width
    pix, prow, cols = _rk._pixel_grid(height, width, row_start, rows, device)
    fw, fh = (torch.tensor(float(v), device=device) for v in (width, height))
    pd = _rk._camera_dir(par, cols + 0.5, prow + 0.5, fw, fh)
    origin = tuple(par[i].expand(n) for i in (5, 6, 7))
    zero = torch.zeros(n, dtype=torch.float32, device=device)
    one = torch.ones(n, dtype=torch.float32, device=device)
    n_mat = mat_tab.shape[0]

    acc = (zero, zero, zero)
    count = count_rounds or count_events or on_sample is not None or on_round is not None
    counter = torch.zeros(len(EVENTS), dtype=torch.int64, device=device)
    for s in range(spp):
        st = _rng.seed_state(pix, s + sample_offset, seed)
        d = pd
        if jitter:
            st, jx = _rng.uniform(st)
            st, jy = _rng.uniform(st)
            d = _rk._camera_dir(par, cols + jx, prow + jy, fw, fh)
        o, thr, rad = origin, (one, one, one), (zero, zero, zero)
        prevd = torch.zeros(n, dtype=torch.bool, device=device)
        pixel_rounds = torch.zeros(n, dtype=torch.int64, device=device)
        for _ in range(max_bounces + 1):
            running = (thr[0] != 0.0) | (thr[1] != 0.0) | (thr[2] != 0.0)
            hit = _rk._closest_hit(sph, sph_m, tri, tri_m, o, d)
            m = hit[2]
            mats = _rk._fetch_materials(mat_tab, m)
            # Raw emission strength; zero for an index outside the table.
            est = torch.where((m >= 0) & (m < n_mat),
                              ph["mat_est"][m.clamp(0, n_mat - 1).long()], 0.0)
            o, d, thr, rad, st, prevd, (hitm, diffuse, faces), _ = _bounce(
                tabs, ph, hit, mats, est, o, d, thr, rad, st, prevd, sky, nee, tri_nee)
            if count:
                diffuse = running & hitm & diffuse
                pool = ph["counts"][0] + (ph["counts"][1] if tri_nee else 0)
                light = diffuse & (pool > 0) if nee else torch.zeros_like(diffuse)
                counter = counter + torch.stack(
                    [running.sum(), diffuse.sum(), light.sum(), (light & faces).sum()])
                pixel_rounds = pixel_rounds + running
                if on_round is not None:
                    on_round(running, light, light & faces)
        acc = tuple(a + (r + t * k) for a, r, t, k in zip(acc, rad, thr, sky))
        if on_sample is not None:
            on_sample(pixel_rounds.reshape(rows, width))
    inv = _f32(1.0 / spp)
    img = torch.stack([a * inv for a in acc], dim=-1).reshape(rows, width, 3)
    return _with_counts(img, counter, count_rounds, count_events)
