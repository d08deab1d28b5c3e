"""PyTorch port: the fused physical kernel's (B4) planes in slots and its
plane adds, on the CPU.

Where B4's slot instantiations keep the planes whose addresses depend on
the pixel alone (the split the launcher passes them,
``render_physical_grad.chip_plane_split``: the geometry planes of the first
sphere and triangle ordinals and the emission planes of the first emitter
materials, in slots until the pixel's end; ``plane_places`` below lays them
out as the kernel's ``ChipPlanes`` does), every such plane must live in
exactly one place. The twin's counts of plane adds by family
(``COUNTERS``), which the card holds the kernel's counting instantiation
to, are held here to a numpy transcription of the kernel's add sites; and
the twin, which the kernel and every instantiation must equal bit for bit
on the card, is held to the Pallas kernel in interpret mode at caps above
the slots' budget. Small shapes: the file runs in well under a minute.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu.ops import pallas_physical as jpp
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
import torch_physical_scenes as S
from torch_physical_scenes import JCAM, PCAM

torch.set_num_threads(1)


def lights_scene(n_sph, n_tri, shared_material=False):
    """A diffuse ground under ``n_sph`` sphere lights and ``n_tri`` triangle
    lights, each light its own material unless ``shared_material``; and the
    lights' materials in the order of the emitter tables, spheres first."""
    b = P.SceneBuilder(sky_color=(0.02, 0.02, 0.03))
    ground = b.add_material(albedo=(0.5, 0.5, 0.5), roughness=1.0)
    b.add_triangle(v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50), material=ground)
    lamps, shared = [], None
    for i in range(n_sph + n_tri):
        if shared is None or not shared_material:
            shared = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.9, 0.8),
                                    emission_strength=4.0 + i)
        lamps.append(shared)
        if i < n_sph:
            b.add_sphere(center=(-2.0 + i, 2.0, 6.0), radius=0.3, material=shared)
        else:
            x = -2.0 + (i - n_sph)
            b.add_triangle(v0=(x, 3.0, 5.0), v1=(x + 0.5, 3.0, 5.0), v2=(x, 3.0, 5.5),
                           material=shared)
    return b.build("cpu"), lamps


def emitter_materials(scene, tri_nee, e):
    """The materials whose emission planes the kernel's
    ``find_emitter_materials`` puts in slots: the first ``e`` distinct
    emitter materials in ``[0, n_mat)``, in the order of the emitter tables
    (the live sphere emitters, then with ``tri_nee`` the live triangle
    emitters)."""
    tables = [(scene.spheres, rp.live_emitter_mask(scene))]
    if tri_nee:
        tables.append((scene.triangles, rp.live_tri_emitter_mask(scene)))
    out = []
    for table, live in tables:
        for m, on in zip(table.material.tolist(), live.tolist()):
            if on and 0 <= m < scene.num_materials and m not in out:
                out.append(m)
    return out[:e]


def plane_places(scene, n_em_cap, tri_em_cap, tri_nee, rough_grad=False, floats=None,
                 variant="shared_planes"):
    """Where each geometry plane and each emission plane of one launch of
    ``variant`` lives: ``{("jgeo" | "jtri" | "jac", plane index): slot, or
    None for device memory}``, from the split the launcher passes it, the
    slots as ``csrc/render_phys_fused.cu`` ``ChipPlanes`` lays them out
    (sphere ordinal o from 12 o, triangle ordinal o from 12 k + 27 o, the
    i-th emitter material from 12 k + 27 kt + 3 i)."""
    n_mat = scene.num_materials
    k, kt, e = pg._chip_split(scene, n_em_cap, tri_em_cap, variant, floats)
    mp = 12 if rough_grad else 9
    mats = emitter_materials(scene, tri_nee, e)
    where = {}
    for i in range(12 * n_em_cap):
        where["jgeo", i] = i if i < 12 * k else None
    for i in range(27 * tri_em_cap):
        where["jtri", i] = 12 * k + i if i < 27 * kt else None
    for m in range(n_mat):
        for c in range(3):
            where["jac", mp * m + 3 + c] = (12 * k + 27 * kt + 3 * mats.index(m) + c
                                           if m in mats else None)
    return where


SPLIT_SCENES = [(0, 0, False), (1, 0, False), (3, 0, False), (5, 0, False), (2, 2, False),
                (0, 3, False), (4, 2, True)]


@pytest.mark.parametrize("variant", ["shared_planes", "local_planes"])
@pytest.mark.parametrize("n_sph, n_tri, shared", SPLIT_SCENES)
def test_every_plane_lives_in_one_place(variant, n_sph, n_tri, shared):
    """For caps below, at and above the budget and budgets of 0 to 48
    floats, as the launcher splits the planes for ``variant``: every
    geometry and emission plane has one place, the slots are distinct and
    inside the budget, no split exceeds a cap, the emission slots hold the
    first distinct emitter materials of the tables (none in local memory),
    and a budget that holds every plane leaves none in device memory.
    Every other instantiation, the kernel's too, keeps none in slots."""
    scene, lamps = lights_scene(n_sph, n_tri, shared)
    n_mat = scene.num_materials
    local = pg.policy(variant)["planes"] == "local"
    for floats in (0, 11, 12, 16, 27, 32, 39, 48):
        for tri_nee in (False, True):
            pool = list(dict.fromkeys(lamps if tri_nee else lamps[:n_sph]))
            for n_em_cap in range(n_sph + 2):
                for tri_em_cap in range(n_tri + 2) if tri_nee else (0,):
                    k, kt, e = pg._chip_split(scene, n_em_cap, tri_em_cap, variant, floats)
                    assert 0 <= k <= n_em_cap and 0 <= kt <= tri_em_cap
                    assert 0 <= e <= min(n_mat, pg.MAX_CHIP_MATERIALS) and not (local and e)
                    mats = emitter_materials(scene, tri_nee, e)
                    assert mats == pool[:e]
                    where = plane_places(scene, n_em_cap, tri_em_cap, tri_nee,
                                         floats=floats, variant=variant)
                    assert len(where) == 12 * n_em_cap + 27 * tri_em_cap + 3 * n_mat
                    slots = [f for f in where.values() if f is not None]
                    assert len(slots) == len(set(slots)) == 12 * k + 27 * kt + 3 * len(mats)
                    assert all(0 <= f < floats for f in slots)
                    if 12 * n_em_cap + 27 * tri_em_cap + 3 * (not local) * len(pool) <= floats:
                        assert (k, kt, len(mats)) == (n_em_cap, tri_em_cap,
                                                      0 if local else len(pool))
    for name in pg.VARIANTS.keys() - {"shared_planes", "local_planes"}:
        assert pg._chip_split(scene, 2, 1, name, 48) == (0, 0, 0)
    assert pg.policy()["planes"] == "device"


def test_rough_planes_shift_the_emission_planes():
    """With ``rough_grad`` a material has 12 planes; its emission planes are
    still its 4th to 6th."""
    scene, _ = lights_scene(2, 0)
    where = plane_places(scene, 0, 0, False, rough_grad=True)
    on = sorted(i for (fam, i), f in where.items() if fam == "jac" and f is not None)
    assert on == [12 * m + 3 + c for m in (1, 2) for c in range(3)]


def numpy_adds(scene, h, w, spp, bounces, seed, n_em_cap, tri_nee, tri_em_cap, rough_grad,
               nee=True):
    """A numpy transcription of B4's add sites, pixel by pixel and round by
    round over the twin's replayed records: per forward round with a valid
    light sample 12 adds into the sampled sphere ordinal's geometry planes
    (if below the cap) or 27 into the triangle ordinal's; per swept hit on a
    material of the table 6 (9 with roughness) into its albedo and
    transparency planes and, where its emission is added, 3 into its
    emission planes; per valid light sample 3 into the sampled emitter's
    material's emission planes."""
    cx = pg._replay_setup(scene, PCAM, h, w, nee, tri_nee)
    n_mat = scene.num_materials
    mp = 12 if rough_grad else 9
    out = dict.fromkeys(pg.EVENTS[2:], 0)
    for s in range(spp):
        records, *_ = pg._replay_sample(cx, s, seed, 0, True, bounces)
        recs = []
        for rec in records:
            r = {key: getattr(rec, key).numpy() for key in ("hit", "miss", "addle", "valid")}
            r["m"] = rec.m.numpy()
            if rec.light is not None:
                for key in ("kk", "emat", "is_tri", "kt"):
                    if key in rec.light:
                        r[key] = rec.light[key].numpy()
            recs.append(r)
        for p in range(cx.n):
            for r in recs:
                if not r["hit"][p]:
                    continue
                m = int(r["m"][p])
                if 0 <= m < n_mat:
                    out["adds_material"] += mp - 3
                    if r["addle"][p]:
                        out["adds_hit_emission"] += 3
                if not r["valid"][p]:
                    continue
                emat = int(r["emat"][p])
                if 0 <= emat < n_mat:
                    out["adds_emitter_emission"] += 3
                if "is_tri" in r and r["is_tri"][p]:
                    if int(r["kt"][p]) < tri_em_cap:
                        out["adds_triangle_geometry"] += 27
                elif int(r["kk"][p]) < n_em_cap:
                    out["adds_sphere_geometry"] += 12
    return out


@pytest.mark.parametrize("name, kw", [
    ("glossy", dict(n_em_cap=1)),
    ("glossy", dict(n_em_cap=0, rough_grad=True)),
    ("spheres32", dict(n_em_cap=4)),
    ("spheres32", dict(n_em_cap=2, tri_nee=True)),
    ("tri_light", dict(n_em_cap=1, tri_nee=True, tri_em_cap=2)),
    ("tri_light", dict(n_em_cap=0, tri_nee=True, tri_em_cap=1)),
    ("tri_light", dict(n_em_cap=1, nee=False)),
])
def test_twin_add_counts_match_a_numpy_transcription(name, kw):
    """The twin's counts of plane adds by family equal the numpy
    transcription's at a small shape, with ``tri_nee`` on and off; the
    sampled emitters' emission is 3 a valid light sample (every emitter's
    material is in the table), the sphere family 12 a valid sphere sample
    under the cap."""
    scene = {"glossy": lambda: P.demo.glossy_scene("cpu"),
             "spheres32": lambda: P.demo.random_spheres_scene("cpu"),
             "tri_light": lambda: S.carry(S.tri_light_mixed_scene())}[name]()
    h, w, spp, bounces, seed = 6, 20, 2, 4, 5
    kw = dict(kw)
    tri_nee, tri_em_cap = kw.pop("tri_nee", False), kw.pop("tri_em_cap", 0)
    rough, nee = kw.pop("rough_grad", False), kw.pop("nee", True)
    events = pg.render_physical_fused_reference(
        scene, PCAM, h, w, spp, bounces, seed, tri_nee=tri_nee, tri_em_cap=tri_em_cap,
        rough_grad=rough, nee=nee, count_events=True, **kw)[-1]
    assert tuple(events) == pg.EVENTS
    want = numpy_adds(scene, h, w, spp, bounces, seed, kw["n_em_cap"], tri_nee, tri_em_cap,
                      rough, nee)
    assert {key: events[key] for key in want} == want
    assert events["adds_material"] > 0
    assert events["adds_emitter_emission"] == 3 * events["valid_samples"]
    if nee and not tri_nee and kw["n_em_cap"] >= rp.live_emitter_count(scene):
        assert events["adds_sphere_geometry"] == 12 * events["valid_samples"]


@pytest.mark.parametrize("n_em_cap", [3, 5])
def test_twin_matches_pallas_interpret_above_the_budget(n_em_cap):
    """Caps above the on-chip budget (two sphere ordinals at the default)
    and more emitter materials than it holds: the twin, which the kernel
    equals bit for bit at every split, against the Pallas kernel in
    interpret mode."""
    jscene = S.many_lights_scene(5)
    want = jpp.render_physical_pallas_fused(jscene, JCAM, 8, 128, 2, 3, jnp.uint32(3),
                                            jitter=False, n_em_cap=n_em_cap, tile=(8, 128),
                                            interpret=True)
    pscene = S.carry(jscene)
    got = pg.render_physical_fused_reference(pscene, PCAM, 8, 128, 2, 3, 3, jitter=False,
                                             n_em_cap=n_em_cap)
    assert n_em_cap > pg.chip_plane_split(n_em_cap, 0, pscene.num_materials)[0]
    S.assert_images_close(got[0].numpy(), want[0])
    for a, b in zip(got[1:], want[1:]):
        S.assert_planes_close(a.numpy(), np.asarray(b))
    assert float(got[2].abs().sum()) > 0
