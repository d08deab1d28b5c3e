"""PyTorch port: the counts of the two-pass oracle B5
(``render_physical_bwd(..., count_sites=True)``) from its plain twin,
against a numpy transcription of how the kernel's warps visit its add
sites, and against B4's rounds; and the rules of its measurement
instantiations. The kernel's counting instantiation is held to the twin in
test_torch_cuda.py.

No tolerance: counts are integers. The transcription reads the eager replay
(``_replay_sample``) pixel by pixel: a warp is 32 consecutive columns of one
row from a multiple of 32; a sample's forward rounds and its sweep run the
warp's longest lane's rounds; forward round b is one visit of the geometry
site, sweep step i (each lane's round n - 1 - i) one visit of each sweep
site, and the pixel's end one visit of the sky's.
"""

import collections

import numpy as np
import pytest
import torch

import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
from path_tracer_c_tpu_torch.utils import tracing
from path_tracer_c_tpu_torch.utils.sol_decompose import fused_decompose

torch.set_num_threads(1)

CAM = P.Camera.reference("cpu")


def numpy_counts(scene, h, w, spp, bounces, seed, n_em_cap, sample_offset=0, jitter=True,
                 nee=True, tri_nee=False):
    """B5's counts, one pixel and one warp visit at a time."""
    cx = pg._replay_setup(scene, CAM, h, w, nee, tri_nee)
    n_mat = cx.n_mat
    c = dict.fromkeys(pg.BWD_COUNTS, 0)

    def visit(site, keys):
        if keys:
            per_row = collections.Counter(keys)
            c[f"{site}_lanes"] += len(keys)
            c[f"{site}_groups"] += len(per_row)
            c[f"{site}_depth"] += max(per_row.values())
            c[f"{site}_visits"] += 1

    for s in range(spp):
        records, *_ = pg._replay_sample(cx, s, seed, sample_offset, jitter, bounces)
        as_np = lambda t: t.reshape(h, w).numpy()
        R = []
        for rec in records:
            light = rec.light
            R.append(dict(
                alive=as_np(rec.hit | rec.miss), hit=as_np(rec.hit), m=as_np(rec.m),
                addle=as_np(rec.addle), valid=as_np(rec.valid),
                sphere=as_np(rec.valid & ~light["is_tri"]) if light is not None and "is_tri" in light
                else as_np(rec.valid),
                emat=as_np(light["emat"]) if light is not None else np.full((h, w), -1),
                kk=as_np(light["kk"]) if light is not None else np.zeros((h, w), int)))
        for row in range(h):
            for c0 in range(0, w, 32):
                cols = range(c0, min(c0 + 32, w))
                n = {col: sum(int(r["alive"][row, col]) for r in R) for col in cols}
                widest = max(n.values())
                for key in ("fwd", "sweep"):
                    c[f"{key}_thread_rounds"] += sum(n.values())
                    c[f"{key}_warp_lane_rounds"] += widest * len(cols)
                for b in range(widest):
                    visit("geo", [int(R[b]["kk"][row, col]) for col in cols
                                  if b < n[col] and R[b]["sphere"][row, col]
                                  and R[b]["kk"][row, col] < n_em_cap])
                for i in range(widest):
                    mat, le, em = [], [], []
                    for col in cols:
                        if i >= n[col]:
                            continue
                        r = R[n[col] - 1 - i]
                        m = int(r["m"][row, col])
                        if r["hit"][row, col] and 0 <= m < n_mat:
                            mat.append(m)
                            if r["addle"][row, col]:
                                le.append(m)
                        e = int(r["emat"][row, col])
                        if r["valid"][row, col] and 0 <= e < n_mat:
                            em.append(e)
                    visit("mat", mat)
                    visit("mat_le", le)
                    visit("emitter", em)
    for row in range(h):
        for c0 in range(0, w, 32):
            visit("sky", [0] * len(range(c0, min(c0 + 32, w))))
    return c


def tri_light_scene():
    from test_torch_cuda import tri_light_mixed_scene

    return tri_light_mixed_scene("cpu")


# name, height, width, spp, bounces, seed, keywords (n_em_cap: "live" for the
# scene's live sphere-emitter count)
CASES = [
    ("glossy_scene", 8, 45, 2, 3, 7, dict(n_em_cap=0)),
    ("glossy_scene", 8, 45, 2, 3, 7, dict(n_em_cap="live", sample_offset=3)),
    ("random_spheres_scene", 8, 45, 2, 3, 5, dict(n_em_cap="live", jitter=False)),
    ("random_spheres_scene", 8, 40, 2, 3, 5, dict(n_em_cap=0)),
    ("tri_light", 6, 40, 2, 3, 7, dict(n_em_cap="live", tri_nee=True, jitter=False)),
    ("tri_light", 6, 40, 2, 3, 7, dict(n_em_cap="live", tri_nee=False)),
    ("glossy_scene", 5, 33, 2, 3, 9, dict(nee=False)),
]


@pytest.mark.parametrize("name, h, w, spp, bounces, seed, kw", CASES)
def test_twin_counts_match_numpy_and_b4_rounds(name, h, w, spp, bounces, seed, kw):
    """The twin's counts equal the numpy transcription, twice alike; its
    forward and sweep thread- and warp lane-rounds equal B4's twin's at the
    same arguments; the counts order as they must (a visit has at least one
    lane and one row, and at most its lanes on one row); the cotangents are
    the twin's without counting."""
    scene = tri_light_scene() if name == "tri_light" else getattr(P.demo, name)("cpu")
    kw = dict(kw)
    if kw.get("n_em_cap") == "live":
        kw["n_em_cap"] = rp.live_emitter_count(scene)
    args = (scene, CAM)
    g = torch.tensor(np.random.default_rng(seed).standard_normal((h, w, 3)).astype(np.float32))
    d, counts = pg.render_physical_bwd(*args, g, h, w, spp, bounces, seed, count_sites=True, **kw)
    again = pg.render_physical_bwd(*args, g, h, w, spp, bounces, seed, count_sites=True, **kw)[1]
    assert counts == again
    assert list(counts) == list(pg.BWD_COUNTS)
    cap = pg._bwd_cap(scene, kw.get("nee", True), kw.get("n_em_cap"))
    want = numpy_counts(scene, h, w, spp, bounces, seed, cap,
                        **{k: v for k, v in kw.items() if k != "n_em_cap"})
    assert counts == want
    fkw = {k: v for k, v in kw.items() if k != "n_em_cap"}
    b4 = pg.render_physical_fused_round_counts(*args, h, w, spp, bounces, seed, **fkw)
    assert counts["fwd_thread_rounds"] == counts["sweep_thread_rounds"] == b4["thread_rounds"]
    assert (counts["fwd_warp_lane_rounds"] == counts["sweep_warp_lane_rounds"]
            == b4["warp_lane_rounds"])
    for site in pg.BWD_SITES:
        lanes, groups, depth, visits = (counts[f"{site}_{k}"]
                                        for k in ("lanes", "groups", "depth", "visits"))
        assert visits <= groups <= lanes and visits <= depth <= lanes
    assert counts["mat_le_lanes"] <= counts["mat_lanes"]
    if not kw.get("nee", True) or not cap:
        assert counts["geo_lanes"] == 0
    assert counts["sky_lanes"] == h * w and counts["sky_visits"] == h * -(-w // 32)
    plain = pg.render_physical_bwd(*args, g, h, w, spp, bounces, seed, **kw)
    for table, leaf in pg._GRAD_LEAVES:
        get = lambda t: getattr(getattr(t, table) if table else t, leaf)
        assert torch.equal(get(d), get(plain))


def test_counts_over_row_blocks_sum_to_the_whole():
    """Counts are sums over warps of one row, so a block of rows counts its
    own rows: the blocks' counts add up to the whole's."""
    scene = P.demo.glossy_scene("cpu")
    g = torch.tensor(np.random.default_rng(3).standard_normal((9, 40, 3)).astype(np.float32))
    args = (scene, CAM)
    whole = pg.render_physical_bwd(*args, g, 9, 40, 2, 3, 7, n_em_cap=1, count_sites=True)[1]
    parts = [pg.render_physical_bwd(*args, g[r0:r0 + n], 9, 40, 2, 3, 7, n_em_cap=1,
                                    row_start=r0, rows=n, count_sites=True)[1]
             for r0, n in ((0, 4), (4, 5))]
    assert {k: parts[0][k] + parts[1][k] for k in whole} == whole


def test_atomics_from_the_counts():
    """``bwd_atomics``: per-lane atomics are the lanes times the site's
    values; the kernel's group adds are the groups' (a hit's row and its
    emission as one run of eight)."""
    counts = dict.fromkeys(pg.BWD_COUNTS, 0)
    counts.update(mat_lanes=10, mat_groups=3, mat_le_lanes=7, mat_le_groups=3, emitter_lanes=5,
                  emitter_groups=2, geo_lanes=4, geo_groups=1, sky_lanes=32, sky_groups=1)
    a = pg.bwd_atomics(counts)
    assert a["mat"] == {"lanes": 40, "groups": 24} and a["mat_le"] == {"lanes": 28, "groups": 0}
    assert a["emitter"] == {"lanes": 20, "groups": 8} and a["geo"] == {"lanes": 16, "groups": 4}
    assert a["sky"] == {"lanes": 96, "groups": 3}


def test_bwd_variants_are_for_the_card_only():
    """B5's measurement instantiations have no twin: CPU tensors raise, as
    do an unknown variant and the decomposition without a card; nothing
    launches."""
    scene = P.demo.glossy_scene("cpu")
    g = torch.zeros(4, 8, 3)
    launches = tracing.counters()
    with pytest.raises(ValueError, match="CUDA"):
        pg.render_physical_bwd_variant(scene, CAM, g, 4, 8, 1, 2, 0, "sink")
    with pytest.raises(ValueError, match="unknown variant"):
        pg.render_physical_bwd_variant(scene, CAM, g, 4, 8, 1, 2, 0, "lane_atomics")
    with pytest.raises(ValueError, match="g has shape"):
        pg.render_physical_bwd_variant(scene, CAM, g[:3], 4, 8, 1, 2, 0, "sink")
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_decompose("physical_bwd", "cpu", small=True)
    grew = tracing.counters() - launches
    assert grew["launch.render_phys_bwd"] == grew["launch.render_phys_bwd.variant"] == 0
    assert pg.BWD_VARIANTS == {"sink": 0, "shared_records": 1}
