"""PyTorch port: the rounds of the two forward kernels (B1, B3) under the
per-sample schedule and under path regeneration, from their plain twins, and
the rules of their instantiations (csrc/pt_sched.cuh). The kernels' counting
instantiations are held to these twins in test_torch_cuda.py.

No tolerance: counts are integers, and the groupings are checked against a
numpy transcription of how the launch groups pixels into warps and how each
schedule runs a warp's rounds.
"""

import numpy as np
import pytest
import torch

import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.utils import tracing

torch.set_num_threads(1)

CAM = P.Camera.reference("cpu")


def numpy_event_groupings(masks):
    """Warp lane-rounds of per-(sample, round) pixel masks ``masks`` (spp,
    B + 1, H, W, 3: the pixel ran the round, computed a light sample in it,
    ran a shadow scan in it), a warp being 32 consecutive columns of one row
    from a multiple of 32. Per sample: the warp runs round b of sample s, and
    each event in it, where some lane does. Regenerating: a lane's rounds run
    in the warp's iterations 0, 1, 2, ... one after another across its
    samples, and the warp runs an iteration, and each event in it, where some
    lane does. Each counts the warp's lanes."""
    spp, n_rounds, height, width, n_ev = masks.shape
    per_sample, regen = [0] * n_ev, [0] * n_ev
    for row in range(height):
        for c0 in range(0, width, 32):
            m = masks[:, :, row, c0:c0 + 32]  # (spp, rounds, lanes, events)
            lanes = m.shape[2]
            for e in range(n_ev):
                per_sample[e] += int(m[..., e].any(axis=2).sum()) * lanes
                iters = set()
                for lane in range(lanes):
                    k = 0
                    for s in range(spp):
                        for b in range(n_rounds):
                            if m[s, b, lane, 0]:
                                if m[s, b, lane, e]:
                                    iters.add(k)
                                k += 1
                regen[e] += len(iters) * lanes
    return per_sample, regen


def physical_masks(*args, **kw):
    """The twin's per-(sample, round) masks, its per-sample rounds and its
    counted events."""
    rounds, per_round = [], []
    _, events = rp.render_physical_kernel_reference(
        *args, count_events=True, on_sample=rounds.append,
        on_round=lambda *m: per_round.append(torch.stack(m, -1)), **kw)
    spp, height, width = args[4], args[2], args[3]
    masks = torch.stack(per_round).reshape(spp, -1, height, width, 3)
    return masks.numpy(), torch.stack(rounds), events


def tri_light_scene(device):
    from test_torch_cuda import tri_light_mixed_scene

    return tri_light_mixed_scene(device)


def big_table_scene(device):
    from test_torch_cuda import big_table_scene

    return big_table_scene(device)


PHYSICAL_CASES = [  # scene, height, width, spp, bounces, keywords
    ("glossy_scene", 9, 45, 3, 4, {}),  # a partial warp in every row
    ("cornell_spheres_scene", 6, 40, 2, 3, dict(nee=False)),  # no light sample at all
    ("tri_light", 7, 70, 2, 3, dict(tri_nee=True, sample_offset=5)),
    ("glossy_scene", 5, 33, 2, 0, dict(jitter=False)),  # one round a sample
]


@pytest.mark.parametrize("name, h, w, spp, bounces, kw", PHYSICAL_CASES)
def test_reference_physical_groupings(name, h, w, spp, bounces, kw):
    """B3's twin: its per-(sample, pixel) rounds sum to the counted rounds,
    its per-round masks to the counted light samples and shadow scans, and
    its warp lane-rounds of rounds and of both events, under both schedules,
    equal the numpy grouping; the rounds' groupings are
    ``render_kernel.round_groupings`` of the per-sample rounds."""
    scene = (tri_light_scene("cpu") if name == "tri_light" else getattr(P.demo, name)("cpu"))
    args = (scene, CAM, h, w, spp, bounces, 7)
    masks, rounds, events = physical_masks(*args, **kw)
    counts = rp.render_physical_kernel_round_counts(*args, **kw)
    assert counts == rp.render_physical_kernel_round_counts_reference(*args, **kw)
    assert rounds.shape == (spp, h, w) and rounds.dtype == torch.int64
    assert counts["thread_rounds"] == int(rounds.sum()) == events["rounds"]
    assert counts["thread_rounds"] == rp.render_physical_kernel(*args, count_rounds=True,
                                                                **kw)[1]
    assert (counts["light_samples"], counts["shadow_scans"]) == (
        events["light_samples"], events["shadow_scans"])
    assert (int(masks[..., 1].sum()), int(masks[..., 2].sum())) == (
        events["light_samples"], events["shadow_scans"])
    groups = rk.round_groupings(rounds)
    assert counts["warp_lane_rounds"] == groups["warp_lane_rounds"]
    assert counts["warp_lane_rounds_regen"] == groups["warp_lane_rounds_regen"]
    per_sample, regen = numpy_event_groupings(masks)
    for i, key in enumerate(rp.WARP_EVENTS):
        assert (counts[key], counts[key + "_regen"]) == (per_sample[i], regen[i]), key
    assert counts["thread_rounds"] <= counts["warp_lane_rounds_regen"]
    assert counts["warp_lane_rounds_regen"] <= counts["warp_lane_rounds"] <= h * w * spp * (
        bounces + 1)
    if kw.get("nee") is False:
        assert counts["light_warp_lane_rounds"] == counts["light_warp_lane_rounds_regen"] == 0
    if bounces == 0:
        assert counts["warp_lane_rounds"] == counts["warp_lane_rounds_regen"] == h * w * spp


def test_reference_forward_groupings():
    """B1's twin: its round counts are the groupings of its per-(sample,
    pixel) rounds under both schedules, the same on the wrapper's CPU path;
    regeneration returns lane slots on the glossy scene."""
    scene = P.demo.glossy_scene("cpu")
    args = (scene, CAM, 11, 45, 3, 5, 7)
    kw = dict(jitter=True, sample_offset=2)
    rows32 = dict(tile="8x32/1x32")  # warps of one row of 32, as numpy groups them
    counts = rk.render_kernel_round_counts(*args, **kw, **rows32)
    rounds = rk.reference_pixel_rounds(*args, **kw)
    assert counts == rk.render_kernel_round_counts_reference(*args, **kw, **rows32)
    assert counts == rk.round_groupings(rounds)
    masks = np.stack([rounds.numpy() > b for b in range(6)], 1)[..., None]
    per_sample, regen = numpy_event_groupings(masks)
    assert (counts["warp_lane_rounds"], counts["warp_lane_rounds_regen"]) == (per_sample[0],
                                                                             regen[0])
    assert counts["thread_rounds"] <= counts["warp_lane_rounds_regen"] < counts[
        "warp_lane_rounds"]


def test_table_bytes_and_the_shared_budget():
    """The bytes a block stages mirror csrc/pt_sched.cuh's table_words: each
    table rounded up to 16 bytes, an empty object table as one row. The demo
    scenes fit the budget; a scene of 1000 triangles does not, so its
    ``shared`` variants are refused and the kernel reads device memory."""
    scene = P.demo.glossy_scene("cpu")  # 14 spheres, 2 triangles, 15 materials
    seg = lambda n: 4 * ((n + 3) // 4)
    b1 = seg(70) + seg(14) + seg(26) + seg(2) + seg(135)
    assert rk.table_bytes(scene) == 4 * b1
    assert rk.table_bytes(scene, physical=True) == 4 * (
        b1 + seg(14) + seg(42) + seg(2) + seg(6) + seg(2) + seg(15))
    empty = P.SceneBuilder().build("cpu")  # one inactive row a table, one material
    assert rk.table_bytes(empty) == 4 * (seg(5) + seg(1) + seg(13) + seg(1) + seg(9))
    assert rk.tables_in_shared(scene) and rk.tables_in_shared(scene, True, "per_sample")
    assert not rk.tables_in_shared(scene, variant="global_tables")
    big = big_table_scene("cpu")
    assert rk.table_bytes(big) > rk.SHARED_TABLE_BUDGET
    assert not rk.tables_in_shared(big) and not rk.tables_in_shared(big, True, "per_sample")
    for fn in (rk.render_kernel_variant, rp.render_physical_kernel_variant):
        with pytest.raises(ValueError, match="shared budget"):
            fn(big, CAM, 4, 4, 1, 1, 0, "per_sample")


def test_variants_are_for_the_card_only():
    """A measurement instantiation has no twin: CPU tensors raise, as does
    an unknown variant; nothing launches. Both kernels have the same two,
    each the timed kernel (path regeneration, tables in shared memory) under
    one other policy."""
    scene = P.demo.glossy_scene("cpu")
    launches = tracing.counters()
    for fn in (rk.render_kernel_variant, rp.render_physical_kernel_variant):
        for variant in rk.VARIANTS:
            with pytest.raises(ValueError, match="CUDA"):
                fn(scene, CAM, 4, 4, 1, 2, 0, variant)
        with pytest.raises(ValueError, match="unknown variant"):
            fn(scene, CAM, 4, 4, 1, 2, 0, "lanes")
    grew = tracing.counters() - launches
    assert grew["launch.render_fwd.variant"] == grew["launch.render_phys.variant"] == 0
    assert rk.VARIANTS == {"per_sample": 0, "global_tables": 1}
    assert rk.policy() == rk.KERNEL_POLICY == {"schedule": "regen", "tables": "shared"}
    assert rk.policy("per_sample") == {"schedule": "per_sample", "tables": "shared"}
    assert rk.policy("global_tables") == {"schedule": "regen", "tables": "global"}
