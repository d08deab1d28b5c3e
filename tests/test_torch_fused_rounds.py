"""PyTorch port: the rounds of the two fused primal + Jacobian kernels (B2,
B4) under their per-sample schedule and under path regeneration, from their
plain twins, and the rules of their measurement instantiations. The kernels' counting instantiations are held to
these twins in test_torch_cuda.py.

No tolerance: counts are integers, and the groupings are checked against a
numpy transcription of how the launch groups pixels into warps.
"""

import numpy as np
import pytest
import torch

import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.ops import render_grad as rg
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
from path_tracer_c_tpu_torch.utils import tracing

torch.set_num_threads(1)

CAM = P.Camera.reference("cpu")


def numpy_groupings(rounds):
    """Warp lane-rounds of (spp, H, W) per-pixel rounds, a warp being 32
    consecutive columns of one row from a multiple of 32: per sample (each
    sample's longest lane) and per lane total (the longest lane's total)."""
    per_sample = per_lane = 0
    spp, height, width = rounds.shape
    for row in range(height):
        for c0 in range(0, width, 32):
            lanes = rounds[:, row, c0:c0 + 32]
            per_sample += int(lanes.max(axis=1).sum()) * lanes.shape[1]
            per_lane += int(lanes.sum(axis=0).max()) * lanes.shape[1]
    return per_sample, per_lane


def fused_pixel_rounds(kernel, *args, **kw):
    per_sample = []
    out = kernel(*args, on_sample=per_sample.append, **kw)
    return torch.stack(per_sample), out


CASES = [  # name, height, width, spp, bounces, keywords
    ("glossy_scene", 19, 45, 3, 5, {}),  # a partial warp in every row
    ("cornell_spheres_scene", 8, 70, 2, 4, dict(jitter=True, sample_offset=5)),
    ("glossy_scene", 5, 33, 2, 0, {}),  # one round a sample
]


@pytest.mark.parametrize("name, h, w, spp, bounces, kw", CASES)
def test_reference_fused_groupings(name, h, w, spp, bounces, kw):
    """B2's twin: the per-(sample, pixel) rounds sum to count_rounds, both
    groupings lie between the thread-rounds and the nominal rounds, the
    per-lane total (regeneration) is at most the per-sample grouping (equal
    with one round a sample), and both equal the numpy grouping."""
    scene = getattr(P.demo, name)("cpu")
    args = (scene, CAM, h, w, spp, bounces, 7)
    rounds, (_, _, n) = fused_pixel_rounds(rg.render_fused_reference, *args, count_rounds=True,
                                           **kw)
    assert rounds.shape == (spp, h, w) and rounds.dtype == torch.int64
    counts = rg.render_fused_round_counts(*args, **kw)
    assert counts == rg.render_fused_round_counts_reference(*args, **kw)
    assert counts["thread_rounds"] == int(rounds.sum()) == n
    per_sample, per_lane = numpy_groupings(rounds.numpy())
    assert (counts["warp_lane_rounds"], counts["warp_lane_rounds_regen"]) == (per_sample,
                                                                             per_lane)
    nominal = h * w * spp * (bounces + 1)
    assert counts["thread_rounds"] <= per_lane <= counts["warp_lane_rounds"] <= nominal
    if bounces == 0:
        assert counts["thread_rounds"] == per_lane == counts["warp_lane_rounds"] == nominal


@pytest.mark.parametrize("name, h, w, spp, bounces, kw", CASES + [
    ("tri_light", 9, 40, 2, 3, dict(tri_nee=True, jitter=False)),
    ("cornell_spheres_scene", 6, 40, 2, 3, dict(nee=False)),
])
def test_reference_physical_fused_groupings(name, h, w, spp, bounces, kw):
    """B4's twin, as B2's: the per-(sample, pixel) rounds sum to the counted
    rounds of count_events, and the groupings hold the same order."""
    from test_torch_cuda import physical_scene

    scene = physical_scene(name, "cpu")
    args = (scene, CAM, h, w, spp, bounces, 7)
    rounds, out = fused_pixel_rounds(pg.render_physical_fused_reference, *args,
                                     count_events=True, **kw)
    counts = pg.render_physical_fused_round_counts(*args, **kw)
    assert counts == pg.render_physical_fused_round_counts_reference(*args, **kw)
    assert counts["thread_rounds"] == int(rounds.sum()) == out[-1]["rounds"]
    per_sample, per_lane = numpy_groupings(rounds.numpy())
    assert (counts["warp_lane_rounds"], counts["warp_lane_rounds_regen"]) == (per_sample,
                                                                             per_lane)
    assert counts["thread_rounds"] <= per_lane <= counts["warp_lane_rounds"]
    assert per_sample <= h * w * spp * (bounces + 1)


def test_fused_rounds_are_the_forward_kernel_s_without_a_black_albedo():
    """On a scene with no black albedo B2's paths end where B1's do (a miss,
    a death, the budget: zero throughput needs a black material), so the
    per-(sample, pixel) rounds are B1's reference_pixel_rounds; regeneration
    returns lane slots at this shape."""
    scene = P.demo.glossy_scene("cpu")
    args = (scene, CAM, 16, 64, 4, 6, 3)
    kw = dict(jitter=True, sample_offset=2)
    rounds, _ = fused_pixel_rounds(rg.render_fused_reference, *args, **kw)
    assert torch.equal(rounds, rk.reference_pixel_rounds(*args, **kw))
    counts = rk.round_groupings(rounds)
    assert counts["warp_lane_rounds"] == rk.render_kernel_round_counts(
        *args, **kw, tile=rg.FUSED_TILE)["warp_lane_rounds"]
    assert counts["warp_lane_rounds_regen"] < counts["warp_lane_rounds"]


def test_fused_rounds_exceed_the_forward_kernel_s_on_a_black_albedo():
    """A black material ends B1's path at zero throughput, never B2's."""
    from test_torch_cuda import mixed_scene

    args = (mixed_scene("cpu"), CAM, 8, 40, 2, 4, 5)
    rounds, _ = fused_pixel_rounds(rg.render_fused_reference, *args)
    forward = rk.reference_pixel_rounds(*args)
    assert bool((rounds >= forward).all()) and int(rounds.sum()) > int(forward.sum())


def test_variants_are_for_the_card_only():
    """A measurement instantiation has no twin: CPU tensors raise, as do an
    unknown variant and the registers instantiation above its records;
    nothing launches. Both kernels have the sink and registers
    instantiations, and each its records in the memory the other keeps
    them in; B4 also the instantiations of its own policies, each one
    policy away from the kernel."""
    scene = P.demo.glossy_scene("cpu")
    launches = tracing.counters()
    for fn in (rg.render_fused_variant, pg.render_physical_fused_variant):
        with pytest.raises(ValueError, match="CUDA"):
            fn(scene, CAM, 4, 4, 1, 2, 0, "sink")
        with pytest.raises(ValueError, match="unknown variant"):
            fn(scene, CAM, 4, 4, 1, 2, 0, "regen")
        with pytest.raises(ValueError, match="cap"):
            fn(scene, CAM, 4, 4, 1, rg.REGISTER_ROUNDS, 0, "registers")
    grew = tracing.counters() - launches
    assert grew["launch.render_fused.variant"] == grew["launch.render_phys_fused.variant"] == 0
    assert rg.VARIANTS == {"sink": 0, "registers": 1, "local_records": 2}
    assert {k: v for k, v in pg.VARIANTS.items() if v < 3} == {
        "sink": 0, "registers": 1, "shared_records": 2}
    for name in pg.POLICY_VARIANTS:
        moved = {k for k, v in pg.policy(name).items() if v != pg.KERNEL_POLICY[k]}
        assert moved and moved <= {"loops", "planes", "blocks"}, name
