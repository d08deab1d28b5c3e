"""PyTorch port: the speed-of-light probes' twins (B7, B8), the forward
kernel's warp lane-rounds, and the decomposition's refusal without a card.

``scripts/sol_decompose.py`` defines its two Pallas kernels inside
``main()``, which runs on the TPU only, so the twins are held against numpy
float32 transcriptions of them, cited by line: ``_null_kernel``
(:119-124) and ``kern`` of ``_mk_micro`` (:159-187), with the table of :156.
Both comparisons are exact: B7 moves values, and B8's twin performs the same
float32 multiplies and adds in the same order as the transcription.
"""

import numpy as np
import pytest
import torch

import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.ops import sol_probes as sp
from path_tracer_c_tpu_torch.utils import tracing
from path_tracer_c_tpu_torch.utils.sol_decompose import sol_decompose, table_loads_per_round

torch.set_num_threads(1)

CAM = P.Camera.reference("cpu")


def numpy_null(tables0, th, tw):
    """scripts/sol_decompose.py:119-124: out[0] = tables[0][0, 0], out[1] =
    out[2] = 0 over a (th, tw) block; here as the port's (H, W, 3) layout."""
    out = np.zeros((3, th, tw), np.float32)
    out[0] = np.full((th, tw), tables0[0, 0], np.float32)
    return np.moveaxis(out, 0, -1)


def numpy_micro(table, seed, th, tw, reps=200, hoisted=False):
    """scripts/sol_decompose.py:159-187, both variants, in float32."""
    x = np.full((th, tw), np.float32(np.int32(seed)) * np.float32(1e-6), np.float32)
    sc = [[table[i, k] for k in range(5)] for i in range(table.shape[0])]
    for _ in range(reps):
        for i in range(table.shape[0]):
            a, b, c, d, e = sc[i] if hoisted else (table[i, 0], table[i, 1], table[i, 2],
                                                    table[i, 3], table[i, 4])
            x = ((x * a + b) * c + d) * e + x
    return x


@pytest.mark.parametrize("name", ["glossy_scene", "demo_scene", "cornell_spheres_scene"])
def test_null_twin_matches_the_transcription(name):
    scene = getattr(P.demo, name)("cpu")
    launches = tracing.counters()
    got = sp.sol_null(scene, CAM, 19, 45)
    assert (tracing.counters() - launches)["launch.sol_null"] == 0  # the twin ran
    tables0 = scene.spheres.center.numpy()  # the TPU kernel's first SMEM operand
    np.testing.assert_array_equal(got.numpy(), numpy_null(tables0, 19, 45))
    assert got.dtype == torch.float32 and got.shape == (19, 45, 3)


@pytest.mark.parametrize("seed, reps", [(7, 200), (123456, 31), (-5, 3)])
def test_micro_twin_matches_the_transcription(seed, reps):
    table_np = np.arange(sp.MICRO_NOBJ * 5, dtype=np.float32).reshape(sp.MICRO_NOBJ, 5) * np.float32(1e-3)
    table = sp.micro_table("cpu")
    np.testing.assert_array_equal(table.numpy(), table_np)
    seed_t = torch.tensor([[seed]], dtype=torch.int32)
    want = numpy_micro(table_np, seed, 3, 5, reps)
    np.testing.assert_array_equal(want, numpy_micro(table_np, seed, 3, 5, reps, hoisted=True))
    launches = tracing.counters()
    for hoisted in (False, True):
        got = sp.sol_micro(table, seed_t, 3, 5, hoisted, reps=reps)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (tracing.counters() - launches)["launch.sol_micro"] == 0
    assert np.isfinite(want).all()


def test_micro_refuses_what_the_kernel_does_not_take():
    table, seed = sp.micro_table("cpu"), torch.tensor([[1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="hoisted"):
        sp.sol_micro(table[:5], seed, 4, 4, hoisted=True)
    with pytest.raises(ValueError):
        sp.sol_micro(table.double(), seed, 4, 4, hoisted=False)
    with pytest.raises(ValueError):
        sp.sol_micro(table, seed.long(), 4, 4, hoisted=False)
    with pytest.raises(ValueError):
        sp.sol_micro(table, seed, 0, 4, hoisted=False)


def numpy_warp_lane_rounds(rounds):
    """Group (spp, H, W) per-pixel rounds as the launch does: a warp is 32
    consecutive columns of one row, from a multiple of 32."""
    total = 0
    for sample in rounds:
        for row in sample:
            for c0 in range(0, row.shape[0], 32):
                lanes = row[c0:c0 + 32]
                total += int(lanes.max()) * lanes.shape[0]
    return total


@pytest.mark.parametrize("jitter, offset", [(False, 0), (True, 3)])
def test_warp_lane_rounds_at_a_ragged_shape(jitter, offset):
    """19x45 (a partial warp in every row, a partial block): thread-rounds
    <= warp lane-rounds <= nominal, the thread-rounds are count_rounds',
    and the warp lane-rounds equal a numpy grouping of the twin's
    per-(sample, pixel) rounds."""
    scene = P.demo.glossy_scene("cpu")
    args = (scene, CAM, 19, 45, 3, 5, 7)
    kw = dict(jitter=jitter, sample_offset=offset)
    # warps of one row of 32, as numpy_warp_lane_rounds groups them
    counts = rk.render_kernel_round_counts(*args, **kw, tile="8x32/1x32")
    per_pixel = rk.reference_pixel_rounds(*args, **kw)
    assert per_pixel.shape == (3, 19, 45) and per_pixel.dtype == torch.int64
    nominal = 19 * 45 * 3 * 6
    assert 0 < counts["thread_rounds"] <= counts["warp_lane_rounds"] <= nominal
    assert counts["thread_rounds"] == int(per_pixel.sum())
    assert counts["thread_rounds"] == rk.render_kernel(*args, count_rounds=True, **kw)[1]
    assert counts["warp_lane_rounds"] == numpy_warp_lane_rounds(per_pixel.numpy())
    assert counts["warp_lane_rounds"] == rk.warp_lane_rounds(per_pixel)
    assert counts["warp_lane_rounds"] > counts["thread_rounds"]  # the glossy scene diverges


def test_the_twin_image_is_unchanged_by_counting():
    """Counting rounds changes nothing in the twin's image."""
    scene = P.demo.demo_scene("cpu")
    args = (scene, CAM, 12, 40, 2, 4, 5)
    img, rounds = rk.render_kernel_reference(*args, jitter=True, count_rounds=True)
    assert torch.equal(img, rk.render_kernel_reference(*args, jitter=True))
    assert rounds == int(rk.reference_pixel_rounds(*args, jitter=True).sum())


def test_decomposition_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        sol_decompose("cpu", small=True)
    scene = P.demo.glossy_scene("cpu")
    assert table_loads_per_round(scene) == 5 * scene.num_spheres + 10 * scene.num_triangles + 9
