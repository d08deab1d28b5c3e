"""The yardstick and the reference against the port on the CPU: the
frozen operation and byte counts equal ``utils/flops.py``'s, and at a
small frame the reference's images, Jacobian and event counts equal the
port's plain twins'."""

from __future__ import annotations

import pytest
import torch

from conftest import BENCH

from harness import flops, spec
from reference import scenes, tracer

SHAPE = (16, 24, 3, 3)  # height, width, spp, bounces
SEED = 2**31 + 777


def _port_inputs(tables, cam):
    from path_tracer_c_tpu_torch.ops.camera import Camera
    from path_tracer_c_tpu_torch.scene.io import scene_from_arrays

    return scene_from_arrays(tables, "cpu"), Camera.from_arrays(cam, "cpu")


@pytest.mark.parametrize("kind", flops.KINDS)
def test_frozen_counts_equal_the_ports(kind):
    from path_tracer_c_tpu_torch.utils.flops import bound_ms, kernel_op_counts

    tables = scenes.glossy()
    scene, _ = _port_inputs(tables, scenes.camera(90.0))
    H, W, spp, _ = SHAPE
    events = {"rounds": 3000, "diffuse_vertices": 700, "light_samples": 650, "shadow_scans": 500}
    mine = flops.counts(kind, {"spheres": 14, "triangles": 2, "materials": 15}, H, W, spp,
                        events if kind == "physical" else {"rounds": events["rounds"]})
    port = kernel_op_counts(kind, scene, H, W, spp, SHAPE[3], events)
    assert {k: mine[k] for k in ("alu", "sqrt", "bytes")} == \
        {k: port[k] for k in ("alu", "sqrt", "bytes")}
    port_ms, port_by = bound_ms(port)
    least, by = flops.least_seconds(mine)
    assert least * 1e3 == pytest.approx(port_ms, rel=1e-12) and by == port_by


@pytest.mark.parametrize("scene_name,jitter", [("glossy", True), ("spheres32", False)])
def test_reference_equals_the_ports_twins(scene_name, jitter):
    from path_tracer_c_tpu_torch.ops import render_grad, render_kernel, render_physical

    tables, cam = scenes.scene(scene_name), scenes.camera(90.0)
    scene, camera = _port_inputs(tables, cam)
    ref_scene, ref_cam = tracer.tensors(tables, "cpu"), tracer.camera_tensors(cam, "cpu")
    H, W, spp, B = SHAPE
    img, ev = tracer.render_forward(ref_scene, ref_cam, H, W, spp, B, SEED, jitter, count=True)
    p_img, p_rounds = render_kernel.render_kernel_reference(scene, camera, H, W, spp, B, SEED,
                                                            jitter=jitter, count_rounds=True)
    assert torch.equal(img, p_img) and ev["rounds"] == p_rounds
    img, jac, ev = tracer.render_fused(ref_scene, ref_cam, H, W, spp, B, SEED, jitter, count=True)
    p_img, p_jac, p_rounds = render_grad.render_fused_reference(
        scene, camera, H, W, spp, B, SEED, jitter=jitter, count_rounds=True)
    assert torch.equal(img, p_img) and torch.equal(jac, p_jac) and ev["rounds"] == p_rounds
    img, ev = tracer.render_physical(ref_scene, ref_cam, H, W, spp, B, SEED, jitter, count=True)
    p_img, p_ev = render_physical.render_physical_kernel_reference(
        scene, camera, H, W, spp, B, SEED, jitter=jitter, count_events=True)
    assert torch.equal(img, p_img) and ev == p_ev


@pytest.mark.parametrize("kernel", ["b1", "b2", "b3"])
def test_counted_rows_scale_to_the_frame(kernel):
    """Every row counted gives the frame's count exactly; every sixteenth
    row, scaled, lands near it."""
    render = spec.load_module(BENCH / "counts" / f"{kernel}.py", f"test_counts_{kernel}").RENDER
    tables, cam = scenes.glossy(), scenes.camera(90.0)
    args = (tracer.tensors(tables, "cpu"), tracer.camera_tensors(cam, "cpu"), 64, 24, 2, 3, SEED,
            True)
    whole, share = tracer.count_events(render, *args, stride=1)
    assert share == 1.0
    assert whole == {k: float(v) for k, v in render(*args, count=True)[-1].items()}
    part, share = tracer.count_events(render, *args, stride=16)
    assert share == pytest.approx(1 / 16)
    assert part["rounds"] == pytest.approx(whole["rounds"], rel=0.3)
