"""PyTorch port: the parallel layer across two processes (``torch.distributed``
over gloo, on the CPU), against one process.

Two worker processes join a group on a free port of localhost, check its
health, render on 2x1 and 2x2 meshes (one and two CPU slots a process) and
take one sharded train step; rank 0 saves what it got. The images, the
loss and the variables after Adam's step must equal the single-process
run's bit for bit: the layer gathers the slots' images and gradients and
sums them in slot order on every process, never in a collective's order.
The workers are killed after ``TIMEOUT`` seconds.
"""

import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from path_tracer_c_tpu_torch import parallel
from path_tracer_c_tpu_torch.grad import diff
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.ops.camera import Camera
from path_tracer_c_tpu_torch.scene import demo

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240
SHAPE = (16, 16, 4, 2)  # height, width, spp, bounces

WORKER = r"""
import sys
import torch
from path_tracer_c_tpu_torch import parallel
from path_tracer_c_tpu_torch.grad import diff
from path_tracer_c_tpu_torch.ops.camera import Camera
from path_tracer_c_tpu_torch.scene import demo

torch.set_num_threads(1)
rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
parallel.distributed.initialize(f"localhost:{port}", 2, rank, backend="gloo")
h, w, spp, bounces = 16, 16, 4, 2
scene, cam = demo.diffuse_sphere_scene("cpu"), Camera.reference("cpu")
rec = {"health": parallel.distributed.health_check(), "multi": parallel.distributed.is_multi_host()}
for tile, spp_ax in ((2, 1), (2, 2)):
    mesh = parallel.make_mesh(tile=tile, spp=spp_ax, devices="cpu")
    rec[f"image {tile}x{spp_ax}"] = parallel.render_sharded(
        scene, cam, h, w, spp, bounces, 5, mesh, engine="cuda")
mesh = parallel.make_mesh(tile=2, spp=2, devices="cpu")
target = parallel.render_sharded(scene, cam, h, w, spp, bounces, 101, mesh)
params = diff.make_material_params(scene)
with torch.no_grad():
    params["albedo_logit"].zero_()
opt = diff._adam(params, 0.1)
step = parallel.make_train_step(cam, h, w, spp, bounces, mesh, diff.apply_material_params,
                                engine="cuda")
rec["loss"] = step(params, opt, scene, target, 1)
rec["params"] = {k: v.detach() for k, v in params.items()}
if rank == 0:
    torch.save(rec, out)
torch.distributed.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp") / "rank0.pt"
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port), str(out)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("the workers did not finish in time")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return torch.load(out)


def test_two_processes_are_a_healthy_group(two_process_run):
    status = two_process_run["health"]
    assert two_process_run["multi"]
    assert status["alive"] and status["processes"] == 2 and status["backend"] == "gloo"


@pytest.mark.parametrize("tile, spp_ax", [(2, 1), (2, 2)])
def test_two_process_render_equals_one_process(two_process_run, tile, spp_ax):
    h, w, spp, bounces = SHAPE
    scene, cam = demo.diffuse_sphere_scene("cpu"), Camera.reference("cpu")
    mesh = parallel.make_mesh(tile=tile, spp=spp_ax, devices="cpu")
    single = parallel.render_sharded(scene, cam, h, w, spp, bounces, 5, mesh, engine="cuda")
    assert torch.equal(two_process_run[f"image {tile}x{spp_ax}"], single)
    if spp_ax == 1:
        assert torch.equal(single, rk.render_kernel(scene, cam, h, w, spp, bounces, 5))


def test_two_process_train_step_equals_one_process(two_process_run):
    h, w, spp, bounces = SHAPE
    scene, cam = demo.diffuse_sphere_scene("cpu"), Camera.reference("cpu")
    mesh = parallel.make_mesh(tile=2, spp=2, devices="cpu")
    target = parallel.render_sharded(scene, cam, h, w, spp, bounces, 101, mesh)
    params = diff.make_material_params(scene)
    with torch.no_grad():
        params["albedo_logit"].zero_()
    opt = diff._adam(params, 0.1)
    step = parallel.make_train_step(cam, h, w, spp, bounces, mesh, diff.apply_material_params,
                                    engine="cuda")
    loss = step(params, opt, scene, target, 1)
    assert torch.equal(two_process_run["loss"], loss)
    for k, v in params.items():
        assert torch.equal(two_process_run["params"][k], v.detach()), k


def test_initialize_needs_an_address():
    with pytest.raises(ValueError, match="coordinator_address"):
        parallel.distributed.initialize(None, 2, 0)
