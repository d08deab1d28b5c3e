"""PyTorch port on a card: the hand CUDA kernel against its plain twin.

These tests need a CUDA device and skip without one. They import no JAX, so
they also run where only PyTorch is installed; from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest.py configures JAX.)

Tolerance (tests/test_pallas.py's): a 0.999-quantile of |delta| < 1e-4 and
a mean |delta| < 1e-5. On the card the kernel and its twin round alike and
agree bit for bit; the CPU twin rounds rsqrt differently, and a chaotic path
can then flip at a silhouette.
"""

import dataclasses

import pytest
import torch

import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.scene import demo as pdemo

pytestmark = pytest.mark.cuda


def assert_close(a, b):
    err = (a.double().cpu() - b.double().cpu()).abs().flatten()
    assert a.shape == b.shape and bool(torch.isfinite(err).all())
    assert float(torch.quantile(err, 0.999)) < 1e-4
    assert float(err.mean()) < 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", ["demo_scene", "glossy_scene", "cornell_spheres_scene"])
def test_kernel_matches_twin(cuda_device, name):
    scene, cam = getattr(pdemo, name)(cuda_device), P.Camera.reference(cuda_device)
    launches = rk.render_kernel.launches
    for jitter, offset, bounces in ((False, 0, 4), (True, 3, 8)):
        args = (scene, cam, 100, 160, 4, bounces, 7)
        k = rk.render_kernel(*args, sample_offset=offset, jitter=jitter)
        r = rk.render_kernel_reference(*args, sample_offset=offset, jitter=jitter)
        assert k.device == cuda_device and k.shape == (100, 160, 3)
        assert_close(k, r)
    assert rk.render_kernel.launches == launches + 2
    # the chain to the twin on the CPU
    cpu = rk.render_kernel_reference(getattr(pdemo, name)("cpu"), P.Camera.reference("cpu"),
                                     24, 40, 2, 4, 5, sample_offset=2, jitter=True)
    k = rk.render_kernel(scene, cam, 24, 40, 2, 4, 5, sample_offset=2, jitter=True)
    assert_close(k, cpu)


def test_kernel_rejects_mixed_devices(cuda_device):
    scene = pdemo.demo_scene(cuda_device)
    with pytest.raises(ValueError):
        rk.render_kernel(scene, P.Camera.reference("cpu"), 8, 8, 1, 1, 0)
    mixed = dataclasses.replace(scene, sky_color=scene.sky_color.cpu())
    with pytest.raises(ValueError):
        rk.render_kernel(mixed, P.Camera.reference(cuda_device), 8, 8, 1, 1, 0)
