"""path_tracer_c_tpu_torch: the path tracer on PyTorch and CUDA.

A port of ``path_tracer_c_tpu`` (JAX, Pallas on TPU) to PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper: the forward render
(``render_kernel``), its gradient (``render_kernel_vjp``, the material
fit in ``grad.diff``), the physical tier's forward render
(``render_physical_kernel``; eager: ``render_physical``) and its gradient
(``render_physical_kernel_vjp``, the two-pass oracle ``render_physical_bwd``,
the geometry, roughness and camera fits in ``grad.diff``). The JAX package
is the reference this package is held against; this package imports PyTorch and
never JAX.

Functions that create tensors from nothing (scene builders, demo scenes,
camera constructors, ``scene_from_arrays``) take an explicit ``device``;
functions that take tensors run on their inputs' device and raise if the
inputs disagree. Nothing picks a device on its own.
"""

from .scene.scene import Scene, SceneBuilder, Materials, Spheres, Triangles
from .scene import demo
from .scene.io import scene_from_arrays
from .ops.camera import Camera, primary_rays
from .ops.intersect import Hit, trace
from .ops.render_kernel import render_kernel, render_kernel_reference
from .ops.render_grad import (
    render_fused, render_fused_reference, contract_jacobian, render_kernel_vjp,
)
from .ops.render_physical import render_physical_kernel, render_physical_kernel_reference
from .ops.render_physical_grad import (
    render_physical_fused, render_physical_fused_reference, contract_physical_jacobian,
    render_physical_kernel_vjp, render_physical_bwd, render_physical_bwd_reference,
)
from .grad import diff
from .grad.diff import loss_and_grad, fit_materials, fit_geometry, fit_camera
from .models.integrator import render_radiance, render_image_u8, trace_paths
from .models.physical import render_physical, trace_paths_physical
from .utils.bitmap import write_bitmap, bitmap_bytes

__version__ = "0.1.0"

__all__ = [
    "Scene", "SceneBuilder", "Materials", "Spheres", "Triangles", "demo",
    "scene_from_arrays", "Camera", "primary_rays", "Hit", "trace",
    "render_kernel", "render_kernel_reference",
    "render_fused", "render_fused_reference", "contract_jacobian",
    "render_kernel_vjp", "render_physical_kernel", "render_physical_kernel_reference",
    "render_physical_fused", "render_physical_fused_reference", "contract_physical_jacobian",
    "render_physical_kernel_vjp", "render_physical_bwd", "render_physical_bwd_reference",
    "render_physical", "trace_paths_physical", "diff", "loss_and_grad", "fit_materials",
    "fit_geometry", "fit_camera",
    "render_radiance", "render_image_u8", "trace_paths",
    "write_bitmap", "bitmap_bytes",
]
