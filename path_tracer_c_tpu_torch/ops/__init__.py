"""Compute primitives: RNG, camera, intersection, sampling, the forward
render kernel and the fused primal + Jacobian kernel of the reference tier,
and the physical tier's forward, fused and two-pass backward kernels
(hand-written CUDA, each with its plain PyTorch twin).

``render_kernel``, ``render_grad``, ``render_physical`` and
``render_physical_grad`` are imported by their users; building
the CUDA library happens on the first CUDA call, never at import.
"""
from . import rng, intersect, sampling, camera

__all__ = ["rng", "intersect", "sampling", "camera"]
