"""Compute primitives: RNG, camera, intersection, sampling, the forward
render kernel and the fused primal + Jacobian kernel (hand-written CUDA,
each with its plain PyTorch twin).

``render_kernel`` and ``render_grad`` are imported by their users; building
the CUDA library happens on the first CUDA call, never at import.
"""
from . import rng, intersect, sampling, camera

__all__ = ["rng", "intersect", "sampling", "camera"]
