"""Compute primitives: RNG, camera, intersection, sampling, and the forward
render kernel (hand-written CUDA with its plain PyTorch twin).

``render_kernel`` is imported by its users; building the CUDA library
happens on its first CUDA call, never at import.
"""
from . import rng, intersect, sampling, camera

__all__ = ["rng", "intersect", "sampling", "camera"]
