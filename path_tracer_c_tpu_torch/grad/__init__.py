"""Differentiable rendering: losses, gradients and the fits (materials,
geometry, roughness, camera)."""
from . import diff

__all__ = ["diff"]
