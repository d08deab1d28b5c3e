"""Differentiable rendering: losses, gradients and the material fit."""
from . import diff

__all__ = ["diff"]
