"""Shading-direction math: reflect, refract, roughness perturbation.

Counterpart of ``path_tracer_c_tpu/ops/sampling.py``, GLSL semantics:
``reflect``/``refract`` are the built-ins' formulas with the zero vector
on total internal reflection, and roughness perturbs the normal by
``roughness * unit_sphere`` with no 0.5 factor.
"""

from __future__ import annotations

import torch

from .rng import _f32, sqrt_rn

__all__ = ["reflect", "refract", "perturb_normal"]


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _safe_normalize(v, eps=_f32(1e-20)):
    return v * torch.rsqrt(torch.clamp_min(_dot(v, v), eps))


def reflect(i, n):
    """GLSL ``reflect``: i - 2 (n.i) n."""
    return i - 2.0 * _dot(n, i) * n


def refract(i, n, eta):
    """GLSL ``refract`` with a TIR mask: ``(direction, tir)``.

    The direction is zero where ``tir`` is True. ``eta`` has shape
    (..., 1). The discarded TIR branch takes ``sqrt(1)`` and ``k`` is
    floored at 1e-12, as in the JAX package, so that its gradient slice
    can share this function.
    """
    ni = _dot(n, i)
    k = 1.0 - eta * eta * (1.0 - ni * ni)
    tir = k < 0.0
    k_safe = torch.where(tir, 1.0, torch.clamp_min(k, _f32(1e-12)))
    out = eta * i - (eta * ni + sqrt_rn(k_safe)) * n
    return torch.where(tir, 0.0, out), tir[..., 0]


def perturb_normal(normal, sphere_dir, roughness):
    """Roughness-scattered shading normal, safely normalized (the sum can
    vanish at roughness 1)."""
    return _safe_normalize(normal + roughness[..., None] * sphere_dir)
