"""Counter-based PCG random numbers on tensors.

The same stream as ``path_tracer_c_tpu/ops/rng.py``, bit for bit: PCG
with constants 747796405 / 2891336453 / 277803737, states seeded from
(global pixel, sample, root seed), uniforms as ``bits * float32(1 /
(2^32 - 1))``, and the quadrant-folded polynomial ``sincos_2pi``. The
stream is the numeric contract shared with the JAX package and the CUDA
kernel, so nothing here uses ``torch.Generator``.

A state is a uint32 value held in an int64 tensor. PyTorch's uint32
lacks ``+`` and ``>>`` on the CPU, so the arithmetic runs in int64 and
is masked to 32 bits after every multiply and add. The CUDA kernel uses
``uint32_t``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "PCG_MULT",
    "pcg_next",
    "uniform",
    "sincos_2pi",
    "unit_sphere",
    "seed_state",
    "sqrt_rn",
]

PCG_MULT = 747796405
PCG_INC = 2891336453
PCG_XSH = 277803737
_GOLDEN = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_MASK = 0xFFFFFFFF


def _f32(x) -> float:
    """A Python float holding exactly the float32 nearest to ``x``, so
    every later conversion to float32 is exact."""
    return float(np.float32(x))


# float32(1 / (2^32 - 1)) is exactly 2^-32: the scaling is a multiply of
# the one-time-rounded float32(bits), not a divide.
INV_U32_MAX = _f32(1.0 / 4294967295.0)
_TWO_PI = _f32(6.283185307179586)
_HALF_PI = _f32(1.5707963267948966)
_COS_C1 = _f32(-4.9999915618e-01)
_COS_C2 = _f32(4.1657625659e-02)
_COS_C3 = _f32(-1.3615911837e-03)
_SIN_C1 = _f32(-1.6666653296e-01)
_SIN_C2 = _f32(8.3321242496e-03)
_SIN_C3 = _f32(-1.9513782088e-04)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded.

    PyTorch's CPU float32 sqrt is accurate to about an ulp but not
    correctly rounded; the float64 root of a float32, rounded once to
    float32, is. Every plain version in this package takes its roots here
    so that it rounds as XLA and the CUDA kernel do.
    """
    return torch.sqrt(x.double()).float()


def _u32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    device = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a uint32 tensor ``a`` and a constant ``c`` that
    may reach 2^32, without int64 overflow: split ``c`` into 16-bit
    halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def pcg_next(state: torch.Tensor):
    """One PCG step: ``(new_state, random_bits)``, both uint32 in int64."""
    state = (state * PCG_MULT + PCG_INC) & _MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * PCG_XSH) & _MASK
    return state, (word >> 22) ^ word


def uniform(state: torch.Tensor):
    """Uniform float32 in [0, 1]: ``(new_state, value)``.

    int64 -> float32 rounds to nearest once, as the JAX package's direct
    uint32 -> float32 cast does.
    """
    state, bits = pcg_next(state)
    return state, bits.to(torch.float32) * INV_U32_MAX


def sincos_2pi(u: torch.Tensor):
    """(cos(2 pi u), sin(2 pi u)) by the shared polynomial: fold into the
    quadrant nearest k pi/2, evaluate the degree-6/7 polynomials on the
    residual, then swap and negate by quadrant."""
    u = u.to(torch.float32)
    k = torch.floor(u * 4.0 + 0.5)
    r = u * _TWO_PI - k * _HALF_PI
    t2 = r * r
    cosr = 1.0 + t2 * (_COS_C1 + t2 * (_COS_C2 + t2 * _COS_C3))
    sinr = r * (1.0 + t2 * (_SIN_C1 + t2 * (_SIN_C2 + t2 * _SIN_C3)))
    k4 = k - 4.0 * torch.floor(k * 0.25)
    swap = (k4 == 1.0) | (k4 == 3.0)
    a = torch.where(swap, sinr, cosr)
    b = torch.where(swap, cosr, sinr)
    neg_c = (k4 == 1.0) | (k4 == 2.0)
    neg_s = (k4 == 2.0) | (k4 == 3.0)
    return torch.where(neg_c, -a, a), torch.where(neg_s, -b, b)


def unit_sphere(state: torch.Tensor):
    """Uniform direction on the unit sphere by the cylindrical (z, phi)
    method, 2 draws: ``(new_state, dir (..., 3))``."""
    state, u1 = uniform(state)
    state, u2 = uniform(state)
    z = 1.0 - 2.0 * u1
    c, s = sincos_2pi(u2)
    r = sqrt_rn(torch.clamp_min(1.0 - z * z, 0.0))
    return state, torch.stack([r * c, r * s, z], dim=-1)


def seed_state(pixel_idx: torch.Tensor, sample_idx, root_seed) -> torch.Tensor:
    """uint32 PCG state from global (pixel, sample, seed) counters: a
    splitmix-style mix, then two PCG rounds. ``pixel_idx`` is global, so
    a pixel's stream does not depend on how the image is cut."""
    s = (
        _mul_u32(_u32(pixel_idx), _GOLDEN)
        ^ _mul_u32(_u32(sample_idx, pixel_idx), _MIX1)
        ^ _mul_u32(_u32(root_seed, pixel_idx), _MIX2)
    )
    s, _ = pcg_next(s)
    s, _ = pcg_next(s)
    return s
