"""Counter-based PCG random numbers: the stream every renderer of the
port draws from, written out again in plain PyTorch.

PCG with constants 747796405 / 2891336453 / 277803737, states seeded from
(global pixel, sample, root seed) by a splitmix-style mix and two PCG
rounds, uniforms as ``bits * float32(1 / (2^32 - 1))``, and the
quadrant-folded polynomial ``sincos_2pi``. A state is a uint32 value held
in an int64 tensor, masked to 32 bits after every multiply and add.

Every floating-point result takes the dtype ``dt`` its caller names
(float32 for the reference, bfloat16 for its control), so the integer
stream is the same in both and only the arithmetic's precision differs.
"""

from __future__ import annotations

import numpy as np
import torch

PCG_MULT = 747796405
PCG_INC = 2891336453
PCG_XSH = 277803737
_GOLDEN = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_MASK = 0xFFFFFFFF


def f32(x) -> float:
    """A Python float holding exactly the float32 nearest to ``x``."""
    return float(np.float32(x))


INV_U32_MAX = f32(1.0 / 4294967295.0)
_TWO_PI = f32(6.283185307179586)
_HALF_PI = f32(1.5707963267948966)
_COS_C1 = f32(-4.9999915618e-01)
_COS_C2 = f32(4.1657625659e-02)
_COS_C3 = f32(-1.3615911837e-03)
_SIN_C1 = f32(-1.6666653296e-01)
_SIN_C2 = f32(8.3321242496e-03)
_SIN_C3 = f32(-1.9513782088e-04)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root in ``x``'s dtype: the float64 root,
    rounded once (``sqrtf`` on the card rounds so)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _u32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=like.device) & _MASK


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 without int64 overflow: ``c`` in 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def pcg_next(state: torch.Tensor):
    """One PCG step: ``(new_state, random_bits)``, both uint32 in int64."""
    state = (state * PCG_MULT + PCG_INC) & _MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * PCG_XSH) & _MASK
    return state, (word >> 22) ^ word


def uniform(state: torch.Tensor, dt=torch.float32):
    """Uniform in [0, 1] in ``dt``: ``(new_state, value)``."""
    state, bits = pcg_next(state)
    return state, bits.to(dt) * INV_U32_MAX


def sincos_2pi(u: torch.Tensor):
    """(cos(2 pi u), sin(2 pi u)) by the shared polynomial, in ``u``'s dtype."""
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


def unit_sphere(state: torch.Tensor, dt=torch.float32):
    """Uniform direction on the unit sphere (z, phi), 2 draws:
    ``(new_state, (x, y, z))``."""
    state, u1 = uniform(state, dt)
    state, u2 = uniform(state, dt)
    z = 1.0 - 2.0 * u1
    c, s = sincos_2pi(u2)
    r = sqrt_rn(torch.clamp_min(1.0 - z * z, 0.0))
    return state, (r * c, r * s, z)


def seed_state(pixel_idx: torch.Tensor, sample_idx, root_seed) -> torch.Tensor:
    """uint32 PCG state of global (pixel, sample, seed) counters."""
    s = (
        _mul_u32(_u32(pixel_idx, pixel_idx), _GOLDEN)
        ^ _mul_u32(_u32(sample_idx, pixel_idx), _MIX1)
        ^ _mul_u32(_u32(root_seed, pixel_idx), _MIX2)
    )
    s, _ = pcg_next(s)
    s, _ = pcg_next(s)
    return s
