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

``normal`` and ``unit_sphere_gaussian`` (with ``log_f32`` and
``cos_f32``) are here for parity with the JAX package's API: no path of
either package calls them. ``unit_sphere_biased`` serves the reference
C CPU tier (``render_radiance(variant="cpu")``). ``log_f32`` and
``cos_f32`` follow the float32 routines of XLA's CPU backend, checked
against one jaxlib build on an x86-64 host (``tests/test_torch_rng.py``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "PCG_MULT",
    "pcg_next",
    "uniform",
    "normal",
    "sincos_2pi",
    "unit_sphere",
    "unit_sphere_gaussian",
    "unit_sphere_biased",
    "seed_state",
    "sqrt_rn",
    "log_f32",
    "cos_f32",
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


def _fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, from float32 operands: the
    product is exact in float64, the sum is rounded to float64 and then to
    float32, and the one case where rounding twice differs from rounding once
    (a float64 sum on a float32 halfway point with a nonzero remainder) is
    moved to the side of the remainder."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float64, device=a.device) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # s + err == p + c exactly (TwoSum)
    r = s.float()
    lo = torch.where(r.double() <= s, r, torch.nextafter(r, torch.full_like(r, -float("inf"))))
    hi = torch.nextafter(lo, torch.full_like(lo, float("inf")))
    tie = s == (lo.double() + hi.double()) * 0.5
    return torch.where(tie & (err > 0), hi, torch.where(tie & (err < 0), lo, r))


_LOG_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)
_MIN_NORMAL = _f32(1.17549435e-38)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log, bit for bit the JAX package's ``jnp.log`` on
    the CPU: XLA's Cephes polynomial (mantissa folded into [sqrt(1/2),
    sqrt(2)), a degree-8 polynomial in three interleaved parts), its
    multiply-adds fused as XLA emits them on an x86-64 host with FMA, and
    inputs below the smallest normal float32 taken as zero (XLA runs with
    denormals flushed), so ``-inf``. Negative inputs and NaN give NaN,
    ``+inf`` gives ``+inf``."""
    x = x.to(torch.float32)
    m = torch.clamp_min(x, _MIN_NORMAL)
    bits = m.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 0x7F).to(torch.float32)
    f = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    small = f < _SQRTHF
    f = (f - 1.0) + torch.where(small, f, 0.0)
    e = e - small.to(torch.float32)
    f2 = f * f
    f3 = f2 * f
    p = _LOG_P
    y = _fma_f32(f, p[0], p[1])
    y1 = _fma_f32(f, p[3], p[4])
    y2 = _fma_f32(f, p[6], p[7])
    y = _fma_f32(y, f, p[2])
    y1 = _fma_f32(y1, f, p[5])
    y2 = _fma_f32(y2, f, p[8])
    y = _fma_f32(y, f3, y1)
    y = _fma_f32(y, f3, y2)
    y = _fma_f32(y, f3, _LOG_Q1 * e)
    out = (f - 0.5 * f2) + y + _LOG_Q2 * e
    out = torch.where(x < _MIN_NORMAL, -float("inf"), out)
    out = torch.where(x == float("inf"), float("inf"), out)
    return torch.where((x < 0.0) | torch.isnan(x), float("nan"), out)


# glibc's single-precision cosine (the sincosf of ARM's optimized routines),
# which XLA calls for ``jnp.cos`` on the CPU: float64 reduction by pi/2 and
# float64 polynomials, rounded once to float32.
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")  # 2/pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")
_COSF_C = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"), float.fromhex("0x1.55553e1068f19p-5"),
           float.fromhex("-0x1.6c087e89a359dp-10"), float.fromhex("0x1.99343027bf8c3p-16"))
_COSF_S = (float.fromhex("-0x1.555545995a603p-3"), float.fromhex("0x1.1107605230bc4p-7"),
           float.fromhex("-0x1.994eb3774cf24p-13"))
_TOP12_PIO4 = int(np.array(np.pi / 4, np.float32).view(np.uint32)) >> 20
_TOP12_TINY = int(np.array(2.0**-12, np.float32).view(np.uint32)) >> 20


def _cosf_poly(x, x2, neg):
    x4 = x2 * x2
    c = [-v for v in _COSF_C] if neg else _COSF_C
    return (c[0] + x2 * c[1]) + x4 * c[2] + x4 * x2 * (c[3] + x2 * c[4])


def _sinf_poly(x, x2):
    x3 = x * x2
    return (x + x3 * _COSF_S[0]) + x3 * x2 * (_COSF_S[1] + x2 * _COSF_S[2])


def cos_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine, bit for bit the JAX package's ``jnp.cos`` on the CPU
    (glibc's ``cosf``) for ``|x| < 120``, the range the samplers here give
    it (``2 pi u``); a larger argument raises."""
    x = x.to(torch.float32)
    if bool((x.abs() >= 120.0).any()):
        raise ValueError("cos_f32 covers |x| < 120")
    top12 = (x.abs().view(torch.int32) >> 20) & 0x7FF
    xd = x.double()
    n = ((xd * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    r = xd - n.double() * _HPI
    sign = torch.where(((n & 3) == 1) | ((n & 3) == 2), -1.0, 1.0).double()
    rs, r2 = r * sign, r * r
    reduced = torch.where((n & 1) == 0, torch.where((n & 2) == 0, _cosf_poly(rs, r2, False),
                                                      _cosf_poly(rs, r2, True)),
                          _sinf_poly(rs, r2))
    out = torch.where(top12 < _TOP12_PIO4, _cosf_poly(xd, xd * xd, False), reduced)
    return torch.where(top12 < _TOP12_TINY, 1.0, out.float())


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


def normal(state: torch.Tensor):
    """Standard normal by Box-Muller, 2 draws: ``(new_state, value)``. The
    angle comes from the first uniform, the radius from the second, whose
    log argument is floored at ``1e-38``."""
    state, u1 = uniform(state)
    state, u2 = uniform(state)
    theta = _TWO_PI * u1
    rho = sqrt_rn(-2.0 * log_f32(torch.clamp_min(u2, _f32(1e-38))))
    return state, rho * cos_f32(theta)


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


def _normalize(v: torch.Tensor) -> torch.Tensor:
    norm = sqrt_rn(torch.clamp_min(
        (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2], _f32(1e-20)))
    return v / norm[..., None]


def unit_sphere_gaussian(state: torch.Tensor):
    """Uniform direction as three normals normalised, 6 draws: ``(new_state,
    dir (..., 3))``. The same distribution as ``unit_sphere``; kept for
    statistical tests."""
    state, x = normal(state)
    state, y = normal(state)
    state, z = normal(state)
    return state, _normalize(torch.stack([x, y, z], dim=-1))


def unit_sphere_biased(state: torch.Tensor):
    """The reference CPU tier's biased sampler, 3 draws: a uniform point of
    the cube [-1, 1]^3, normalised, so directions towards the corners are
    over-represented. The ``"cpu"`` variant of the integrator draws it."""
    state, x = uniform(state)
    state, y = uniform(state)
    state, z = uniform(state)
    return state, _normalize(torch.stack([x, y, z], dim=-1) * 2.0 - 1.0)


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
