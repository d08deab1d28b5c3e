"""The plain reference of a material fit's first steps: the arithmetic of
inverse rendering written out again from the benchmark's own tables.

A fit recovers every material's albedo and emission from a target image.
Its variables are unconstrained: albedo and emission colour as logits
(mapped back by a sigmoid), emission strength through the inverse of
softplus. Each step renders the scene at the step's seed (``seed0 + i +
1``) with the image's Jacobian (``tracer.render_fused``), takes the mean
squared pixel error against the target, contracts the Jacobian with the
image's cotangent and updates the variables by Adam (betas 0.9 and 0.999,
eps 1e-8 outside the root, bias-corrected as ``optax.adam``).

``follow`` runs the first steps and returns what the benchmark compares:
each step's loss, the first gradient of every variable, and the variables
before and after the steps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import tracer

_EPS = 1e-6
VARIABLES = ("albedo_logit", "emission_color_logit", "emission_strength_raw")


def _logit(p):
    p = torch.clamp(p, _EPS, 1.0 - _EPS)
    return torch.log(p) - torch.log1p(-p)


def _inv_softplus(y):
    y = torch.clamp_min(y, _EPS)
    return y + torch.log(-torch.expm1(-y))


def variables(scene: dict) -> dict:
    """The unconstrained variables of a scene's materials."""
    m = scene["materials"]
    return {"albedo_logit": _logit(m["albedo"]),
            "emission_color_logit": _logit(m["emission_color"]),
            "emission_strength_raw": _inv_softplus(m["emission_strength"])}


class _Render(torch.autograd.Function):
    """The image of ``tracer.render_fused``; its backward contracts the
    Jacobian with the image's cotangent ``g``:
    d albedo[m, c] = sum_p g[p, c] A[m, c, p] / spp, and through the
    emission planes S the emission colour (times the strength) and the
    strength (summed against the colour)."""

    @staticmethod
    def forward(ctx, albedo, emission_color, emission_strength, scene, cam, shape, seed):
        mats = {**scene["materials"], "albedo": albedo, "emission_color": emission_color,
                "emission_strength": emission_strength}
        height, width, spp, max_bounces = shape
        img, jac = tracer.render_fused({**scene, "materials": mats}, cam, height, width, spp,
                                       max_bounces, seed)
        ctx.save_for_backward(jac, emission_color, emission_strength)
        ctx.spp = spp
        return img

    @staticmethod
    def backward(ctx, g):
        jac, emission_color, emission_strength = ctx.saved_tensors
        n_mat = emission_strength.shape[0]
        hw = jac.shape[1] * jac.shape[2]
        gp = g.permute(2, 0, 1).reshape(3, hw)
        planes = jac[: 9 * n_mat].reshape(n_mat, 3, 3, hw)  # material, kind, colour, pixel
        w = torch.einsum("mkcp,cp->mkc", planes, gp) / ctx.spp
        d_albedo = w[:, 0]
        d_color = w[:, 1] * emission_strength[:, None]
        d_strength = (w[:, 1] * emission_color).sum(1)
        return d_albedo, d_color, d_strength, None, None, None, None


def follow(true_tables: dict, init_tables: dict, cam_arrays: dict, shape, seed0: int,
           target_seed: int, steps: int = 3, lr: float = 0.05, device="cpu",
           dt=torch.float32, loss=None) -> dict:
    """The first ``steps`` steps of a fit from ``init_tables`` towards the
    image of ``true_tables`` rendered at ``target_seed`` (the reference
    tier's forward estimator, no jitter). Returns ``losses`` (one a step),
    ``grad`` (the first step's gradient of each variable), ``start`` and
    ``end`` (the variables before the first step and after the last), all
    as float64 on the CPU. ``loss(img, target)`` replaces the mean
    squared error (the controls plant a fault there)."""
    height, width, spp, max_bounces = shape
    cam = tracer.camera_tensors(cam_arrays, device, dt)
    target = tracer.render_forward(tracer.tensors(true_tables, device, dt), cam, height, width,
                                   spp, max_bounces, target_seed)
    scene = tracer.tensors(init_tables, device, dt)
    var = {k: v.detach().clone().requires_grad_() for k, v in variables(scene).items()}
    start = {k: v.detach().double().cpu() for k, v in var.items()}
    m = {k: torch.zeros_like(v) for k, v in var.items()}
    v2 = {k: torch.zeros_like(v) for k, v in var.items()}
    losses, first = [], None
    for i in range(steps):
        img = _Render.apply(torch.sigmoid(var["albedo_logit"]),
                            torch.sigmoid(var["emission_color_logit"]),
                            F.softplus(var["emission_strength_raw"]), scene, cam, shape,
                            (seed0 + i + 1) & 0xFFFFFFFF)
        value = torch.mean((img - target) ** 2) if loss is None else loss(img, target)
        grads = dict(zip(VARIABLES, torch.autograd.grad(value, [var[k] for k in VARIABLES])))
        losses.append(float(value.detach()))
        if first is None:
            first = {k: g.detach().double().cpu() for k, g in grads.items()}
        t = i + 1
        with torch.no_grad():
            for k, g in grads.items():
                m[k] = 0.9 * m[k] + 0.1 * g
                v2[k] = 0.999 * v2[k] + 0.001 * g * g
                m_hat = m[k] / (1.0 - 0.9 ** t)
                v_hat = v2[k] / (1.0 - 0.999 ** t)
                var[k] -= lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
    end = {k: v.detach().double().cpu() for k, v in var.items()}
    return {"losses": losses, "grad": first, "start": start, "end": end}
