"""Differentiable rendering: losses, gradients, the inverse-rendering fit.

Counterpart of ``path_tracer_c_tpu/grad/diff.py`` for the reference tier.
How the estimator stays differentiable:

* every RNG decision is detached by construction: PCG states are integers,
  and the branch between reflection and refraction compares against the
  detached transparency while a ratio factor re-attaches its derivative
  (``models/integrator.py``);
* material gradients (albedo, emission, transparency, sky) flow through
  the product chain of throughput and emission;
* geometry, roughness, refractive index and the camera enter the radiance
  through discrete path events only (no cosine, no 1/r^2), so away from
  visibility edges their true gradient is zero, and every engine returns
  zero for them.

A fixed seed makes a render deterministic, so two engines' gradients are
compared path for path, not statistically.

Engines: ``"cuda"`` is ``ops.render_grad.render_kernel_vjp`` (the fused
kernel and its contraction; their plain twin on CPU tensors), ``"core"``
is ``torch.autograd`` through the eager integrator. ``"auto"`` and the JAX
package's ``"pallas"`` mean ``"cuda"``: the kernel has no tile rule, so no
image size falls back to the slow path.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..models.integrator import render_radiance
from ..ops.render_grad import render_kernel_vjp, replace_leaves, zeros_like_scene
from ..scene.scene import Scene

__all__ = [
    "mse_loss",
    "render_loss",
    "loss_and_grad",
    "make_material_params",
    "apply_material_params",
    "material_params_from_arrays",
    "material_params_to_arrays",
    "fit_materials",
]

_NOT_PORTED = "is not ported to PyTorch yet: see ROADMAP.md A9, second half (B4, B5)"


def mse_loss(img, target):
    """Mean squared pixel error, the inverse-rendering objective."""
    return torch.mean((img - target) ** 2)


def _resolve_engine(engine: str) -> str:
    if engine in ("physical", "physical_pallas", "physical_core"):
        raise NotImplementedError(f"the gradient of engine {engine!r} {_NOT_PORTED}")
    if engine in ("auto", "pallas"):
        return "cuda"
    if engine not in ("cuda", "core"):
        raise ValueError(f"unknown engine {engine!r}; available: cuda, core, auto")
    return engine


def render_loss(
    scene: Scene, target, camera, height, width, spp, max_bounces, seed,
    engine: str = "auto",
    rough_grad: bool = False,
):
    """Differentiable pixel loss of a render against ``target`` (H, W, 3).
    ``engine``: see the module docstring. ``rough_grad`` belongs to the
    physical tier and is refused by name."""
    if rough_grad:
        raise NotImplementedError(f"rough_grad {_NOT_PORTED}")
    render = render_kernel_vjp if _resolve_engine(engine) == "cuda" else render_radiance
    img = render(scene, camera, height, width, spp, max_bounces, seed)
    return mse_loss(img, target)


def _float_leaves(scene: Scene):
    """``(table or None, field, tensor)`` of every floating-point leaf."""
    out = []
    for table in ("materials", "spheres", "triangles"):
        tab = getattr(scene, table)
        for f in dataclasses.fields(tab):
            t = getattr(tab, f.name)
            if t.is_floating_point():
                out.append((table, f.name, t))
    out.append((None, "sky_color", scene.sky_color))
    return out


def loss_and_grad(scene, target, camera, height, width, spp, max_bounces,
                  seed, engine: str = "auto"):
    """``(loss, d loss / d scene)``: the gradient is a ``Scene`` with one
    tensor per leaf. Leaves the loss does not depend on (and the integer
    and bool leaves) get zeros."""
    names = _float_leaves(scene)
    leaves = [t.detach().requires_grad_() for _, _, t in names]
    live = replace_leaves(scene, [(tb, nm, t) for (tb, nm, _), t in zip(names, leaves)])
    loss = render_loss(live, target, camera, height, width, spp, max_bounces, seed,
                       engine=engine)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    d_scene = replace_leaves(zeros_like_scene(scene), [
        (tb, nm, g) for (tb, nm, _), g in zip(names, grads) if g is not None])
    return loss.detach(), d_scene


# -- constrained material parameterization ----------------------------------
#
# Optimizing raw scene leaves can leave the physical domain (albedo outside
# [0, 1], negative emission). The fit runs in an unconstrained space and maps
# back smoothly: albedo and emission colour via a sigmoid of logits, emission
# strength via softplus.

_EPS = 1e-6


def _logit(p):
    p = torch.clamp(p, _EPS, 1.0 - _EPS)
    return torch.log(p) - torch.log1p(-p)


def _inv_softplus(y):
    y = torch.clamp_min(y, _EPS)
    return y + torch.log(-torch.expm1(-y))


def make_material_params(scene: Scene) -> dict:
    """Unconstrained optimization variables of a scene's materials, as a
    dict of new leaf tensors that require a gradient."""
    m = scene.materials
    with torch.no_grad():
        params = {
            "albedo_logit": _logit(m.albedo),
            "emission_color_logit": _logit(m.emission_color),
            "emission_strength_raw": _inv_softplus(m.emission_strength),
        }
    return {k: v.requires_grad_() for k, v in params.items()}


def apply_material_params(scene: Scene, params) -> Scene:
    """Scene with materials replaced by the constrained mapping of params."""
    m = dataclasses.replace(
        scene.materials,
        albedo=torch.sigmoid(params["albedo_logit"]),
        emission_color=torch.sigmoid(params["emission_color_logit"]),
        emission_strength=F.softplus(params["emission_strength_raw"]),
    )
    return dataclasses.replace(scene, materials=m)


def material_params_from_arrays(arrays: dict, device) -> dict:
    """Optimization variables from numpy arrays under the names of
    ``make_material_params`` (how the JAX package's variables cross over)."""
    return {k: torch.tensor(v, dtype=torch.float32, device=device).requires_grad_()
            for k, v in arrays.items()}


def material_params_to_arrays(params: dict) -> dict:
    """The optimization variables as numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _run_fit_loop(step_fn, steps, seed0, callback):
    """The optimizer loop. Per-step seeds are step-indexed
    (``seed0 + i + 1``), so a run resumed at step ``i`` replays the seeds an
    uninterrupted run would have used. Losses stay on the device until the
    end unless a callback wants each one, so the host does not wait for
    the device every step."""
    losses = []
    for i in range(steps):
        loss = step_fn((seed0 + i + 1) & 0xFFFFFFFF)
        if callback is not None:
            loss = float(loss)
            callback(i, loss)
        losses.append(loss)
    if losses and callback is None:
        losses = torch.stack(losses).tolist()
    return losses


def fit_materials(
    scene_init: Scene,
    target,
    camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    steps: int = 100,
    lr: float = 0.05,
    seed0: int = 0,
    callback=None,
    engine: str = "auto",
    params: dict | None = None,
):
    """Recover albedo and emission from a target image.

    Adam in the unconstrained space (the update of ``optax.adam``: betas
    0.9 and 0.999, eps 1e-8 outside the root), with a fresh RNG seed per
    step so that the gradient is an unbiased estimate over sample paths.
    ``engine`` selects the differentiable render (module docstring).
    ``params`` starts the fit from given variables (as
    ``make_material_params`` makes them) instead of ``scene_init``'s.
    ``callback(i, loss)`` sees every step. Returns ``(scene, losses)``.
    """
    engine = _resolve_engine(engine)
    if params is None:
        params = make_material_params(scene_init)
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(seed):
        opt.zero_grad(set_to_none=True)
        loss = render_loss(
            apply_material_params(scene_init, params), target, camera, height,
            width, spp, max_bounces, seed, engine=engine)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = _run_fit_loop(step, steps, seed0, callback)
    with torch.no_grad():
        fitted = apply_material_params(scene_init, params)
    return fitted, losses
