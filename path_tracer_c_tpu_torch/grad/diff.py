"""Differentiable rendering: losses, gradients, the inverse-rendering fits.

Counterpart of ``path_tracer_c_tpu/grad/diff.py``. How the reference
tier's estimator stays differentiable:

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

The physical tier (``models/physical.py``) does touch geometry, roughness
and the camera continuously: its light samples carry cosine and
solid-angle factors, and its lobe choice has a score function. The
geometry, roughness and camera fits below run on it.

Engines of the reference tier: ``"cuda"`` is
``ops.render_grad.render_kernel_vjp`` (the fused kernel and its
contraction; their plain twin on CPU tensors), ``"core"`` is
``torch.autograd`` through the eager integrator. ``"auto"`` and the JAX
package's ``"pallas"`` mean ``"cuda"``: the kernel has no tile rule, so no
image size falls back to the slow path.

Engines of the physical tier, under the names the JAX package gives them
at these entry points: ``"physical"`` is ``torch.autograd`` through the
eager physical tier (complete interior gradients, slow), and
``"physical_pallas"`` is ``ops.render_physical_grad.render_physical_kernel_vjp``
(the fused physical kernel and its contraction; their plain twin on CPU
tensors). ``"physical_core"`` means ``"physical"``. This differs from the
command line's ``render --engine physical``, which is the forward kernel:
a render has no gradient to take through the eager tier.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..models.integrator import render_radiance
from ..models.physical import render_physical
from ..ops.camera import Camera
from ..ops.render_grad import render_kernel_vjp, replace_leaves, zeros_like_scene
from ..ops.render_physical import (
    live_emitter_mask, live_tri_emitter_mask, render_physical_kernel,
)
from ..ops.render_physical_grad import render_physical_kernel_vjp
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
    "make_geometry_params",
    "apply_geometry_params",
    "geometry_params_from_arrays",
    "geometry_params_to_arrays",
    "fit_geometry",
    "fit_camera",
]

_PHYSICAL = ("physical", "physical_pallas")


def mse_loss(img, target):
    """Mean squared pixel error, the inverse-rendering objective."""
    return torch.mean((img - target) ** 2)


def _resolve_engine(engine: str) -> str:
    if engine in ("auto", "pallas"):
        return "cuda"
    if engine == "physical_core":
        return "physical"
    if engine not in ("cuda", "core") + _PHYSICAL:
        raise ValueError(f"unknown engine {engine!r}; available: cuda, core, auto, "
                         "physical, physical_pallas")
    return engine


def render_loss(
    scene: Scene, target, camera, height, width, spp, max_bounces, seed,
    engine: str = "auto",
    rough_grad: bool = False,
):
    """Differentiable pixel loss of a render against ``target`` (H, W, 3).
    ``engine``: see the module docstring. The physical engines render
    without jitter; ``"physical_pallas"`` asks its kernel for no geometry
    planes (a material objective does not read them). ``rough_grad=True``
    (physical engines only) turns on the score-function roughness
    gradient: the image does not change."""
    engine = _resolve_engine(engine)
    if rough_grad and engine not in _PHYSICAL:
        raise ValueError(
            "rough_grad requires a physical engine (the score-function roughness "
            f"estimator lives in the physical tier); got engine={engine!r}. The "
            "reference tier keeps roughness detached by contract.")
    if engine == "physical_pallas":
        img = render_physical_kernel_vjp(
            scene, camera, height, width, spp, max_bounces, seed,
            jitter=False, geom=False, rough_grad=rough_grad)
    elif engine == "physical":
        img = render_physical(
            scene, camera, height, width, spp, max_bounces, seed,
            jitter=False, rough_grad=rough_grad)
    else:
        render = render_kernel_vjp if engine == "cuda" else render_radiance
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


def make_material_params(scene: Scene, include_roughness: bool = False) -> dict:
    """Unconstrained optimization variables of a scene's materials, as a
    dict of new leaf tensors that require a gradient.
    ``include_roughness=True`` adds a roughness logit (mapped by a sigmoid,
    so it stays in (0, 1)): pair it with a ``rough_grad=True`` fit, since
    roughness is otherwise detached in every tier."""
    m = scene.materials
    with torch.no_grad():
        params = {
            "albedo_logit": _logit(m.albedo),
            "emission_color_logit": _logit(m.emission_color),
            "emission_strength_raw": _inv_softplus(m.emission_strength),
        }
        if include_roughness:
            params["roughness_logit"] = _logit(m.roughness)
    return {k: v.requires_grad_() for k, v in params.items()}


def apply_material_params(scene: Scene, params) -> Scene:
    """Scene with materials replaced by the constrained mapping of params."""
    m = dataclasses.replace(
        scene.materials,
        albedo=torch.sigmoid(params["albedo_logit"]),
        emission_color=torch.sigmoid(params["emission_color_logit"]),
        emission_strength=F.softplus(params["emission_strength_raw"]),
    )
    if "roughness_logit" in params:
        m = dataclasses.replace(m, roughness=torch.sigmoid(params["roughness_logit"]))
    return dataclasses.replace(scene, materials=m)


def material_params_from_arrays(arrays: dict, device) -> dict:
    """Optimization variables from numpy arrays under the names of
    ``make_material_params`` (how the JAX package's variables cross over)."""
    return {k: torch.tensor(v, dtype=torch.float32, device=device).requires_grad_()
            for k, v in arrays.items()}


def material_params_to_arrays(params: dict) -> dict:
    """The optimization variables as numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


# Geometry variables cross over the same way, under the names of
# ``make_geometry_params``.
geometry_params_from_arrays = material_params_from_arrays
geometry_params_to_arrays = material_params_to_arrays


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
    rough_grad: bool = False,
):
    """Recover albedo and emission from a target image.

    Adam in the unconstrained space (the update of ``optax.adam``: betas
    0.9 and 0.999, eps 1e-8 outside the root), with a fresh RNG seed per
    step so that the gradient is an unbiased estimate over sample paths.
    ``engine`` selects the differentiable render (module docstring).
    ``params`` starts the fit from given variables (as
    ``make_material_params`` makes them) instead of ``scene_init``'s.
    ``callback(i, loss)`` sees every step. ``rough_grad=True`` also fits
    roughness, by the score-function estimator (physical engines only; the
    kernel engine emits it as three more Jacobian planes per material). That
    term has more variance than the smooth material gradients, so prefer
    more spp or a lower ``lr`` where roughness dominates. Returns ``(scene,
    losses)``.
    """
    engine = _resolve_engine(engine)
    if rough_grad and engine not in _PHYSICAL:
        raise ValueError("fit_materials(rough_grad=True) requires a physical engine "
                         f"(got {engine!r}): see render_loss")
    if params is None:
        params = make_material_params(scene_init, include_roughness=rough_grad)

    def loss_fn(seed):
        return render_loss(
            apply_material_params(scene_init, params), target, camera, height,
            width, spp, max_bounces, seed, engine=engine, rough_grad=rough_grad)

    losses = _run_fit_loop(_adam_step(params, lr, loss_fn), steps, seed0, callback)
    with torch.no_grad():
        fitted = apply_material_params(scene_init, params)
    return fitted, losses


def _adam_step(params: dict, lr: float, loss_fn):
    """One optimizer step as ``step(seed) -> loss``: Adam as ``optax.adam``
    updates (betas 0.9 and 0.999, eps 1e-8 outside the root) on the
    gradient of ``loss_fn(seed)`` with respect to ``params``."""
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(seed):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(seed)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


# -- geometry recovery (physical tier) ---------------------------------------
#
# The reference shading model is piecewise constant in geometry (module
# docstring), so geometry fits run the physical tier.


def _index_tuple(indices) -> tuple:
    """Indices as a tuple of ints, read once: a generator survives it."""
    return tuple(int(i) for i in indices)


def make_geometry_params(scene: Scene, sphere_indices, triangle_indices=()) -> dict:
    """Unconstrained optimization variables of selected geometry, as new
    leaf tensors that require a gradient: ``center`` and ``radius_raw`` (the
    inverse softplus of the radius, so the radius stays positive) of the
    spheres, and, where ``triangle_indices`` is not empty, ``tri_v``: the
    triangles' vertices stacked as ``(T_sel, 3 vertices, 3)``."""
    sphere_indices, triangle_indices = _index_tuple(sphere_indices), _index_tuple(triangle_indices)
    dev = scene.device
    params = {}
    with torch.no_grad():
        if sphere_indices:
            idx = torch.tensor(sphere_indices, dtype=torch.long, device=dev)
            params["center"] = scene.spheres.center[idx].clone()
            params["radius_raw"] = _inv_softplus(scene.spheres.radius[idx])
        if triangle_indices:
            tidx = torch.tensor(triangle_indices, dtype=torch.long, device=dev)
            tri = scene.triangles
            params["tri_v"] = torch.stack([tri.v0[tidx], tri.v1[tidx], tri.v2[tidx]], dim=1)
    return {k: v.requires_grad_() for k, v in params.items()}


def apply_geometry_params(scene: Scene, params, sphere_indices, triangle_indices=()) -> Scene:
    """Scene with the selected spheres and triangles replaced by the mapping
    of ``params``."""
    dev = scene.device
    if "center" in params:
        idx = torch.tensor(_index_tuple(sphere_indices), dtype=torch.long, device=dev)
        sph = scene.spheres
        scene = dataclasses.replace(scene, spheres=dataclasses.replace(
            sph,
            center=sph.center.index_copy(0, idx, params["center"]),
            radius=sph.radius.index_copy(0, idx, F.softplus(params["radius_raw"]))))
    if "tri_v" in params:
        tidx = torch.tensor(_index_tuple(triangle_indices), dtype=torch.long, device=dev)
        tri, tv = scene.triangles, params["tri_v"]
        scene = dataclasses.replace(scene, triangles=dataclasses.replace(
            tri, v0=tri.v0.index_copy(0, tidx, tv[:, 0]), v1=tri.v1.index_copy(0, tidx, tv[:, 1]),
            v2=tri.v2.index_copy(0, tidx, tv[:, 2])))
    return scene


def fit_geometry(
    scene_init: Scene,
    target,
    camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    sphere_indices=(0,),
    steps: int = 100,
    lr: float = 0.02,
    seed0: int = 0,
    callback=None,
    engine: str = "physical",
    triangle_indices=(),
    tri_nee: bool | None = None,
    params: dict | None = None,
):
    """Recover geometry (sphere centre and radius, triangle vertices, or
    both) from a target image, on the physical tier, without jitter.

    ``engine="physical"`` (the default) is autograd through the eager tier:
    complete interior gradients. ``engine="physical_pallas"`` is the fused
    physical kernel, whose geometry gradients carry the light sample's
    chains only (a sphere's centre and radius through the cone weight, a
    triangle's vertices through the area weight): right where the fitted
    geometry belongs to the emitters, as in the recovery of a light. Fitting
    geometry that is no light-sampled emitter under this engine warns: its
    gradient is exactly zero. The emitter caps are sized to the scene's live
    emitter counts, so no light silently freezes. ``tri_nee`` defaults to
    True when triangles are fitted (their chain only exists in the
    ``tri_nee`` estimator). ``params`` starts the fit from given variables
    (as ``make_geometry_params`` makes them). Gradients are interior ones in
    both engines: silhouettes are not modelled. Returns ``(scene, losses)``.
    """
    engine = _resolve_engine(engine)
    if engine not in _PHYSICAL:
        raise ValueError(f"fit_geometry runs on a physical engine, not {engine!r}: the "
                         "reference tier is piecewise constant in geometry")
    sphere_indices, triangle_indices = _index_tuple(sphere_indices), _index_tuple(triangle_indices)
    if tri_nee is None:
        tri_nee = bool(triangle_indices)
    n_em_cap = tri_em_cap = 0
    if engine == "physical_pallas":
        em = live_emitter_mask(scene_init)
        n_em_cap = max(int(em.sum()), 1)
        em_t = live_tri_emitter_mask(scene_init)
        tri_em_cap = max(int(em_t.sum()), 1) if tri_nee else 0
        what = []
        non_em = [i for i in sphere_indices if not em[i]]
        if non_em:
            what.append(f"spheres {non_em}")
        non_em_t = [i for i in triangle_indices if not (tri_nee and em_t[i])]
        if non_em_t:
            what.append(f"triangles {non_em_t}" + ("" if tri_nee else " (tri_nee is off)"))
        if what:
            warnings.warn(
                f"fit_geometry(engine='physical_pallas'): {' and '.join(what)} are not "
                "light-sampled emitters: the fused kernel's geometry cotangent carries "
                "only the NEE emitter chains, so their gradients are exactly zero and "
                "they will not move. Use engine='physical' (autograd through the eager "
                "tier) for non-emitter geometry.", stacklevel=2)
    if params is None:
        params = make_geometry_params(scene_init, sphere_indices, triangle_indices)

    def loss_fn(seed):
        scene = apply_geometry_params(scene_init, params, sphere_indices, triangle_indices)
        if engine == "physical_pallas":
            img = render_physical_kernel_vjp(
                scene, camera, height, width, spp, max_bounces, seed, nee=True, jitter=False,
                n_em_cap=n_em_cap, tri_nee=tri_nee, tri_em_cap=tri_em_cap)
        else:
            img = render_physical(scene, camera, height, width, spp, max_bounces, seed,
                                  nee=True, jitter=False, tri_nee=tri_nee)
        return mse_loss(img, target)

    losses = _run_fit_loop(_adam_step(params, lr, loss_fn), steps, seed0, callback)
    with torch.no_grad():
        fitted = apply_geometry_params(scene_init, params, sphere_indices, triangle_indices)
    return fitted, losses


# -- camera recovery (physical tier) -------------------------------------------
#
# The fused physical kernel's camera cotangent is zero by contract, so a
# camera fit through engine="physical_pallas" would silently not move.


def fit_camera(
    scene: Scene,
    target,
    camera_init,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    steps: int = 50,
    lr: float = 0.02,
    seed0: int = 0,
    callback=None,
    engine: str = "physical",
    fd_eps: float = 1e-3,
    fov_deg: float | None = None,
):
    """Recover the camera's pose (origin and look-at target, 6 scalars)
    from a target image, on the physical tier, without jitter.

    ``engine="physical"`` (the default): autograd through the eager tier,
    exact interior gradients. ``engine="physical_fd"``: central finite
    differences over the 6 scalars, every loss through the forward kernel
    (``render_physical_kernel``): 13 renders a step, with one seed per step
    so that the differences see the same paths. ``engine="physical_pallas"``
    raises: that gradient's camera cotangent is zero by contract, and a fit
    that silently does not move must not be constructible. The field of view
    and the up hint come from ``camera_init`` unless ``fov_deg`` is given.
    The pose landscape is steep and narrow, and Adam overshoots: the pose
    with the least loss seen is returned, not the last. Returns ``(camera,
    losses)``.
    """
    if engine == "physical_pallas":
        raise ValueError(
            "fit_camera(engine='physical_pallas') would silently not move: the fused "
            "physical kernel's camera cotangents are zero by contract (see "
            "render_physical_kernel_vjp). Use engine='physical' (autograd through the "
            "eager tier) or engine='physical_fd' (finite differences over the forward "
            "kernel).")
    if engine not in ("physical", "physical_fd"):
        raise ValueError(f"unknown fit_camera engine {engine!r}")
    dev = scene.device
    with torch.no_grad():
        o0 = camera_init.origin.to(torch.float32).clone()
        fwd = camera_init.forward
        t0 = o0 + fwd / torch.clamp_min(torch.linalg.norm(fwd), 1e-8)
    params = {"origin": o0.requires_grad_(), "target": t0.requires_grad_()}
    if fov_deg is None:
        fov_deg = float(np.rad2deg(camera_init.fov.cpu().numpy()))
    up_hint = tuple(camera_init.up.cpu().numpy().astype(np.float32))

    def cam_of(origin, look):
        return Camera.look_at(origin, look, dev, up=up_hint, fov_deg=fov_deg)

    if engine == "physical":
        def loss_fn(seed):
            img = render_physical(scene, cam_of(params["origin"], params["target"]), height,
                                  width, spp, max_bounces, seed, jitter=False)
            return mse_loss(img, target)
    else:
        def loss_val(flat, seed):
            img = render_physical_kernel(scene, cam_of(flat[:3], flat[3:]), height, width,
                                         spp, max_bounces, seed, jitter=False)
            return mse_loss(img, target)

        def loss_fn(seed):
            # The loss at the pose, carrying the finite-difference gradient:
            # backward() hands it to the two variables.
            with torch.no_grad():
                flat = torch.cat([params["origin"], params["target"]])
                base = loss_val(flat, seed)
                grads = []
                for i in range(flat.shape[0]):
                    e = torch.zeros_like(flat)
                    e[i] = fd_eps
                    grads.append((loss_val(flat + e, seed) - loss_val(flat - e, seed))
                                 / (2.0 * fd_eps))
                grad = torch.stack(grads)
            both = torch.cat([params["origin"], params["target"]])
            return base + torch.sum((both - both.detach()) * grad)

    adam = _adam_step(params, lr, loss_fn)
    # The least loss seen and the pose that gave it, kept on the device.
    best = {"loss": torch.full((), float("inf"), device=dev),
            "pose": {k: v.detach().clone() for k, v in params.items()}}

    def step(seed):
        pose = {k: v.detach().clone() for k, v in params.items()}
        loss = adam(seed)
        better = loss < best["loss"]
        best["pose"] = {k: torch.where(better, pose[k], best["pose"][k]) for k in pose}
        best["loss"] = torch.minimum(best["loss"], loss)
        return loss

    losses = _run_fit_loop(step, steps, seed0, callback)
    pose = best["pose"]
    with torch.no_grad():
        return cam_of(pose["origin"], pose["target"]), losses
