"""Sharded rendering and training steps over a device mesh.

Counterpart of ``path_tracer_c_tpu/parallel/render.py``. Image row blocks
shard over the mesh's ``tile`` axis and Monte-Carlo sample ranges over its
``spp`` axis; the scene is copied to every device of a slot. Each slot
renders its block of rows, at its sample offset, with the engine's own
renderer (a hand kernel for the kernel engines): row blocks and sample
offsets are arguments of every renderer, and RNG streams key on global
pixel and sample indices, so a slot's image is the same rows of an
unsharded render of its samples.

The reduction is in a fixed order, the JAX package's ``pmean`` without its
freedom of order: for each row block the slots' images are summed in
ascending ``spp`` index on one device, then divided by the ``spp`` axis's
size, and the row blocks are concatenated in ``tile`` order. Across
processes the slots' images are first gathered (``all_gather``), never
``all_reduce``d, so every process computes the same sum in the same order:
the result is the same bits on every rank, in every run, as in one process.

Determinism, then: with no ``spp`` split the sharded image equals the
unsharded one bit for bit; with one it differs only by the association of
the sample mean (float32 rounding).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .distributed import _collective_device
from .mesh import SPP_AXIS, TILE_AXIS, Mesh

__all__ = ["render_sharded", "make_train_step", "replicate_scene"]

ENGINES = ("core", "pallas", "cuda", "physical", "physical_pallas")
_PHYSICAL = ("physical", "physical_pallas")


def _to(x, device):
    """A scene or camera (dataclasses of tensors) on ``device``. ``Tensor.to``
    is differentiable, so gradients flow back to the original."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(
            x, **{f.name: _to(getattr(x, f.name), device) for f in dataclasses.fields(x)})
    return x


def replicate_scene(scene, mesh: Mesh) -> dict:
    """The scene on every device of this process's slots: ``{device:
    scene}``, the scene itself where it already lies there. The copies are
    differentiable: a gradient through any of them reaches ``scene``."""
    return {d: (scene if d == scene.device else _to(scene, d))
            for d in dict.fromkeys(s.device for _, _, s in mesh.local())}


def _check_divisible(height, spp, mesh):
    n_tile = mesh.shape[TILE_AXIS]
    n_spp = mesh.shape[SPP_AXIS]
    if height % n_tile:
        raise ValueError(f"height {height} not divisible by tile axis {n_tile}")
    if spp % n_spp:
        raise ValueError(f"spp {spp} not divisible by spp axis {n_spp}")
    return height // n_tile, spp // n_spp


def _slot_renderer(engine, height, width, spp_local, max_bounces, jitter, remat, geom,
                   n_em_cap, tri_nee, tri_em_cap, rough_grad):
    """``render(scene, camera, seed, row_start, rows, sample_offset)`` of one slot
    by ``engine``: ``core`` the eager integrator; ``pallas`` or ``cuda``
    the reference tier's kernel (B1, and under autograd the fused kernel
    B2); ``physical`` the eager physical tier; ``physical_pallas`` the
    physical kernel (B3, and under autograd the fused kernel B4)."""
    if tri_nee and engine not in _PHYSICAL:
        raise ValueError(
            f"tri_nee requires a physical engine, got engine={engine!r} "
            "(the reference tier has no light-sampling pool)"
        )
    if rough_grad and engine not in _PHYSICAL:
        raise ValueError(f"rough_grad requires a physical engine, got engine={engine!r}")
    if engine == "core":
        from ..models.integrator import render_tile as fn

        kw = dict(jitter=jitter, remat=remat)
    elif engine in ("pallas", "cuda"):
        from ..ops.render_grad import render_kernel_vjp as fn

        kw = dict(jitter=jitter)
    elif engine == "physical":
        from ..models.physical import render_physical as fn

        kw = dict(jitter=jitter, remat=remat, tri_nee=tri_nee, rough_grad=rough_grad)
    elif engine == "physical_pallas":
        from ..ops.render_physical_grad import render_physical_kernel_vjp as fn

        # geom=False: a material fit skips the geometry planes; a geometry
        # fit opts in (the planes are as in the unsharded render).
        kw = dict(jitter=jitter, geom=geom, n_em_cap=n_em_cap, tri_nee=tri_nee,
                  tri_em_cap=tri_em_cap, rough_grad=rough_grad)
    else:
        raise ValueError(f"unknown engine {engine!r}")

    def render(scene, camera, seed, row_start, rows, sample_offset):
        return fn(scene, camera, height, width, spp_local, max_bounces, seed,
                  sample_offset=sample_offset, row_start=row_start, rows=rows, **kw)

    return render


def _by_rank(mesh: Mesh) -> list:
    """The ``(ti, si)`` of each process's slots, in slot order, by rank."""
    ranks = [[] for _ in range(max(s.rank for _, _, s in mesh.flat()) + 1)]
    for ti, si, s in mesh.flat():
        ranks[s.rank].append((ti, si))
    return ranks


def _gather(local: dict, mesh: Mesh) -> dict:
    """Every slot's tensor on every process: this process's own (``local``,
    by ``(ti, si)``, all of one shape and on one device) as they are, the
    others' from one ``all_gather`` of each process's stack (padded to the
    most slots a process owns), detached."""
    if mesh.processes == 1:
        return dict(local)
    ranks = _by_rank(mesh)
    mine = ranks[mesh.rank]
    first = local[mine[0]]
    most = max(len(r) for r in ranks)
    stack = torch.zeros((most,) + tuple(first.shape), dtype=first.dtype,
                        device=_collective_device(first.device))
    for j, key in enumerate(mine):
        stack[j] = local[key].detach()
    parts = [torch.empty_like(stack) for _ in ranks]
    dist.all_gather(parts, stack)
    out = {}
    for r, keys in enumerate(ranks):
        for j, key in enumerate(keys):
            out[key] = local[key] if r == mesh.rank else parts[r][j].to(first.device)
    return out


def _assemble(images: dict, mesh: Mesh):
    """The (H, W, 3) image from this process's slot images (by ``(ti,
    si)``): gathered across processes, summed over ``spp`` in ascending
    order and divided by its size, then concatenated over ``tile``, on the
    device of this process's first slot."""
    out = mesh.local()[0][2].device
    images = _gather({k: v.to(out) for k, v in images.items()}, mesh)
    n_tile, n_spp = mesh.shape[TILE_AXIS], mesh.shape[SPP_AXIS]
    blocks = []
    for ti in range(n_tile):
        acc = images[(ti, 0)]
        for si in range(1, n_spp):
            acc = acc + images[(ti, si)]
        blocks.append(acc / n_spp)
    return torch.cat(blocks, dim=0)


def render_sharded(
    scene,
    camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    seed: int,
    mesh: Mesh,
    jitter: bool = False,
    remat: bool = False,
    engine: str = "core",
    geom: bool = False,
    n_em_cap: int | None = None,
    tri_nee: bool = False,
    tri_em_cap: int | None = None,
    rough_grad: bool = False,
    sample_offset: int = 0,
):
    """Full-image radiance rendered across the mesh: (H, W, 3) float32 on
    the device of this process's first slot.

    Slot ``(ti, si)`` renders rows ``ti * H / tile`` on (``H / tile`` of
    them) at sample offset ``sample_offset + si * spp / spp_axis``, on its
    own device (``sample_offset``, which the JAX function lacks, lets a
    chunked render continue without replaying samples); the
    images reduce in a fixed order (module docstring). Every process of a
    group returns the same image. ``engine``: ``core``, ``pallas`` (or
    ``cuda``, this package's name), ``physical`` or ``physical_pallas``,
    as ``_slot_renderer`` says; ``tri_nee`` and ``rough_grad`` need a
    physical engine. ``geom``, ``n_em_cap`` and ``tri_em_cap`` reach
    ``physical_pallas``'s geometry planes when it is differentiated.

    Differentiable: a gradient through the per-slot copies of the scene
    sums into the scene's leaves. Across processes a process's gradient
    holds its own slots' terms (``make_train_step`` sums them).
    """
    rows_local, spp_local = _check_divisible(height, spp, mesh)
    render = _slot_renderer(engine, height, width, spp_local, max_bounces, jitter, remat,
                            geom, n_em_cap, tri_nee, tri_em_cap, rough_grad)
    scenes = replicate_scene(scene, mesh)
    cameras = {d: _to(camera, d) for d in scenes}
    images = {(ti, si): render(scenes[s.device], cameras[s.device], seed, ti * rows_local,
                               rows_local, sample_offset + si * spp_local)
              for ti, si, s in mesh.local()}
    return _assemble(images, mesh)


def make_train_step(
    camera,
    height: int,
    width: int,
    spp: int,
    max_bounces: int,
    mesh: Mesh,
    param_fns,
    engine: str = "core",
    geom: bool = False,
    n_em_cap: int | None = None,
    tri_nee: bool = False,
    tri_em_cap: int | None = None,
    rough_grad: bool = False,
):
    """A sharded inverse-rendering step, ``step(params, opt, scene0,
    target, seed) -> loss``.

    ``param_fns`` is ``apply_params(scene0, params) -> Scene`` (as
    ``grad.diff.apply_material_params``); ``params`` a dict of leaf tensors
    and ``opt`` an optimizer over them (``grad.diff._adam``, the JAX
    package's ``optax.adam``). The step renders the parameterised scene
    across the mesh (``render_sharded``), takes the MSE against ``target``
    over the whole image, and leaves the gradient in each variable's
    ``.grad`` before one ``opt.step()``.

    The gradient is summed in a fixed order, so that one process and a
    group of them take the same step bit for bit: every slot renders from
    its own copy of the variables, autograd gives each copy its slot's
    gradient, and the slots' gradients (gathered across processes, the
    counterpart of the JAX package's ``psum``) are summed in slot order.
    ``remat`` is on for the autograd engines (``core``, ``physical``), as
    in the JAX package.
    """
    rows_local, spp_local = _check_divisible(height, spp, mesh)
    apply_params = param_fns
    render = _slot_renderer(engine, height, width, spp_local, max_bounces, False,
                            engine in ("core", "physical"), geom, n_em_cap, tri_nee, tri_em_cap,
                            rough_grad)
    cameras = {s.device: _to(camera, s.device) for _, _, s in mesh.local()}

    def step(params, opt, scene0, target, seed):
        names = list(params)
        local = mesh.local()
        copies = [{k: params[k].detach().clone().requires_grad_(True) for k in names}
                  for _ in local]
        images = {}
        for (ti, si, s), p in zip(local, copies):
            sc = _to(apply_params(scene0, p), s.device)
            images[(ti, si)] = render(sc, cameras[s.device], seed, ti * rows_local,
                                      rows_local, si * spp_local)
        img = _assemble(images, mesh)
        loss = torch.mean((img - target.to(img.device)) ** 2)
        grads = torch.autograd.grad(loss, [p[k] for p in copies for k in names],
                                    allow_unused=True)
        flat = {}  # one vector of every variable's gradient a slot
        for j, ((ti, si, _), p) in enumerate(zip(local, copies)):
            flat[(ti, si)] = torch.cat([
                (torch.zeros_like(p[k]) if g is None else g).reshape(-1).to(img.device)
                for k, g in zip(names, grads[j * len(names):(j + 1) * len(names)])])
        every = _gather(flat, mesh)
        order = [(ti, si) for ti, si, _ in mesh.flat()]
        total = every[order[0]]
        for key in order[1:]:
            total = total + every[key]
        offset = 0
        for k in names:
            v = params[k]
            v.grad = total[offset:offset + v.numel()].reshape(v.shape).to(v.device)
            offset += v.numel()
        opt.step()
        return loss.detach()

    return step

