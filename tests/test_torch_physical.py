"""PyTorch port: the eager physical tier (``models/physical.py``) against
the JAX package's ``render_physical``, values and gradients.

Scenes are built once with the JAX package's SceneBuilder and carried over with
``scene_from_arrays``; cotangents are made with numpy from a seed.

Value tolerance (tests/test_pallas_physical.py's, for two compilations of
one estimator on the same RNG streams): the 0.99-quantile of |delta| below
1e-4, the share of |delta| > 1e-3 below 1%, the image means within 2e-3.
XLA and PyTorch round a few operations differently (rsqrt, fused
multiply-adds), and a grazing ray or a shadow ray at a cone's rim can then
take another path: large per-pixel differences, rare, zero in expectation.

Gradient tolerance: rtol 1e-3 with an absolute floor of 1e-3 of the
leaf's largest entry, on cases checked to hold no flipped path (the two
images agree to 1e-5 everywhere).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.models.physical import render_physical as j_render_physical
from path_tracer_c_tpu.scene import demo as jdemo
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.models.physical import render_physical, trace_paths_physical
from path_tracer_c_tpu_torch.ops.render_grad import replace_leaves
from path_tracer_c_tpu_torch.scene.io import scene_from_arrays

torch.set_num_threads(1)

JCAM = J.Camera.reference()
PCAM = P.Camera.reference("cpu")


def tri_light_mixed_scene():
    """A triangle ceiling light, a sphere light and diffuse content: the
    mixed emitter pool of tests/test_pallas_physical.py."""
    b = J.SceneBuilder(sky_color=(0.01, 0.01, 0.02))
    ground = b.add_material(albedo=(0.6, 0.55, 0.5), roughness=1.0)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.9, 0.7),
                          emission_strength=20.0)
    slamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(0.8, 0.9, 1.0),
                           emission_strength=8.0)
    ball = b.add_material(albedo=(0.7, 0.3, 0.3), roughness=1.0)
    b.add_triangle(v0=(-40, -1, -40), v1=(40, -1, -40), v2=(40, -1, 40), material=ground)
    b.add_triangle(v0=(-40, -1, -40), v1=(-40, -1, 40), v2=(40, -1, 40), material=ground)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(1.0, 3.0, 4.0), v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(-1.0, 3.0, 6.0), v2=(1.0, 3.0, 6.0), material=lamp)
    b.add_sphere(center=(0.0, -0.3, 5.0), radius=0.7, material=ball)
    b.add_sphere(center=(2.0, 2.0, 3.5), radius=0.4, material=slamp)
    return b.build()


def lit_glass_scene():
    """A sphere light over a diffuse floor, a half-transparent ball and a
    half-rough one: every gradient of the physical tier is nonzero."""
    b = J.SceneBuilder(sky_color=(0.1, 0.15, 0.2))
    floor = b.add_material(albedo=(0.6, 0.5, 0.4), roughness=1.0)
    lamp = b.add_material(albedo=(0.2, 0.2, 0.2), emission_color=(1.0, 0.9, 0.7),
                          emission_strength=6.0)
    glass = b.add_material(albedo=(0.9, 0.95, 1.0), roughness=0.2, transparency=0.5,
                           refractive_index=1.4)
    satin = b.add_material(albedo=(0.7, 0.3, 0.3), roughness=0.5)
    b.add_triangle(v0=(-40, -1, -40), v1=(40, -1, -40), v2=(40, -1, 40), material=floor)
    b.add_triangle(v0=(-40, -1, -40), v1=(-40, -1, 40), v2=(40, -1, 40), material=floor)
    b.add_sphere(center=(1.5, 2.5, 5.0), radius=0.8, material=lamp)
    b.add_sphere(center=(-1.2, -0.2, 4.0), radius=0.8, material=glass)
    b.add_sphere(center=(0.8, -0.4, 3.5), radius=0.6, material=satin)
    return b.build()


SCENES = {
    "cornell": jdemo.cornell_spheres_scene, "glossy": jdemo.glossy_scene,
    "diffuse": jdemo.diffuse_sphere_scene, "tri_light": tri_light_mixed_scene,
    "lit_glass": lit_glass_scene,
}


def arrays(x):
    """A JAX dataclass tree as nested numpy dicts under its field names."""
    if dataclasses.is_dataclass(x):
        return {f.name: arrays(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def carry(jscene):
    return scene_from_arrays(arrays(jscene), "cpu")


def assert_images_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.all(np.isfinite(a))
    err = np.abs(a - b)
    assert np.quantile(err, 0.99) < 1e-4, np.quantile(err, 0.99)
    assert (err > 1e-3).mean() < 0.01, (err > 1e-3).mean()
    assert abs(a.mean() - b.mean()) < 2e-3, (a.mean(), b.mean())


# -- (a) values ----------------------------------------------------------------


@pytest.mark.parametrize("name, h, w, spp, bounces, seed, kw", [
    ("cornell", 16, 128, 2, 3, 7, {}),
    ("glossy", 16, 128, 2, 4, 11, {}),
    ("cornell", 8, 128, 2, 3, 3, dict(jitter=False)),
    ("cornell", 8, 128, 2, 3, 5, dict(nee=False)),
    ("diffuse", 8, 128, 2, 2, 9, {}),  # no emitter: picks clamped, terms masked
    ("tri_light", 16, 128, 2, 3, 7, dict(jitter=False, tri_nee=True)),
    ("tri_light", 16, 128, 2, 3, 7, dict(tri_nee=False)),
    ("glossy", 8, 128, 2, 3, 2, dict(sample_offset=64)),
    ("cornell", 20, 36, 1, 2, 13, dict(rough_grad=True)),  # ragged; the value is rough_grad-free
])
def test_eager_matches_jax_render_physical(name, h, w, spp, bounces, seed, kw):
    jscene = SCENES[name]()
    want = j_render_physical(jscene, JCAM, h, w, spp, bounces, jnp.uint32(seed), **kw)
    got = render_physical(carry(jscene), PCAM, h, w, spp, bounces, seed, **kw)
    assert got.shape == (h, w, 3) and got.dtype == torch.float32
    assert_images_close(got.numpy(), want)


def test_sample_ranges_sum_to_the_whole():
    pscene = carry(jdemo.cornell_spheres_scene())
    whole = render_physical(pscene, PCAM, 8, 32, 4, 3, 5)
    a = render_physical(pscene, PCAM, 8, 32, 2, 3, 5)
    b = render_physical(pscene, PCAM, 8, 32, 2, 3, 5, sample_offset=2)
    np.testing.assert_allclose(((a + b) / 2).numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)


def test_no_emitter_pick_is_clipped_and_masked():
    """n_em == 0: searchsorted returns S, clipped to S - 1, and the light
    sample adds nothing: the render equals the one without NEE."""
    pscene = carry(jdemo.diffuse_sphere_scene())
    with_nee = render_physical(pscene, PCAM, 8, 32, 2, 3, 1)
    without = render_physical(pscene, PCAM, 8, 32, 2, 3, 1, nee=False)
    assert torch.equal(with_nee, without) and bool(torch.isfinite(with_nee).all())


def test_tri_nee_reduces_variance_and_keeps_the_mean():
    """Sampling the triangle light keeps the estimator unbiased (means
    agree within the Monte-Carlo error) and cuts the per-pixel variance."""
    pscene = carry(tri_light_mixed_scene())
    runs = {flag: torch.stack([render_physical(pscene, PCAM, 8, 32, 8, 2, s, tri_nee=flag)
                               for s in range(6)]) for flag in (False, True)}
    assert float(runs[True].var(0).mean()) < 0.5 * float(runs[False].var(0).mean())
    assert float(runs[True].mean()) == pytest.approx(float(runs[False].mean()), rel=0.25)


@pytest.mark.parametrize("name", ["row_start", "rows", "remat", "vma_axes", "collect_stats"])
def test_unported_arguments_are_refused_by_name(name):
    """The JAX function's arguments, each ported or refused by name.
    ``collect_stats`` is ported: ``trace_paths_physical`` takes it, and
    ``render_physical``, like the JAX function, has no such argument.
    ``remat`` is ported: the image and the gradient do not change.
    ``row_start`` and ``rows`` are ported: a block is the same rows of the
    whole image. ``vma_axes`` has no PyTorch counterpart and is refused
    with a message that says so."""
    pscene = carry(jdemo.diffuse_sphere_scene())
    if name in ("row_start", "rows"):
        whole = render_physical(pscene, PCAM, 8, 8, 1, 1, 0)
        block = render_physical(pscene, PCAM, 8, 8, 1, 1, 0, row_start=3, rows=2)
        assert torch.equal(block, whole[3:5])
        with pytest.raises(ValueError):
            render_physical(pscene, PCAM, 8, 8, 1, 1, 0, row_start=7, rows=2)
        return
    if name == "remat":
        out = {}
        for remat in (False, True):
            albedo = pscene.materials.albedo.clone().requires_grad_()
            live = dataclasses.replace(pscene, materials=dataclasses.replace(
                pscene.materials, albedo=albedo))
            img = render_physical(live, PCAM, 8, 8, 2, 2, 0, remat=remat)
            out[remat] = (img.detach(), torch.autograd.grad(img.sum(), albedo)[0])
        assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))
        assert bool(out[True][1].any())
        return
    if name == "collect_stats":
        o, d = P.primary_rays(PCAM, 2, 2)
        from path_tracer_c_tpu_torch.ops import rng

        st = rng.seed_state(torch.arange(4), 0, 0)
        stats = trace_paths_physical(pscene, o, d, st, 1, collect_stats=True)[-1]
        assert set(stats) == {"hits", "misses", "tir_deaths", "nee_candidates", "nee_visible"}
        with pytest.raises(TypeError):
            render_physical(pscene, PCAM, 8, 8, 1, 1, 0, collect_stats=1)
        return
    with pytest.raises(TypeError, match="shard_map"):
        render_physical(pscene, PCAM, 8, 8, 1, 1, 0, **{name: 1})
    with pytest.raises(TypeError):
        render_physical(pscene, PCAM, 8, 8, 1, 1, 0, nonsense=1)


def test_camera_and_scene_must_share_a_device():
    with pytest.raises(ValueError):
        render_physical(carry(jdemo.diffuse_sphere_scene()), P.Camera.reference("meta"),
                        8, 8, 1, 1, 0)


def test_trace_paths_physical_returns_the_advanced_state():
    """7 draws a bounce: the final state is the start state advanced by
    7 (B + 1) steps, for every ray, hit or miss."""
    from path_tracer_c_tpu_torch.ops import rng

    pscene = carry(jdemo.cornell_spheres_scene())
    pix = P.ops.camera.pixel_indices(4, 8, "cpu")
    st0 = rng.seed_state(pix, 0, 3)
    o, d = P.primary_rays(PCAM, 4, 8)
    rad, st = trace_paths_physical(pscene, o, d, st0, 2)
    want = st0
    for _ in range(7 * 3):
        want, _ = rng.pcg_next(want)
    assert torch.equal(st, want) and rad.shape == (32, 3)


# -- (d) gradients -------------------------------------------------------------


def cotangent(h, w, gseed):
    return np.random.default_rng(gseed).standard_normal((h, w, 3)).astype(np.float32)


# The leaves compared: table, field.
GRAD_LEAVES = (("materials", "albedo"), ("materials", "emission_color"),
               ("materials", "emission_strength"), ("materials", "transparency"),
               ("materials", "roughness"), ("spheres", "center"), ("spheres", "radius"),
               (None, "sky_color"))


def leaf(scene, table, name):
    return getattr(scene if table is None else getattr(scene, table), name)


def torch_grads(jscene, g, h, w, spp, bounces, seed, **kw):
    pscene = carry(jscene)
    leaves = [leaf(pscene, t, n).clone().requires_grad_() for t, n in GRAD_LEAVES]
    live = replace_leaves(pscene, [(t, n, x) for (t, n), x in zip(GRAD_LEAVES, leaves)])
    img = render_physical(live, PCAM, h, w, spp, bounces, seed, **kw)
    grads = torch.autograd.grad(img, leaves, torch.from_numpy(g), allow_unused=True)
    # a leaf the image does not depend on (roughness without rough_grad): zeros
    return img.detach().numpy(), [np.zeros(tuple(l.shape), np.float32) if x is None else x.numpy()
                                  for l, x in zip(leaves, grads)]


def jax_grads(jscene, g, h, w, spp, bounces, seed, **kw):
    img, vjp = jax.vjp(
        lambda sc: j_render_physical(sc, JCAM, h, w, spp, bounces, jnp.uint32(seed), **kw),
        jscene)
    d = vjp(jnp.asarray(g))[0]
    return np.asarray(img), [np.asarray(leaf(d, t, n)) for t, n in GRAD_LEAVES]


@pytest.mark.parametrize("rough_grad", [False, True])
def test_eager_gradient_matches_jax_grad(rough_grad):
    """autograd through the eager tier against jax.vjp through
    render_physical: albedo, emission, transparency (the detached-ratio
    form: 1/t on refraction, -1/(1-t) otherwise), the emitter's centre and
    radius (the cone chain and the whole path), the sky; with rough_grad
    the score-function roughness gradient, which is zero without it."""
    jscene = lit_glass_scene()
    h, w, spp, bounces, seed = 12, 32, 2, 3, 7
    g = cotangent(h, w, 0)
    kw = dict(rough_grad=rough_grad, jitter=False)
    jimg, want = jax_grads(jscene, g, h, w, spp, bounces, seed, **kw)
    pimg, got = torch_grads(jscene, g, h, w, spp, bounces, seed, **kw)
    # no flipped path in this case: the two images agree everywhere
    np.testing.assert_allclose(pimg, jimg, rtol=1e-4, atol=1e-5)
    for (table, name), a, b in zip(GRAD_LEAVES, got, want):
        assert np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * max(np.abs(b).max(), 1e-6),
                                   err_msg=name)
    by_name = {n: a for (_, n), a in zip(GRAD_LEAVES, got)}
    assert np.abs(by_name["transparency"][2]) > 1e-3  # the glass
    assert np.abs(by_name["center"][0]).max() > 1e-4  # the lamp, through the cone chain
    assert np.abs(by_name["radius"][0]) > 1e-4
    assert bool(np.any(by_name["roughness"])) == rough_grad


# -- table rows: the fetch and its backward -------------------------------------


@pytest.mark.parametrize("shape, block", [((7,), 2), ((7, 3), 3), ((300, 3), 7)])
def test_row_fetch_is_indexing_with_a_backward_in_fixed_order(shape, block, monkeypatch):
    """``ops/intersect.rows`` gives ``table[idx]``. Its backward on the CPU
    is the serial ``index_add_``: the same bits on every run. The card's
    (``_row_sums``: one-hot sums, here in blocks of ``block`` rows, run on
    CPU tensors) also gives the same bits on every run, within float32
    rounding of the float64 sums: 1e-6 of each row's sum of |cotangent|."""
    from path_tracer_c_tpu_torch.ops import intersect

    n = 200_000
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, shape[0], n))
    g = torch.from_numpy(rng.standard_normal((n, *shape[1:])).astype(np.float32))
    assert torch.equal(intersect.rows(table, idx), table.detach()[idx])
    serial = torch.zeros(shape).index_add_(0, idx, g)
    for _ in range(2):
        assert torch.equal(torch.autograd.grad(intersect.rows(table, idx), table, g)[0], serial)
    monkeypatch.setattr(intersect, "_ROW_SUM_CHUNK", n * g[0].numel() * block)
    sums = [intersect._row_sums(idx, g, shape[0]) for _ in range(2)]
    assert torch.equal(sums[0], sums[1])
    exact = torch.zeros(shape, dtype=torch.float64).index_add_(0, idx, g.double())
    scale = torch.zeros(shape, dtype=torch.float64).index_add_(0, idx, g.double().abs())
    assert bool(((sums[0].double() - exact).abs() <= 1e-6 * scale).all())


def test_eager_gradient_repeats_and_equals_indexings(monkeypatch):
    """The eager tier's gradient with respect to every leaf of the mixed
    emitter pool (``tri_nee``, a sphere and two triangle lamps): the same
    bits on two runs, and within float32 rounding (rtol 1e-5, an absolute
    floor of 1e-5 of the leaf's largest entry) of the gradient through plain
    indexing, the fetch before ``rows``."""
    from path_tracer_c_tpu_torch.grad import diff
    from path_tracer_c_tpu_torch.models import physical as pm
    from path_tracer_c_tpu_torch.ops import intersect

    pscene = carry(tri_light_mixed_scene())
    g = torch.from_numpy(cotangent(12, 16, 3))

    def grads():
        names = diff._float_leaves(pscene)
        leaves = [t.detach().requires_grad_() for _, _, t in names]
        live = replace_leaves(pscene, [(tb, nm, t) for (tb, nm, _), t in zip(names, leaves)])
        img = render_physical(live, PCAM, 12, 16, 2, 3, 9, tri_nee=True)
        return torch.autograd.grad(img, leaves, g, allow_unused=True)

    first, second = grads(), grads()
    assert any(a is not None and bool(a.any()) for a in first)
    for a, b in zip(first, second):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
    indexing = lambda table, idx: table[idx]
    monkeypatch.setattr(intersect, "rows", indexing)
    monkeypatch.setattr(pm, "rows", indexing)
    for a, b in zip(first, grads()):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5 * max(float(b.abs().max()), 1e-6))
