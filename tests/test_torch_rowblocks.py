"""PyTorch port: row blocks (a launch over ``rows`` rows from ``row_start``
of a ``height``-row image) in the eager tiers and the five render kernels'
plain twins.

A block keys its RNG streams and camera rays on global rows, so:

* a block equals the same rows of the whole render bit for bit, for the
  eager tiers and for the twins of B1-B4 (images, planes and counts summed
  over the blocks); B5's cotangents summed over the blocks equal the
  whole's to ``BWD_RTOL`` (its twin reduces in float64, so they agree to
  about 1e-7);
* the twins of B1 and B3 with ``row_start``/``rows`` match the JAX
  package's Pallas kernels with the same arguments (interpret mode), and the
  eager tiers match the JAX package's, at the tolerances of
  ``tests/test_torch_render_kernel.py`` (a 0.999-quantile of |delta| below
  1e-4, a mean below 1e-5) and ``tests/test_torch_render_physical.py``.

Scenes are the JAX package's demo scenes carried over with
``scene_from_arrays``.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.models.integrator import render_tile as j_render_tile
from path_tracer_c_tpu.models.physical import render_physical as j_render_physical
from path_tracer_c_tpu.ops.pallas_kernels import render_pallas
from path_tracer_c_tpu.ops.pallas_physical import render_physical_pallas
from path_tracer_c_tpu.scene import demo as jdemo
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.models.integrator import render_tile
from path_tracer_c_tpu_torch.models.physical import render_physical
from path_tracer_c_tpu_torch.ops import render_grad as rg
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
from path_tracer_c_tpu_torch.scene.io import scene_from_arrays

torch.set_num_threads(1)

JCAM, PCAM = J.Camera.reference(), P.Camera.reference("cpu")
BWD_RTOL = 2e-4
# (row_start, rows) of the blocks of a ragged 19-row image and of 32 rows.
RAGGED = (19, 23, [(0, 7), (7, 12)])
EVEN = (32, 16, [(0, 8), (8, 16), (24, 8)])


def arrays(x):
    if dataclasses.is_dataclass(x):
        return {f.name: arrays(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def carry(jscene):
    return scene_from_arrays(arrays(jscene), "cpu")


def join(outs):
    """Blocks' outputs joined: images (rows, W, 3) along rows, planes (n,
    rows, W) along rows, counts and dicts of counts summed."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(outs, dim=0 if first.shape[-1] == 3 else 1)
    if isinstance(first, dict):
        return {k: sum(o[k] for o in outs) for k in first}
    if isinstance(first, tuple):
        return tuple(join([o[i] for o in outs]) for i in range(len(first)))
    return sum(outs)


def assert_blocks_equal_whole(fn, args, kw, blocks):
    whole = fn(*args, **kw)
    joined = join([fn(*args, row_start=r0, rows=n, **kw) for r0, n in blocks])
    whole, joined = (whole, joined) if isinstance(whole, tuple) else ((whole,), (joined,))
    for a, b in zip(whole, joined):
        if isinstance(a, torch.Tensor):
            assert a.shape == b.shape and torch.equal(a, b)
        else:
            assert a == b


def assert_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b)
    assert np.quantile(err, 0.999) < 1e-4, np.quantile(err, 0.999)
    assert err.mean() < 1e-5, err.mean()


def assert_images_close(a, b):
    """tests/test_torch_render_physical.py's criterion."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.all(np.isfinite(a))
    err = np.abs(a - b)
    assert np.quantile(err, 0.99) < 1e-4, np.quantile(err, 0.99)
    assert (err > 1e-3).mean() < 0.01, (err > 1e-3).mean()
    assert abs(a.mean() - b.mean()) < 2e-3, (a.mean(), b.mean())


@pytest.fixture(scope="module")
def cornell():
    return carry(jdemo.cornell_spheres_scene())


# -- a block is the same rows of the whole -------------------------------------


TWIN_CASES = [
    ("B1", rk.render_kernel_reference, dict(count_rounds=True, jitter=True, sample_offset=3)),
    ("B1 rounds", rk.render_kernel_round_counts_reference, {}),
    ("B2", rg.render_fused_reference, dict(count_rounds=True, jitter=True)),
    ("B2 rounds", rg.render_fused_round_counts_reference, {}),
    ("B3", rp.render_physical_kernel_reference, dict(count_events=True)),
    ("B3 rounds", rp.render_physical_kernel_round_counts_reference, dict(jitter=False)),
    ("B4", pg.render_physical_fused_reference, dict(n_em_cap=2, count_events=True)),
    ("B4 rough", pg.render_physical_fused_reference, dict(rough_grad=True, nee=False)),
    ("B4 rounds", pg.render_physical_fused_round_counts_reference, {}),
]


@pytest.mark.parametrize("name, fn, kw", TWIN_CASES, ids=[c[0] for c in TWIN_CASES])
@pytest.mark.parametrize("shape", [RAGGED, EVEN], ids=["ragged", "even"])
def test_twin_blocks_equal_the_whole(cornell, name, fn, kw, shape):
    h, w, blocks = shape
    assert_blocks_equal_whole(fn, (cornell, PCAM, h, w, 2, 3, 7), kw, blocks)


@pytest.mark.parametrize("fn", [rk.render_kernel, rg.render_fused, rp.render_physical_kernel,
                                pg.render_physical_fused])
def test_wrappers_take_the_twins_row_blocks_on_cpu_tensors(cornell, fn):
    """The wrappers on CPU tensors: the twin's block, no launch."""
    h, w, blocks = RAGGED
    assert_blocks_equal_whole(fn, (cornell, PCAM, h, w, 1, 2, 3), {}, blocks)


def test_tri_nee_fused_twin_blocks_equal_the_whole():
    """The triangle-emitter planes too (tests/test_parallel.py's scene)."""
    b = J.SceneBuilder(sky_color=(0.0, 0.0, 0.0))
    ground = b.add_material(albedo=(0.6, 0.55, 0.5), roughness=1.0)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.9, 0.7),
                          emission_strength=20.0)
    b.add_triangle(v0=(-40, -1, -40), v1=(40, -1, -40), v2=(40, -1, 40), material=ground)
    b.add_triangle(v0=(-1.0, 3.0, 4.0), v1=(1.0, 3.0, 4.0), v2=(1.0, 3.0, 6.0), material=lamp)
    scene = carry(b.build())
    h, w, blocks = RAGGED
    assert_blocks_equal_whole(pg.render_physical_fused_reference, (scene, PCAM, h, w, 2, 2, 5),
                              dict(tri_nee=True, tri_em_cap=1, jitter=False), blocks)


def test_two_pass_twin_blocks_sum_to_the_whole(cornell):
    h, w, blocks = RAGGED
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((h, w, 3)).astype(np.float32))
    whole = pg.render_physical_bwd_reference(cornell, PCAM, g, h, w, 2, 3, 7, n_em_cap=2)
    parts = [pg.render_physical_bwd_reference(cornell, PCAM, g[r0:r0 + n], h, w, 2, 3, 7,
                                              n_em_cap=2, row_start=r0, rows=n)
             for r0, n in blocks]
    for table, name in (("materials", "albedo"), ("materials", "emission_color"),
                        ("materials", "emission_strength"), ("materials", "transparency"),
                        ("spheres", "center"), ("spheres", "radius"), (None, "sky_color")):
        get = lambda s: getattr(getattr(s, table) if table else s, name)
        ref = get(whole)
        scale = max(float(ref.abs().max()), 1.0)
        torch.testing.assert_close(sum(get(p) for p in parts), ref, rtol=BWD_RTOL,
                                   atol=1e-6 * scale)
    # Through the wrapper (the twin on CPU tensors), and a cotangent of the
    # wrong shape for the block is refused.
    part = pg.render_physical_bwd(cornell, PCAM, g[:7], h, w, 2, 3, 7, n_em_cap=2, rows=7)
    assert torch.equal(part.materials.albedo, parts[0].materials.albedo)
    with pytest.raises(ValueError, match="g has shape"):
        pg.render_physical_bwd(cornell, PCAM, g, h, w, 2, 3, 7, rows=7)


@pytest.mark.parametrize("remat", [False, True])
def test_eager_tiers_blocks_equal_the_whole(cornell, remat):
    h, w, blocks = RAGGED
    assert_blocks_equal_whole(render_tile, (cornell, PCAM, h, w, 2, 3, 7),
                              dict(jitter=True, sample_offset=2, remat=remat), blocks)
    assert_blocks_equal_whole(render_physical, (cornell, PCAM, h, w, 2, 3, 7),
                              dict(remat=remat), blocks)


def test_vjp_blocks_carry_their_rows_gradient(cornell):
    """The differentiable kernels over a block: the image is the block of
    the whole, and the gradient of a loss on the whole image is the sum of
    the blocks' gradients (float32 sums in another order: rtol 1e-5)."""
    h, w, blocks = RAGGED
    for vjp, kw in ((rg.render_kernel_vjp, {}), (pg.render_physical_kernel_vjp, {})):
        albedo = cornell.materials.albedo.clone().requires_grad_()
        live = dataclasses.replace(cornell, materials=dataclasses.replace(
            cornell.materials, albedo=albedo))
        whole = vjp(live, PCAM, h, w, 2, 3, 7, **kw)
        (g_whole,) = torch.autograd.grad(whole.square().sum(), albedo)
        g_sum = torch.zeros_like(albedo)
        for r0, n in blocks:
            img = vjp(live, PCAM, h, w, 2, 3, 7, row_start=r0, rows=n, **kw)
            assert torch.equal(img.detach(), whole.detach()[r0:r0 + n])
            g_sum = g_sum + torch.autograd.grad(img.square().sum(), albedo)[0]
        torch.testing.assert_close(g_sum, g_whole, rtol=1e-5, atol=1e-7)


# -- against the JAX package ------------------------------------------------------


@pytest.mark.parametrize("name, jitter, offset", [("demo_scene", True, 3),
                                                  ("glossy_scene", False, 0)])
def test_b1_twin_block_matches_pallas_interpret(name, jitter, offset):
    h, w, row_start, rows = 32, 128, 16, 8
    j = render_pallas(getattr(jdemo, name)(), JCAM, h, w, 2, 3, jnp.uint32(5),
                      sample_offset=offset, row_start=row_start, rows=rows, tile=(8, 128),
                      interpret=True, jitter=jitter)
    p = rk.render_kernel_reference(carry(getattr(jdemo, name)()), PCAM, h, w, 2, 3, 5,
                                   sample_offset=offset, jitter=jitter, row_start=row_start,
                                   rows=rows)
    assert p.shape == (rows, w, 3)
    assert_close(j, p)


@pytest.mark.parametrize("name, kw", [("cornell_spheres_scene", {}),
                                      ("glossy_scene", dict(jitter=False, sample_offset=4))])
def test_b3_twin_block_matches_pallas_interpret(name, kw):
    h, w, row_start, rows = 32, 128, 8, 8
    j = render_physical_pallas(getattr(jdemo, name)(), JCAM, h, w, 2, 3, jnp.uint32(7),
                               row_start=row_start, rows=rows, tile=(8, 128), interpret=True,
                               **kw)
    p = rp.render_physical_kernel_reference(carry(getattr(jdemo, name)()), PCAM, h, w, 2, 3, 7,
                                            row_start=row_start, rows=rows, **kw)
    assert p.shape == (rows, w, 3)
    assert_images_close(p.numpy(), j)


def test_eager_tiers_blocks_match_jax():
    """At the shapes of the whole-image comparisons (16 x 128 and more): the
    criteria are quantiles, which a few pixels of a tiny image would set."""
    jscene = jdemo.cornell_spheres_scene()
    h, w, row_start, rows = 32, 128, 8, 16
    j = j_render_tile(jscene, JCAM, h, w, 2, 3, jnp.uint32(4), jitter=True, sample_offset=1,
                      row_start=row_start, rows=rows)
    p = render_tile(carry(jscene), PCAM, h, w, 2, 3, 4, jitter=True, sample_offset=1,
                    row_start=row_start, rows=rows)
    assert_close(j, p)
    j = j_render_physical(jscene, JCAM, h, w, 2, 3, jnp.uint32(4), row_start=row_start,
                          rows=rows)
    p = render_physical(carry(jscene), PCAM, h, w, 2, 3, 4, row_start=row_start, rows=rows)
    assert_images_close(p.numpy(), j)


def test_pixel_indices_and_primary_rays_match_jax():
    from path_tracer_c_tpu.ops import camera as jcamera
    from path_tracer_c_tpu_torch.ops import camera as pcamera

    np.testing.assert_array_equal(pcamera.pixel_indices(12, 10, "cpu", 5, 3).numpy(),
                                  np.asarray(jcamera.pixel_indices(12, 10, 5, 3)))
    jo, jd = jcamera.primary_rays(JCAM, 12, 10, row_start=5, rows=3)
    po, pd = pcamera.primary_rays(PCAM, 12, 10, row_start=5, rows=3)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))


# -- bounds ---------------------------------------------------------------------------


@pytest.mark.parametrize("row_start, rows", [(-1, 2), (0, 0), (18, 2), (19, 1), (0, 20)])
def test_row_block_bounds_are_checked(cornell, row_start, rows):
    h, w = 19, 23
    for fn in (rk.render_kernel, rk.render_kernel_reference, rg.render_fused,
               rp.render_physical_kernel, pg.render_physical_fused, render_tile,
               render_physical):
        with pytest.raises(ValueError, match="outside an image of 19 rows"):
            fn(cornell, PCAM, h, w, 1, 1, 0, row_start=row_start, rows=rows)
    g = torch.zeros((max(rows, 1), w, 3))
    with pytest.raises(ValueError, match="outside an image of 19 rows"):
        pg.render_physical_bwd(cornell, PCAM, g, h, w, 1, 1, 0, row_start=row_start, rows=rows)


def test_a_block_to_the_end_by_default(cornell):
    """``rows`` left out: the rows from ``row_start`` to the end."""
    whole = rk.render_kernel(cornell, PCAM, 19, 23, 1, 2, 0)
    assert torch.equal(rk.render_kernel(cornell, PCAM, 19, 23, 1, 2, 0, row_start=12), whole[12:])
