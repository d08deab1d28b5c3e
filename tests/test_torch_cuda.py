"""PyTorch port on a card: the hand CUDA kernels against their plain twins.

These tests need a CUDA device and skip without one. They import no JAX, so
they also run where only PyTorch is installed; from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest.py configures JAX.)

Tolerance (tests/test_pallas.py's): a 0.999-quantile of |delta| < 1e-4 and
a mean |delta| < 1e-5. On the card the kernel and its twin round alike and
agree bit for bit; the CPU twin rounds rsqrt differently, and a chaotic path
can then flip at a silhouette.
"""

import dataclasses

import pytest
import torch

import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.ops import render_grad as rg
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
from path_tracer_c_tpu_torch.scene import demo as pdemo
from path_tracer_c_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

# Each timed kernel's launch counter (``utils/tracing.counters``), by wrapper.
LAUNCH = {rk.render_kernel: "launch.render_fwd", rp.render_physical_kernel: "launch.render_phys",
          rg.render_fused: "launch.render_fused",
          pg.render_physical_fused: "launch.render_phys_fused",
          pg.render_physical_bwd: "launch.render_phys_bwd"}


def assert_close(a, b):
    err = (a.double().cpu() - b.double().cpu()).abs().flatten()
    assert a.shape == b.shape and bool(torch.isfinite(err).all())
    assert float(torch.quantile(err, 0.999)) < 1e-4
    assert float(err.mean()) < 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", ["demo_scene", "glossy_scene", "cornell_spheres_scene"])
def test_kernel_matches_twin(cuda_device, name):
    scene, cam = getattr(pdemo, name)(cuda_device), P.Camera.reference(cuda_device)
    launches = tracing.counters()
    for jitter, offset, bounces in ((False, 0, 4), (True, 3, 8)):
        args = (scene, cam, 100, 160, 4, bounces, 7)
        k = rk.render_kernel(*args, sample_offset=offset, jitter=jitter)
        r = rk.render_kernel_reference(*args, sample_offset=offset, jitter=jitter)
        assert k.device == cuda_device and k.shape == (100, 160, 3)
        assert_close(k, r)
    assert (tracing.counters() - launches)["launch.render_fwd"] == 2
    # the chain to the twin on the CPU
    cpu = rk.render_kernel_reference(getattr(pdemo, name)("cpu"), P.Camera.reference("cpu"),
                                     24, 40, 2, 4, 5, sample_offset=2, jitter=True)
    k = rk.render_kernel(scene, cam, 24, 40, 2, 4, 5, sample_offset=2, jitter=True)
    assert_close(k, cpu)


def test_kernel_rejects_mixed_devices(cuda_device):
    scene = pdemo.demo_scene(cuda_device)
    with pytest.raises(ValueError):
        rk.render_kernel(scene, P.Camera.reference("cpu"), 8, 8, 1, 1, 0)
    mixed = dataclasses.replace(scene, sky_color=scene.sky_color.cpu())
    with pytest.raises(ValueError):
        rk.render_kernel(mixed, P.Camera.reference(cuda_device), 8, 8, 1, 1, 0)


# -- the fused primal + Jacobian kernel --------------------------------------


def mixed_scene(device):
    """Emission, partial transparency (with total internal reflection), a
    diffuse floor whose albedo is exactly black, sky misses."""
    b = P.SceneBuilder(sky_color=(0.2, 0.3, 0.5))
    b.add_material(albedo=(0.9, 0.8, 0.7), roughness=0.4,
                   emission_color=(1.0, 0.8, 0.6), emission_strength=3.0)
    glassy = b.add_material(albedo=(0.9, 0.95, 1.0), roughness=0.1,
                            transparency=0.5, refractive_index=1.4)
    black = b.add_material(albedo=(0.0, 0.0, 0.0), roughness=1.0)
    b.add_sphere(center=(0, 2.5, 6), radius=1.5, material=0)
    b.add_sphere(center=(0.5, -0.2, 4), radius=1.0, material=glassy)
    b.add_triangle(v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50), material=black)
    b.add_triangle(v0=(-50, -1, -50), v1=(-50, -1, 50), v2=(50, -1, 50), material=black)
    return b.build(device)


@pytest.mark.parametrize(
    "name", ["demo_scene", "glossy_scene", "mixed", "random_spheres_scene"])
def test_fused_kernel_matches_forward_kernel_and_twin(cuda_device, name):
    """The image equals render_kernel's bit for bit, and image and
    Jacobian equal the twin's value for value: one definition of the
    arithmetic, no FMA contraction, one order of additions.
    random_spheres_scene has 33 materials, so 300 planes."""
    scene = mixed_scene(cuda_device) if name == "mixed" else getattr(pdemo, name)(cuda_device)
    cam = P.Camera.reference(cuda_device)
    launches = tracing.counters()
    for jitter, offset, bounces in ((False, 0, 4), (True, 3, 8)):
        args = (scene, cam, 100, 160, 4, bounces, 7)
        kw = dict(sample_offset=offset, jitter=jitter)
        img, jac = rg.render_fused(*args, **kw)
        assert jac.shape == (9 * scene.num_materials + 3, 100, 160) and jac.device == cuda_device
        assert torch.equal(img, rk.render_kernel(*args, **kw))
        r_img, r_jac = rg.render_fused_reference(*args, **kw)
        assert torch.equal(img, r_img)
        assert torch.equal(jac, r_jac)
    assert (tracing.counters() - launches)["launch.render_fused"] == 2


def test_count_rounds_match_twins(cuda_device):
    scene, cam = mixed_scene(cuda_device), P.Camera.reference(cuda_device)
    args = (scene, cam, 100, 160, 2, 6, 3)
    img, n_fwd = rk.render_kernel(*args, count_rounds=True)
    _, _, n_fus = rg.render_fused(*args, count_rounds=True)
    assert torch.equal(img, rk.render_kernel(*args))
    assert n_fwd == rk.render_kernel_reference(*args, count_rounds=True)[1]
    assert n_fus == rg.render_fused_reference(*args, count_rounds=True)[2]
    assert 0 < n_fwd < n_fus <= 100 * 160 * 2 * 7  # the black floor: more rounds fused


def test_vjp_backward_matches_twin_contraction(cuda_device):
    scene, cam = mixed_scene(cuda_device), P.Camera.reference(cuda_device)
    h, w, spp, bounces, seed = 32, 64, 3, 4, 7
    g = torch.randn((h, w, 3), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    leaves = [t.clone().requires_grad_() for t in rg._grad_leaves(scene)]
    launches = tracing.counters()
    rg.render_kernel_vjp(rg._with_leaves(scene, leaves), cam, h, w, spp, bounces, seed).backward(g)
    assert (tracing.counters() - launches)["launch.render_fused"] == 1
    _, r_jac = rg.render_fused_reference(scene, cam, h, w, spp, bounces, seed)
    want = rg._grad_leaves(rg.contract_jacobian(scene, r_jac, g, spp))
    for leaf, expect in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, expect, rtol=1e-5, atol=1e-6)
    assert scene.materials.roughness.grad is None


def _bench_trace():
    """The benchmark's reading of a profiler window (``benchmark/harness/trace.py``)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "benchmark" / "harness" / "trace.py"
    spec = importlib.util.spec_from_file_location("bench_harness_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_spans_share_the_profiler_clock_with_the_card(cuda_device):
    """One B1 frame, one B3 frame and one B2 forward and backward under the
    profiler: every call's check, pack and launch spans, and B2's
    contraction, are host events of the trace, none inside another; the
    benchmark's reading of the trace keeps none among the card's
    activities (kernels and copies) and all among the host's."""
    from torch.autograd import DeviceType

    bench = _bench_trace()
    scene, cam = pdemo.glossy_scene(cuda_device), P.Camera.reference(cuda_device)
    shape = (32, 48, 2, 3)
    rk.render_kernel(scene, cam, *shape, 1).cpu()  # the library built outside the trace
    leaves = [t.clone().requires_grad_() for t in rg._grad_leaves(scene)]
    with bench.profiled(True) as prof:
        with torch.profiler.record_function(bench.WINDOW):
            rk.render_kernel(scene, cam, *shape, 2).cpu()
            rp.render_physical_kernel(scene, cam, *shape, 3).cpu()
            img = rg.render_kernel_vjp(rg._with_leaves(scene, leaves), cam, *shape, 4)
            img.sum().backward()
            torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == DeviceType.CPU and e.name.startswith("pt.")]
    want = [f"pt.{phase}.{stem}" for phase in ("check", "pack", "launch")
            for stem in ("render_fwd", "render_phys", "render_fused")]
    # B2's forward checks twice (the leaves replaced, then the entry's
    # checks) and waits for its camera's parameters; B1 and B3 reuse those
    # the warm-up call packed (``ops/pack_cache.py``), so they wait for none.
    want += ["pt.check.render_fused", "pt.contract.render_fused", "pt.wait.camera_params"]
    assert sorted(n for _, _, n in spans) == sorted(want)
    assert not [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA and e.name.startswith("pt.")]
    assert not [(a[2], b[2]) for a in spans for b in spans
                if a is not b and a[0] <= b[0] and b[1] <= a[1]]
    trace = bench.Trace(prof)
    assert trace.device and not [n for _, _, n in trace.device if "pt." in n]
    assert {n for _, _, n in trace.host if n.startswith("pt.")} == {n for _, _, n in spans}


# -- B1's and B3's operands packed once (ops/pack_cache.py) ----------------------

RENDERS = {"render_fwd": rk.render_kernel, "render_phys": rp.render_physical_kernel}


@pytest.mark.parametrize("stem", list(RENDERS))
def test_a_reused_pack_renders_as_a_fresh_one(cuda_device, stem):
    """A launch on the operands an earlier launch packed gives, seed for
    seed, the image of a launch that packs a newly built scene and camera."""
    render = RENDERS[stem]
    scene, cam = pdemo.glossy_scene(cuda_device), P.Camera.reference(cuda_device)
    render(scene, cam, 48, 64, 2, 4, 0)
    seeds = (1, 7, 2**31 + 5)
    before = tracing.counters()
    reused = [render(scene, cam, 48, 64, 2, 4, seed) for seed in seeds]
    fresh = [render(pdemo.glossy_scene(cuda_device), P.Camera.reference(cuda_device),
                    48, 64, 2, 4, seed) for seed in seeds]
    assert all(torch.equal(r, f) for r, f in zip(reused, fresh))
    moved = tracing.counters() - before
    assert moved[f"pack.hit.{stem}"] == 3 and moved[f"pack.miss.{stem}"] == 3
    assert moved["wait.camera_params"] == 3  # each new camera's parameters, once


@pytest.mark.parametrize("stem", list(RENDERS))
def test_an_in_place_edit_between_launches_is_rendered(cuda_device, stem):
    render = RENDERS[stem]
    scene, cam = pdemo.glossy_scene(cuda_device), P.Camera.reference(cuda_device)
    before = render(scene, cam, 48, 64, 2, 4, 3)
    scene.materials.albedo.mul_(0.5)
    edited = render(scene, cam, 48, 64, 2, 4, 3)
    fresh = pdemo.glossy_scene(cuda_device)
    fresh.materials.albedo.mul_(0.5)
    assert not torch.equal(edited, before)
    assert torch.equal(edited, render(fresh, P.Camera.reference(cuda_device), 48, 64, 2, 4, 3))


@pytest.mark.parametrize("stem", list(RENDERS))
def test_a_reused_pack_queues_nothing_before_the_kernel(cuda_device, stem):
    """Under the profiler, a launch whose operands are reused puts its
    kernel alone on the card: no copy, no fill and no small kernel of the
    packing. A launch that packs puts them there."""
    from torch.autograd import DeviceType

    render = RENDERS[stem]
    scene, cam = pdemo.glossy_scene(cuda_device), P.Camera.reference(cuda_device)
    render(scene, cam, 48, 64, 2, 4, 0)
    torch.cuda.synchronize()

    def on_card(s, c):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            render(s, c, 48, 64, 2, 4, 1)
            torch.cuda.synchronize()
        return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]

    ops = on_card(scene, cam)
    assert len(ops) == 1 and f"{stem}_kernel" in ops[0], ops
    assert len(on_card(pdemo.glossy_scene(cuda_device), cam)) > 1


def test_fused_kernel_rejects_bad_inputs(cuda_device):
    scene, cam = pdemo.demo_scene(cuda_device), P.Camera.reference(cuda_device)
    with pytest.raises(ValueError):
        rg.render_fused(scene, P.Camera.reference("cpu"), 8, 8, 1, 1, 0)
    mixed = dataclasses.replace(scene, sky_color=scene.sky_color.cpu())
    with pytest.raises(ValueError):
        rg.render_fused(mixed, cam, 8, 8, 1, 1, 0)
    launches = tracing.counters()
    with pytest.raises(ValueError, match="cap"):
        rg.render_fused(scene, cam, 8, 8, 1, rg.MAX_BOUNCES + 1, 0)
    assert (tracing.counters() - launches)["launch.render_fused"] == 0
    img, _ = rg.render_fused(scene, cam, 8, 8, 1, rg.MAX_BOUNCES, 0)  # the cap itself runs
    assert torch.equal(img, rk.render_kernel(scene, cam, 8, 8, 1, rg.MAX_BOUNCES, 0))


# -- the physical tier's forward kernel ------------------------------------------


def assert_close_physical(a, b):
    """tests/test_pallas_physical.py's tolerance for kernel against core."""
    err = (a.double().cpu() - b.double().cpu()).abs().flatten()
    assert a.shape == b.shape and bool(torch.isfinite(err).all())
    assert float(torch.quantile(err, 0.99)) < 1e-4
    assert float((err > 1e-3).double().mean()) < 0.01
    assert abs(float(a.double().mean()) - float(b.double().mean())) < 2e-3


def tri_light_mixed_scene(device):
    """A triangle ceiling light, a sphere light and diffuse content: the
    mixed emitter pool of tests/test_pallas_physical.py."""
    b = P.SceneBuilder(sky_color=(0.01, 0.01, 0.02))
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
    return b.build(device)


@pytest.mark.parametrize("name, kw", [
    ("cornell_spheres_scene", {}),
    ("glossy_scene", dict(sample_offset=3)),
    ("diffuse_sphere_scene", {}),  # no emitter: the pick is clamped, the term masked
    ("cornell_spheres_scene", dict(nee=False)),
    ("cornell_spheres_scene", dict(jitter=False)),
    ("tri_light", dict(tri_nee=True, jitter=False)),
    ("tri_light", dict(tri_nee=False)),
    ("glossy_scene", dict(tri_nee=True)),  # the flag with no emissive triangle
])
def test_physical_kernel_matches_twin(cuda_device, name, kw):
    """The kernel ends a path at zero throughput and skips light samples
    that cannot count; the twin runs every round of every path and masks.
    Equal images show that what the kernel skips adds exact zeros."""
    scene = (tri_light_mixed_scene(cuda_device) if name == "tri_light"
             else getattr(pdemo, name)(cuda_device))
    cam = P.Camera.reference(cuda_device)
    launches = tracing.counters()
    args = (scene, cam, 100, 160, 4, 6, 7)
    k, n = rp.render_physical_kernel(*args, count_rounds=True, **kw)
    r, n_twin = rp.render_physical_kernel_reference(*args, count_rounds=True, **kw)
    assert k.device == cuda_device and k.shape == (100, 160, 3)
    assert_close_physical(k, r)
    assert torch.equal(k, rp.render_physical_kernel(*args, **kw))
    assert n == n_twin and 0 < n <= 100 * 160 * 4 * 7
    events = rp.render_physical_kernel(*args, count_events=True, **kw)[1]
    assert events == rp.render_physical_kernel_reference(*args, count_events=True, **kw)[1]
    assert events["rounds"] == n
    assert (tracing.counters() - launches)["launch.render_phys"] == 3
    # the chain to the twin on the CPU
    cpu_scene = (tri_light_mixed_scene("cpu") if name == "tri_light"
                 else getattr(pdemo, name)("cpu"))
    cpu = rp.render_physical_kernel_reference(cpu_scene, P.Camera.reference("cpu"),
                                              24, 40, 2, 4, 5, **kw)
    assert_close_physical(rp.render_physical_kernel(scene, cam, 24, 40, 2, 4, 5, **kw), cpu)


def test_physical_kernel_rejects_mixed_devices(cuda_device):
    scene = pdemo.cornell_spheres_scene(cuda_device)
    launches = tracing.counters()
    with pytest.raises(ValueError):
        rp.render_physical_kernel(scene, P.Camera.reference("cpu"), 8, 8, 1, 1, 0)
    assert (tracing.counters() - launches)["launch.render_phys"] == 0


# -- the physical tier's gradient kernels ----------------------------------------

FUSED_PHYSICAL_CASES = [
    ("cornell_spheres_scene", {}),
    ("glossy_scene", dict(n_em_cap=1, sample_offset=3)),
    ("cornell_spheres_scene", dict(nee=False, n_em_cap=1)),
    ("tri_light", dict(tri_nee=True, n_em_cap=1, tri_em_cap=2, rough_grad=True)),  # all flags
    ("tri_light", dict(tri_nee=True, n_em_cap=3, tri_em_cap=1, jitter=False)),  # above, below
    ("diffuse_sphere_scene", dict(rough_grad=True, n_em_cap=1)),  # no emitter
]


def physical_scene(name, device):
    return tri_light_mixed_scene(device) if name == "tri_light" else getattr(pdemo, name)(device)


@pytest.mark.parametrize("name, kw", FUSED_PHYSICAL_CASES)
def test_fused_physical_kernel_matches_forward_kernel_and_twin(cuda_device, name, kw):
    """The image equals the forward physical kernel's and the twin's bit for
    bit, every plane of the three families the twin's value for value, and
    the executed rounds the twin's: one definition of the arithmetic, no
    FMA contraction, the twin's order of additions."""
    scene, cam = physical_scene(name, cuda_device), P.Camera.reference(cuda_device)
    launches = tracing.counters()
    args = (scene, cam, 100, 160, 4, 6, 7)
    out = pg.render_physical_fused(*args, count_rounds=True, **kw)
    ref = pg.render_physical_fused_reference(*args, count_rounds=True, **kw)
    fwd_kw = {k: v for k, v in kw.items() if k in ("nee", "tri_nee", "jitter", "sample_offset")}
    assert torch.equal(out[0], rp.render_physical_kernel(*args, **fwd_kw))
    assert len(out) == len(ref) == 3 + bool(kw.get("n_em_cap")) + bool(kw.get("tri_em_cap"))
    for a, b in zip(out[:-1], ref[:-1]):
        assert a.device == cuda_device and torch.equal(a, b)
    assert out[-1] == ref[-1] and 0 < out[-1] <= 100 * 160 * 4 * 7
    assert out[-1] >= rp.render_physical_kernel(*args, count_rounds=True, **fwd_kw)[1]
    plain = pg.render_physical_fused(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(plain, out[:-1]))
    assert (tracing.counters() - launches)["launch.render_phys_fused"] == 2


@pytest.mark.parametrize("name, kw", [
    ("cornell_spheres_scene", {}),
    ("glossy_scene", dict(n_em_cap=1, sample_offset=3)),
    ("cornell_spheres_scene", dict(nee=False)),
    ("tri_light", dict(tri_nee=True, n_em_cap=2, jitter=False)),
])
def test_two_pass_kernel_matches_twin_and_fused_contraction(cuda_device, name, kw):
    """The kernel sums in its own fixed order (warps' group sums, then the
    blocks' partial sums), the twin in float64: rtol 2e-4 with an absolute
    floor of 1e-6 of the leaf's scale (the JAX suite's gate between its two
    schemes), against the twin and against the fused kernel's contraction."""
    scene, cam = physical_scene(name, cuda_device), P.Camera.reference(cuda_device)
    launches = tracing.counters()
    g = torch.randn((100, 160, 3), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    d = pg.render_physical_bwd(scene, cam, g, 100, 160, 4, 6, 7, **kw)
    r = pg.render_physical_bwd_reference(scene, cam, g, 100, 160, 4, 6, 7, **kw)
    assert (tracing.counters() - launches)["launch.render_phys_bwd"] == 1
    cap = kw.get("n_em_cap", min(scene.num_spheres, 8)) if kw.get("nee", True) else 0
    fkw = {k: v for k, v in kw.items() if k != "n_em_cap"}
    out = pg.render_physical_fused(scene, cam, 100, 160, 4, 6, 7, n_em_cap=cap, **fkw)
    c = pg.contract_physical_jacobian(scene, out[1], g, 4, jac_geo=out[2] if cap else None)
    for table, leaf in pg._GRAD_LEAVES:
        get = lambda t: getattr(getattr(t, table) if table else t, leaf)
        atol = 1e-6 * max(float(get(r).abs().max()), 1.0)
        if table == "triangles" or leaf == "roughness":
            assert not get(d).any()  # the narrower contract
            continue
        torch.testing.assert_close(get(d), get(r), rtol=2e-4, atol=atol)
        torch.testing.assert_close(get(d), get(c), rtol=2e-4, atol=atol)


def _two_pass_leaves(d):
    return [getattr(getattr(d, t) if t else d, n) for t, n in pg._GRAD_LEAVES
            if t != "triangles" and n != "roughness"]


@pytest.mark.parametrize("name, h, w, kw", [
    ("glossy_scene", 100, 160, dict(n_em_cap=0)),
    ("glossy_scene", 100, 160, dict(n_em_cap="live", sample_offset=3)),
    ("random_spheres_scene", 100, 160, dict(n_em_cap="live")),
    ("random_spheres_scene", 100, 160, dict(n_em_cap=0, jitter=False)),
    ("tri_light", 100, 160, dict(tri_nee=True, n_em_cap="live")),
    ("glossy_scene", 19, 45, dict(n_em_cap="live")),  # a partial warp in every row
])
def test_two_pass_kernel_bits_and_counts(cuda_device, name, h, w, kw):
    """B5 against its twin at rtol 2e-4 and an absolute floor of 1e-6 of the
    leaf's scale; two launches equal bit for bit (every addition's order is
    fixed); the counting instantiation's counts equal the twin's, and its
    cotangents the kernel's."""
    scene, cam = physical_scene(name, cuda_device), P.Camera.reference(cuda_device)
    kw = dict(kw)
    if kw["n_em_cap"] == "live":
        kw["n_em_cap"] = rp.live_emitter_count(scene)
    g = torch.randn((h, w, 3), generator=torch.Generator().manual_seed(4)).to(cuda_device)
    args = (scene, cam, g, h, w, 4, 6, 7)
    launches = tracing.counters()
    d = pg.render_physical_bwd(*args, **kw)
    again = pg.render_physical_bwd(*args, **kw)
    counted, counts = pg.render_physical_bwd(*args, count_sites=True, **kw)
    r, twin_counts = pg.render_physical_bwd_reference(*args, count_sites=True, **kw)
    assert (tracing.counters() - launches)["launch.render_phys_bwd"] == 3
    assert counts == twin_counts
    for a, b, c, ref in zip(*map(_two_pass_leaves, (d, again, counted, r))):
        assert torch.equal(a, b) and torch.equal(a, c)
        torch.testing.assert_close(a, ref, rtol=2e-4, atol=1e-6 * max(float(ref.abs().max()), 1.0))


@pytest.mark.parametrize("variant", sorted(pg.BWD_VARIANTS))
def test_two_pass_measurement_instantiations(cuda_device, variant):
    """Each of B5's measurement instantiations launches and returns finite
    cotangents; the records in shared memory give the kernel's bit for bit
    (the same additions in the same order); none counts as the kernel's
    launch."""
    scene, cam = pdemo.glossy_scene(cuda_device), P.Camera.reference(cuda_device)
    g = torch.randn((37, 45, 3), generator=torch.Generator().manual_seed(5)).to(cuda_device)
    args = (scene, cam, g, 37, 45, 3, 5, 11)
    launches = tracing.counters()
    got = pg.render_physical_bwd_variant(*args, variant, n_em_cap=1)
    grew = tracing.counters() - launches
    assert (grew["launch.render_phys_bwd"], grew["launch.render_phys_bwd.variant"]) == (0, 1)
    assert all(bool(torch.isfinite(x).all()) for x in _two_pass_leaves(got))
    if variant != "sink":
        want = pg.render_physical_bwd(*args, n_em_cap=1)
        assert all(torch.equal(a, b) for a, b in zip(_two_pass_leaves(got), _two_pass_leaves(want)))


def test_physical_vjp_backward_matches_autograd_through_the_eager_tier(cuda_device):
    """Materials, sky and the black sphere light's geometry, at the JAX
    suite's gates (rtol 5e-3, atol 3e-5)."""
    scene, cam = tri_light_mixed_scene(cuda_device), P.Camera.reference(cuda_device)
    g = torch.randn((32, 64, 3), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    launches = tracing.counters()
    grads = []
    for render in (pg.render_physical_kernel_vjp, P.render_physical):
        leaves = [t.clone().requires_grad_() for t in pg._grad_leaves(scene)]
        img = render(pg._with_leaves(scene, leaves), cam, 32, 64, 4, 3, 7, jitter=False)
        grads.append(torch.autograd.grad(img, leaves, g, allow_unused=True))
    assert (tracing.counters() - launches)["launch.render_phys_fused"] == 1
    for (_, leaf), a, b in zip(pg._GRAD_LEAVES, *grads):
        if leaf in ("albedo", "emission_color", "emission_strength", "transparency", "sky_color"):
            torch.testing.assert_close(a, b, rtol=5e-3, atol=3e-5)
        elif leaf in ("center", "radius"):  # the light is sphere 1
            torch.testing.assert_close(a[1], b[1], rtol=5e-3, atol=1e-4 * float(b[1].abs().max()))
            assert not a[0].any()


def test_physical_gradient_kernels_reject_bad_inputs(cuda_device):
    scene, cam = pdemo.cornell_spheres_scene(cuda_device), P.Camera.reference(cuda_device)
    launches = tracing.counters()
    g = torch.ones((8, 8, 3), device=cuda_device)
    with pytest.raises(ValueError):
        pg.render_physical_fused(scene, P.Camera.reference("cpu"), 8, 8, 1, 1, 0)
    with pytest.raises(ValueError):
        pg.render_physical_fused(scene, cam, 8, 8, 1, pg.MAX_BOUNCES + 1, 0)
    with pytest.raises(ValueError):
        pg.render_physical_bwd(scene, cam, g.cpu(), 8, 8, 1, 1, 0)
    with pytest.raises(ValueError):
        pg.render_physical_bwd(scene, cam, g, 8, 8, 1, pg.MAX_BOUNCES + 1, 0)
    grew = tracing.counters() - launches
    assert grew["launch.render_phys_fused"] == grew["launch.render_phys_bwd"] == 0
    out = pg.render_physical_fused(scene, cam, 8, 8, 1, pg.MAX_BOUNCES, 0)
    assert torch.equal(out[0], rp.render_physical_kernel(scene, cam, 8, 8, 1, pg.MAX_BOUNCES, 0))


# -- the speed-of-light kernels ------------------------------------------------


def ulps(a, b):
    ia, ib = (x.contiguous().view(torch.int32).to(torch.int64) for x in (a, b))
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


@pytest.mark.parametrize("kind", ["alu", "sqrt", "trig", "explog"])
def test_calibration_kernel_matches_twin(cuda_device, kind):
    """Within 2 ulp (the card's cosf and log1pf against PyTorch's cos and
    log1p); the alu and sqrt chains bit for bit."""
    from path_tracer_c_tpu_torch.utils import flops

    x = torch.linspace(-1.0, 1.0, 5000, device=cuda_device)
    launches = tracing.counters()
    k = flops.calib_kernel(kind, 4, x)
    r = flops.calib_reference(kind, 4, x)
    assert (tracing.counters() - launches)["launch.calib"] == 1
    assert bool(torch.isfinite(k).all()) and int(ulps(k, r).max()) <= 2
    if kind in ("alu", "sqrt"):
        assert torch.equal(k, r)


def test_op_rates_are_positive(cuda_device):
    from path_tracer_c_tpu_torch.utils import flops

    for kind in ("alu", "sqrt"):
        rate, samples = flops.measure_op_rate(kind, reps=64, iters=2, with_spread=True,
                                              device=cuda_device)
        assert rate > 0 and len(samples) == 2


@pytest.mark.parametrize("h, w", [(19, 45), (100, 160)])
def test_probes_equal_their_twins(cuda_device, h, w):
    from path_tracer_c_tpu_torch.ops import sol_probes as sp

    scene, cam = pdemo.glossy_scene(cuda_device), P.Camera.reference(cuda_device)
    launches = tracing.counters()
    assert torch.equal(sp.sol_null(scene, cam, h, w), sp.sol_null_reference(scene, cam, h, w))
    table, seed = sp.micro_table(cuda_device), torch.tensor([[7]], dtype=torch.int32,
                                                              device=cuda_device)
    ref = sp.sol_micro_reference(table, seed, h, w)
    for hoisted in (False, True):
        assert torch.equal(sp.sol_micro(table, seed, h, w, hoisted), ref)
    grew = tracing.counters() - launches
    assert (grew["launch.sol_null"], grew["launch.sol_micro"]) == (1, 2)


@pytest.mark.parametrize("h, w, kw", [(19, 45, {}), (100, 160, dict(jitter=True, sample_offset=3))])
def test_warp_lane_rounds_match_twin(cuda_device, h, w, kw):
    """The counting instantiation's warp lane-rounds equal the twin's, its
    thread-rounds count_rounds', and its image is unchanged."""
    scene, cam = pdemo.glossy_scene(cuda_device), P.Camera.reference(cuda_device)
    args = (scene, cam, h, w, 4, 8, 7)
    got = rk.render_kernel_round_counts(*args, **kw)
    twin = rk.render_kernel_round_counts_reference(*args, **kw)
    assert got == {k: twin[k] for k in got}
    img, n = rk.render_kernel(*args, count_rounds=True, **kw)
    assert n == got["thread_rounds"] == rk.render_kernel_reference(*args, count_rounds=True, **kw)[1]
    assert torch.equal(img, rk.render_kernel(*args, **kw))
    assert 0 < got["thread_rounds"] <= twin["warp_lane_rounds_regen"]
    assert twin["warp_lane_rounds_regen"] <= twin["warp_lane_rounds"] <= h * w * 4 * 9


# -- the fused kernels' rounds, shapes and measurement instantiations ----------


@pytest.mark.parametrize("h, w, bounces, kw", [
    (19, 45, 5, {}),  # a partial warp in every row
    (100, 160, 8, dict(jitter=True, sample_offset=3)),
    (19, 45, 0, {}),
])
def test_fused_round_counts_match_twins(cuda_device, h, w, bounces, kw):
    """B2's and B4's counting instantiations: thread-rounds equal
    count_rounds and the twin's, warp lane-rounds the twin's per-sample
    grouping (the kernels' schedule), at least its per-lane-total grouping
    (what path regeneration would run)."""
    scene, cam = pdemo.glossy_scene(cuda_device), P.Camera.reference(cuda_device)
    args = (scene, cam, h, w, 4, bounces, 7)
    got = rg.render_fused_round_counts(*args, **kw)
    twin = rg.render_fused_round_counts_reference(*args, **kw)
    assert got == {k: twin[k] for k in got}
    assert got["thread_rounds"] == rg.render_fused(*args, count_rounds=True, **kw)[2]
    assert got["thread_rounds"] <= twin["warp_lane_rounds_regen"] <= got["warp_lane_rounds"]
    pkw = dict(kw, jitter=kw.get("jitter", True))
    got = pg.render_physical_fused_round_counts(*args, **pkw)
    twin = pg.render_physical_fused_round_counts_reference(*args, **pkw)
    assert got == {k: twin[k] for k in got}
    assert got["thread_rounds"] == pg.render_physical_fused(*args, count_rounds=True, **pkw)[-1]
    assert got["thread_rounds"] <= twin["warp_lane_rounds_regen"] <= got["warp_lane_rounds"]


@pytest.mark.parametrize("h, w, spp, bounces", [(19, 45, 4, 0), (37, 45, 2, 31)])
def test_fused_kernels_at_no_bounce_and_the_cap(cuda_device, h, w, spp, bounces):
    """At a ragged size with no bounce and at the bounce cap, B2 and B4
    equal their twins value for value, and their images B1's and B3's."""
    cam = P.Camera.reference(cuda_device)
    scene = mixed_scene(cuda_device)
    args = (scene, cam, h, w, spp, bounces, 7)
    img, jac = rg.render_fused(*args, jitter=True)
    r_img, r_jac = rg.render_fused_reference(*args, jitter=True)
    assert torch.equal(img, r_img) and torch.equal(jac, r_jac)
    assert torch.equal(img, rk.render_kernel(*args, jitter=True))
    tri = tri_light_mixed_scene(cuda_device)
    args = (tri, cam, h, w, spp, bounces, 7)
    kw = dict(tri_nee=True, n_em_cap=1, tri_em_cap=2, rough_grad=True)
    out = pg.render_physical_fused(*args, **kw)
    ref = pg.render_physical_fused_reference(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert torch.equal(out[0], rp.render_physical_kernel(*args, tri_nee=True))


@pytest.mark.parametrize("variant", sorted(rg.VARIANTS.keys() | pg.VARIANTS.keys()))
def test_measurement_variants_match_the_kernels(cuda_device, variant):
    """Each measurement instantiation computes the timed kernel's image and,
    but for the sinks, its planes; none counts as a launch of the kernel."""
    scene, cam = pdemo.cornell_spheres_scene(cuda_device), P.Camera.reference(cuda_device)
    args = (scene, cam, 37, 45, 3, 3, 11)
    launches = tracing.counters()
    b2 = rg.render_fused_variant(*args, variant, jitter=True) if variant in rg.VARIANTS else None
    b4 = (pg.render_physical_fused_variant(*args, variant, n_em_cap=1)
          if variant in pg.VARIANTS else None)
    grew = tracing.counters() - launches
    assert grew["launch.render_fused"] == grew["launch.render_phys_fused"] == 0
    for got, out in ((b2, rg.render_fused(*args, jitter=True)),
                     (b4, pg.render_physical_fused(*args, n_em_cap=1))):
        if got is None:
            continue
        assert torch.equal(got[0], out[0])
        if variant != "sink":
            assert all(torch.equal(a, b) for a, b in zip(got[1:], out[1:]))


# -- B4's pixel-constant planes in slots, its loops and blocks ----------------

# Caps and emitter counts that straddle the budget of B4's slot
# instantiations (``pg.chip_plane_split`` of ``CHIP_PLANE_FLOATS``: in shared
# memory two sphere ordinals, or one triangle ordinal, and the emission planes
# of the emitter materials the rest holds; in local memory whole geometry
# families), with rough_grad, a ragged edge, no bounce and the bounce cap.
# The kernel keeps every plane in device memory: at these cases it is held to
# its twin, and each policy instantiation to it. spheres32 has four sphere
# emitters of four materials; tri_light two triangle emitters of one material
# and a sphere emitter of another.
B4_CASES = [
    ("random_spheres_scene", 48, 64, 2, 3, dict(n_em_cap=1)),  # below the sphere budget
    ("random_spheres_scene", 48, 64, 2, 3, dict(n_em_cap=2)),  # at it; materials above E
    ("random_spheres_scene", 48, 64, 2, 3, dict(n_em_cap=4, rough_grad=True)),  # above it
    ("random_spheres_scene", 48, 64, 2, 3, dict(nee=False, n_em_cap=4)),  # no light sample
    ("tri_light", 48, 64, 2, 4, dict(tri_nee=True, tri_em_cap=1)),  # at the triangle budget
    ("tri_light", 48, 64, 2, 4, dict(tri_nee=True, tri_em_cap=2)),  # above it
    ("tri_light", 48, 64, 2, 4, dict(tri_nee=True, n_em_cap=2, tri_em_cap=2)),  # spheres first
    ("glossy_scene", 19, 45, 4, 8, dict(n_em_cap=1, rough_grad=True)),  # ragged
    ("glossy_scene", 19, 45, 4, 0, dict(n_em_cap=1)),  # no bounce
    ("tri_light", 37, 45, 2, pg.MAX_BOUNCES, dict(tri_nee=True, n_em_cap=1, tri_em_cap=1)),
]


def _b4_case_id(case):
    name, h, w, spp, bounces, kw = case
    return f"{name}-{h}x{w}-{bounces}b-" + "-".join(f"{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("name, h, w, spp, bounces, kw", B4_CASES,
                         ids=[_b4_case_id(c) for c in B4_CASES])
def test_fused_physical_kernel_at_more_caps_matches_twin(cuda_device, name, h, w, spp, bounces,
                                                         kw):
    """B4 against its twin, image and every plane bit for bit, its counted
    rounds, light samples and plane adds by family equal to the twin's, its
    image equal to B3's; two launches equal bit for bit."""
    scene, cam = physical_scene(name, cuda_device), P.Camera.reference(cuda_device)
    args = (scene, cam, h, w, spp, bounces, 7)
    out = pg.render_physical_fused(*args, count_events=True, **kw)
    ref = pg.render_physical_fused_reference(*args, count_events=True, **kw)
    assert len(out) == len(ref) == 3 + bool(kw.get("n_em_cap")) + bool(kw.get("tri_em_cap"))
    for a, b in zip(out[:-1], ref[:-1]):
        assert torch.equal(a, b)
    assert out[-1] == ref[-1]
    fwd_kw = {k: v for k, v in kw.items() if k in ("nee", "tri_nee")}
    assert torch.equal(out[0], rp.render_physical_kernel(*args, **fwd_kw))
    again = pg.render_physical_fused(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, out[:-1]))


@pytest.mark.parametrize("variant", pg.POLICY_VARIANTS)
@pytest.mark.parametrize("name, h, w, spp, bounces, kw",
                         [c for c in B4_CASES if not c[-1].get("rough_grad")],
                         ids=[_b4_case_id(c) for c in B4_CASES if not c[-1].get("rough_grad")])
def test_fused_physical_policies_match_the_kernel(cuda_device, variant, name, h, w, spp, bounces,
                                                   kw):
    """Each instantiation of B4's own policies (the other loops, planes,
    blocks) computes the kernel's image and planes bit for bit, where its
    planes live on chip at budgets of 16, 32 and 48 floats a thread; none
    counts as a launch of the kernel."""
    scene, cam = physical_scene(name, cuda_device), P.Camera.reference(cuda_device)
    args = (scene, cam, h, w, spp, bounces, 7)
    out = pg.render_physical_fused(*args, **kw)
    launches = tracing.counters()
    budgets = (16, 32, 48) if pg.policy(variant)["planes"] != "device" else (None,)
    for floats in budgets:
        got = pg.render_physical_fused_variant(*args, variant, chip_floats=floats, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, out)), (variant, floats)
    assert (tracing.counters() - launches)["launch.render_phys_fused"] == 0


# -- the forward kernels' schedules and table placements -----------------------


def big_table_scene(device):
    """Two spheres, a floor and a wall of 1000 small triangles, every seventh
    a light: tables above the shared budget (csrc/pt_sched.cuh)."""
    b = P.SceneBuilder(sky_color=(0.3, 0.4, 0.6))
    grey = b.add_material(albedo=(0.5, 0.5, 0.5), roughness=0.6)
    lamp = b.add_material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 0.9, 0.8),
                          emission_strength=5.0)
    b.add_sphere(center=(0.0, 0.0, 5.0), radius=1.0, material=grey)
    b.add_sphere(center=(1.5, 1.5, 4.0), radius=0.3, material=lamp)
    b.add_triangle(v0=(-50, -1, -50), v1=(50, -1, -50), v2=(50, -1, 50), material=grey)
    for i in range(1000):
        x, y = i % 40 - 20.0, i // 40 - 12.0
        b.add_triangle(v0=(x, y, 9.0), v1=(x + 0.9, y, 9.0), v2=(x, y + 0.9, 9.0),
                       material=grey if i % 7 else lamp)
    return b.build(device)


FORWARD_CASES = [  # B1 and B3: height, width, spp, bounces, keywords
    (19, 45, 4, 8, {}),  # a partial warp in every row
    (100, 160, 4, 8, dict(jitter=True, sample_offset=3)),
    (19, 45, 4, 0, {}),  # no bounce
    (37, 45, 2, 31, dict(jitter=True)),  # 31 bounces
]
PHYSICAL_FORWARD_CASES = [  # B3 only: scene, keywords
    ("glossy_scene", dict(sample_offset=3)),
    ("cornell_spheres_scene", dict(nee=False)),
    ("tri_light", dict(tri_nee=True, jitter=False)),
    ("mixed", dict(tri_nee=True, sample_offset=64)),
]


def _variant_or_kernel(kernel, variant_fn, variant):
    return kernel if variant is None else (
        lambda *a, **kw: variant_fn(*a[:7], variant, *a[7:], **kw))


@pytest.mark.parametrize("variant", [None, *rk.VARIANTS])
def test_forward_instantiations_equal_the_twins(cuda_device, variant):
    """The timed kernels (variant None) and every other instantiation of B1
    and B3 (csrc/pt_sched.cuh) equal their twins bit for bit: a lane runs its
    samples in order on the same streams, whatever the schedule and wherever
    the tables are read from. Only the timed kernels count in the kernels'
    launches."""
    cam = P.Camera.reference(cuda_device)
    glossy = pdemo.glossy_scene(cuda_device)
    fwd = _variant_or_kernel(rk.render_kernel, rk.render_kernel_variant, variant)
    phys = _variant_or_kernel(rp.render_physical_kernel, rp.render_physical_kernel_variant,
                              variant)
    launches = tracing.counters()
    n = 0
    for h, w, spp, bounces, kw in FORWARD_CASES:
        args = (glossy, cam, h, w, spp, bounces, 7)
        assert torch.equal(fwd(*args, **kw), rk.render_kernel_reference(*args, **kw))
        assert torch.equal(phys(*args, **kw), rp.render_physical_kernel_reference(*args, **kw))
        n += 1
    for name, kw in PHYSICAL_FORWARD_CASES:
        scene = (mixed_scene(cuda_device) if name == "mixed"
                 else physical_scene(name, cuda_device))
        args = (scene, cam, 100, 160, 4, 8, 7)
        assert torch.equal(phys(*args, **kw), rp.render_physical_kernel_reference(*args, **kw))
    grew = tracing.counters() - launches
    grew = (grew["launch.render_fwd"], grew["launch.render_phys"])
    assert grew == ((n, n + len(PHYSICAL_FORWARD_CASES)) if variant is None else (0, 0))


@pytest.mark.parametrize("variant", [None, *rk.VARIANTS])
def test_forward_round_counts_match_twins(cuda_device, variant):
    """Each counting instantiation of B1 and B3 counts thread-rounds equal to
    count_rounds and the twin's, and warp lane-rounds (B3: also those in
    which some lane computes a light sample and runs a shadow scan) equal to
    the twin's grouping for the schedule it runs."""
    cam = P.Camera.reference(cuda_device)
    glossy = pdemo.glossy_scene(cuda_device)
    schedule = rk._warp_key(variant)
    for h, w, spp, bounces, kw in FORWARD_CASES[:3]:
        args = (glossy, cam, h, w, spp, bounces, 7)
        got = rk.render_kernel_round_counts(*args, variant=variant, **kw)
        twin = rk.render_kernel_round_counts_reference(*args, **kw)
        assert set(got) == {"thread_rounds", schedule}
        assert got == {k: twin[k] for k in got}
        assert got["thread_rounds"] == rk.render_kernel(*args, count_rounds=True, **kw)[1]
    for name, kw in [("glossy_scene", FORWARD_CASES[1][4]), *PHYSICAL_FORWARD_CASES]:
        scene = (mixed_scene(cuda_device) if name == "mixed"
                 else physical_scene(name, cuda_device))
        args = (scene, cam, 37, 45, 3, 6, 7)
        got = rp.render_physical_kernel_round_counts(*args, variant=variant, **kw)
        twin = rp.render_physical_kernel_round_counts_reference(*args, **kw)
        assert got == {k: twin[k] for k in got} and len(got) == 6
        assert got["thread_rounds"] == rp.render_physical_kernel(*args, count_rounds=True,
                                                                 **kw)[1]


def test_tables_above_the_shared_budget_are_read_from_device_memory(cuda_device):
    """A scene whose tables exceed the shared budget: the library's bytes
    and budget agree with the wrappers', the shared variants are refused,
    and the timed kernels (with their tables in device memory there) and
    the global variants equal their twins bit for bit."""
    from path_tracer_c_tpu_torch.ops.build import load_library

    lib = load_library()
    cam = P.Camera.reference(cuda_device)
    big = big_table_scene(cuda_device)
    assert lib.render_table_budget() == rk.SHARED_TABLE_BUDGET
    for scene in (pdemo.glossy_scene(cuda_device), big):
        rows = (max(scene.num_spheres, 1), max(scene.num_triangles, 1), scene.num_materials)
        for physical in (False, True):
            assert lib.render_table_bytes(*rows, int(physical)) == rk.table_bytes(scene, physical)
    assert rk.table_bytes(big) > rk.SHARED_TABLE_BUDGET
    args = (big, cam, 19, 45, 3, 4, 7)
    kw = dict(tri_nee=True, jitter=True)
    assert torch.equal(rk.render_kernel(*args), rk.render_kernel_reference(*args))
    assert torch.equal(rp.render_physical_kernel(*args, **kw),
                       rp.render_physical_kernel_reference(*args, **kw))
    for variant in rk.VARIANTS:
        if rk.policy(variant)["tables"] == "shared":
            with pytest.raises(ValueError, match="shared budget"):
                rk.render_kernel_variant(*args, variant)
            with pytest.raises(ValueError, match="shared budget"):
                rp.render_physical_kernel_variant(*args, variant, **kw)
            continue
        assert torch.equal(rk.render_kernel_variant(*args, variant),
                           rk.render_kernel_reference(*args))
        assert torch.equal(rp.render_physical_kernel_variant(*args, variant, **kw),
                           rp.render_physical_kernel_reference(*args, **kw))


# -- the long runs: chunked and resumed renders, the sweep, resumed fits -------


class _Interrupt(Exception):
    pass


def _render_argv(out, engine, path=None):
    argv = ["render", "--scene", "glossy", "--engine", engine, "--width", "96", "--height",
            "64", "--spp", "4", "--max-bounces", "4", "--seed", "3", "--checkpoint-every", "1",
            "--out", str(out)]
    return argv + (["--checkpoint-path", str(path)] if path else [])


@pytest.mark.parametrize("engine, kernel", [("cuda", rk.render_kernel),
                                            ("physical", rp.render_physical_kernel)])
def test_resumed_render_equals_uninterrupted_on_the_card(cuda_device, tmp_path, monkeypatch,
                                                         engine, kernel):
    """Chunks of 1 spp through the kernel, interrupted after the second
    save and resumed: the bytes of the uninterrupted chunked render."""
    from path_tracer_c_tpu_torch.app import main as app
    from path_tracer_c_tpu_torch.utils import checkpoint as ck

    ref, out, path = tmp_path / "ref.bmp", tmp_path / "out.bmp", tmp_path / "r.npz"
    launches = tracing.counters()
    app.main(_render_argv(ref, engine))
    assert (tracing.counters() - launches)[LAUNCH[kernel]] == 4
    real_save = ck.save_render
    saves = []

    def save_then_stop(p, c):
        real_save(p, c)
        saves.append(c.spp_done)
        if len(saves) == 2:
            raise _Interrupt

    monkeypatch.setattr(ck, "save_render", save_then_stop)
    with pytest.raises(_Interrupt):
        app.main(_render_argv(out, engine, path))
    monkeypatch.setattr(ck, "save_render", real_save)
    app.main(_render_argv(out, engine, path))
    assert out.read_bytes() == ref.read_bytes()
    assert (tracing.counters() - launches)[LAUNCH[kernel]] == 8


@pytest.mark.parametrize("spp, offset", [(1, 0), (1, 5), (1, 2**31 - 2), (3, 2**31 - 4)])
def test_forward_kernels_at_chunk_offsets(cuda_device, spp, offset):
    """A chunk of one sample under path regeneration, and the last sample
    offsets the launchers take (``sample_offset < 2**31 - spp``): B1 and B3
    equal their twins bit for bit."""
    scene, cam = pdemo.glossy_scene(cuda_device), P.Camera.reference(cuda_device)
    for kernel, twin in ((rk.render_kernel, rk.render_kernel_reference),
                         (rp.render_physical_kernel, rp.render_physical_kernel_reference)):
        args = (scene, cam, 37, 45, spp, 4, 9)
        assert torch.equal(kernel(*args, sample_offset=offset), twin(*args, sample_offset=offset))
    with pytest.raises(ValueError):
        rk.render_kernel(scene, cam, 8, 8, spp, 1, 0, sample_offset=2**31 - spp)


def test_debug_nans_through_the_kernel(cuda_device, tmp_path):
    from path_tracer_c_tpu_torch.app import main as app
    from path_tracer_c_tpu_torch.scene.io import save_scene

    scene = pdemo.diffuse_sphere_scene("cpu")
    bad = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, emission_strength=torch.full_like(scene.materials.emission_strength,
                                                            float("nan"))))
    save_scene(tmp_path / "nan.json", bad)
    launches = tracing.counters()
    with pytest.raises(FloatingPointError, match="engine cuda"):
        app.main(["render", "--scene", str(tmp_path / "nan.json"), "--width", "32", "--height",
                  "16", "--spp", "1", "--max-bounces", "1", "--debug-nans",
                  "--out", str(tmp_path / "nan.bmp")])
    assert (tracing.counters() - launches)["launch.render_fwd"] == 1


def test_animate_on_the_card(cuda_device, tmp_path):
    """3 frames through the kernel, written by the native writer where it
    builds: frame f is the kernel's render at camera f, seed f."""
    import json

    from path_tracer_c_tpu_torch.app import main as app
    from path_tracer_c_tpu_torch.utils import bitmap, native
    from path_tracer_c_tpu_torch.utils.config import AnimationConfig

    launches = tracing.counters()
    app.main(["animate", "--scene", "demo", "--width", "48", "--height", "32", "--spp", "4",
              "--max-bounces", "3", "--frames", "3", "--out-dir", str(tmp_path / "fr"),
              "--metrics", str(tmp_path / "m.jsonl")])
    assert (tracing.counters() - launches)["launch.render_fwd"] == 3
    *recs, spans = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert recs[-1]["writer"] == ("native" if native.available() else "numpy")
    assert spans["kind"] == "spans" and spans["counters"]["launch.render_fwd"] == 3
    scene = pdemo.demo_scene(cuda_device)
    for f, cam in enumerate(app._orbit_cameras(AnimationConfig(frames=3), cuda_device)):
        img = rk.render_kernel(scene, cam, 32, 48, 4, 3, f)
        data = (tmp_path / "fr" / f"frame_{f:04d}.bmp").read_bytes()
        assert data == bitmap.bitmap_bytes(P.render_image_u8(img).cpu().numpy())


def _fit_case(kind, device):
    from path_tracer_c_tpu_torch.grad import diff

    cam = P.Camera.reference(device)
    if kind == "materials":
        scene = pdemo.random_spheres_scene(device)
        target = rk.render_kernel(scene, cam, 32, 32, 2, 3, 12345)
        init = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, albedo=torch.full_like(scene.materials.albedo, 0.5)))
        return lambda steps, path: diff.fit_materials(
            init, target, cam, 32, 32, 2, 3, steps=steps, engine="cuda",
            checkpoint_path=path, checkpoint_every=2)
    scene = pdemo.cornell_spheres_scene(device)
    target = rp.render_physical_kernel(scene, cam, 32, 32, 4, 3, 1, jitter=False)
    li = int(rp.live_emitter_mask(scene).argmax())
    center = scene.spheres.center.clone()
    center[li] += torch.tensor([0.2, -0.1, 0.1], device=device)
    init = dataclasses.replace(scene, spheres=dataclasses.replace(scene.spheres, center=center))
    return lambda steps, path: diff.fit_geometry(
        init, target, cam, 32, 32, 4, 3, sphere_indices=(li,), steps=steps,
        engine="physical_pallas", checkpoint_path=path, checkpoint_every=2)


@pytest.mark.parametrize("kind, kernel", [("materials", rg.render_fused),
                                          ("geometry", pg.render_physical_fused)])
def test_resumed_fit_equals_uninterrupted_on_the_card(cuda_device, tmp_path, kind, kernel):
    """2 steps, then a resume to 4, through the fused kernel: parameters and
    losses bit for bit those of 4 uninterrupted steps."""
    fit = _fit_case(kind, cuda_device)
    launches = tracing.counters()
    ref, ref_losses = fit(4, None)
    fit(2, tmp_path / "f.npz")
    got, losses = fit(4, tmp_path / "f.npz")
    assert (tracing.counters() - launches)[LAUNCH[kernel]] == 8
    assert losses == ref_losses
    for table in ("materials", "spheres"):
        for a, b in zip(dataclasses.astuple(getattr(got, table)),
                        dataclasses.astuple(getattr(ref, table))):
            assert torch.equal(a, b)


def test_a_geometry_step_maps_its_variables_without_a_host_sync(cuda_device):
    """``apply_geometry_params`` with the index tensors a geometry fit
    builds once makes no copy that waits for the card; with host ints it
    does (the sync debug mode raises on the copy from pageable memory)."""
    from path_tracer_c_tpu_torch.grad import diff

    scene = pdemo.cornell_spheres_scene(cuda_device)
    li = int(rp.live_emitter_mask(scene).argmax())
    params = diff.make_geometry_params(scene, (li,))
    idx, none = diff._index_tensor((li,), cuda_device), diff._index_tensor((), cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        live = diff.apply_geometry_params(scene, params, idx, none)
        with pytest.raises(RuntimeError, match="synchroniz"):
            diff.apply_geometry_params(scene, params, (li,))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(live.spheres.center, scene.spheres.center)


def _eager_fit_case(kind, device):
    """``fit --mode roughness`` or ``--mode geometry`` on its default engine,
    autograd through the eager physical tier, on cornell at 32x32, 4 spp,
    3 bounces."""
    from path_tracer_c_tpu_torch.grad import diff

    cam = P.Camera.reference(device)
    scene = pdemo.cornell_spheres_scene(device)
    target = rp.render_physical_kernel(scene, cam, 32, 32, 4, 3, 1, jitter=False)
    if kind == "roughness":
        init = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, roughness=torch.full_like(scene.materials.roughness, 0.5)))
        return lambda steps, path: diff.fit_materials(
            init, target, cam, 32, 32, 4, 3, steps=steps, engine="physical", rough_grad=True,
            checkpoint_path=path, checkpoint_every=2)
    li = int(rp.live_emitter_mask(scene).argmax())
    center = scene.spheres.center.clone()
    center[li] += torch.tensor([0.2, -0.1, 0.1], device=device)
    init = dataclasses.replace(scene, spheres=dataclasses.replace(scene.spheres, center=center))
    return lambda steps, path: diff.fit_geometry(
        init, target, cam, 32, 32, 4, 3, sphere_indices=(li,), steps=steps, engine="physical",
        checkpoint_path=path, checkpoint_every=2)


@pytest.mark.parametrize("kind", ["roughness", "geometry"])
def test_resumed_eager_fit_equals_uninterrupted_on_the_card(cuda_device, tmp_path, kind):
    """The eager physical tier's fits: two uninterrupted runs of 4 steps,
    and 2 steps then a resume to 4, give the same parameters and losses bit
    for bit."""
    fit = _eager_fit_case(kind, cuda_device)
    ref, ref_losses = fit(4, None)
    again, again_losses = fit(4, None)
    fit(2, tmp_path / "f.npz")
    got, losses = fit(4, tmp_path / "f.npz")
    assert losses == ref_losses == again_losses
    for table in ("materials", "spheres"):
        for a, b, c in zip(dataclasses.astuple(getattr(got, table)),
                           dataclasses.astuple(getattr(ref, table)),
                           dataclasses.astuple(getattr(again, table))):
            assert torch.equal(a, b) and torch.equal(c, b)


def test_eager_physical_gradient_repeats_on_the_card(cuda_device):
    """The eager physical tier's gradient with respect to every float leaf
    of the triangle-lit glossy scene (``utils/geom_asym.eager_grad``, each
    sample recomputed in backward) at 128x128, 4 spp, 4 bounces: the same
    bits on two runs."""
    from path_tracer_c_tpu_torch.utils import geom_asym as ga

    scene, cam = ga.tri_lit_scene(cuda_device), P.Camera.reference(cuda_device)
    shape = (128, 128, 4, 4)
    fn = ga.eager_grad(scene, cam, shape, rp.render_physical_kernel(scene, cam, *shape, 77))
    first, second = fn(1), fn(1)
    assert any(a is not None and bool(a.any()) for a in first)
    for a, b in zip(first, second):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))


@pytest.mark.parametrize("shape", [(7,), (7, 3), (2048, 3)])
def test_row_fetch_backward_repeats_on_the_card(cuda_device, shape):
    """``ops/intersect.rows`` on CUDA tensors at 2^20 rays: ``table[idx]``,
    and a backward (one-hot sums; 2048 rows take several blocks) that gives
    the same bits on two runs, within float32 rounding of the float64 sums:
    1e-6 of each row's sum of |cotangent|."""
    from path_tracer_c_tpu_torch.ops import intersect

    n = 1 << 20
    gen = torch.Generator().manual_seed(5)
    table = torch.randn(shape, generator=gen).to(cuda_device).requires_grad_()
    idx = torch.randint(0, shape[0], (n,), generator=gen)
    g = torch.randn((n, *shape[1:]), generator=gen)
    idx_d, g_d = idx.to(cuda_device), g.to(cuda_device)
    assert torch.equal(intersect.rows(table, idx_d), table.detach()[idx_d])
    a, b = (torch.autograd.grad(intersect.rows(table, idx_d), table, g_d)[0].cpu()
            for _ in range(2))
    assert torch.equal(a, b)
    exact = torch.zeros(shape, dtype=torch.float64).index_add_(0, idx, g.double())
    scale = torch.zeros(shape, dtype=torch.float64).index_add_(0, idx, g.double().abs())
    assert bool(((a.double() - exact).abs() <= 1e-6 * scale).all())


def test_remat_lowers_peak_memory(cuda_device, monkeypatch):
    """``loss_and_grad(engine="core")`` (every float leaf differentiated,
    each sample recomputed in backward) holds less memory at its peak than
    the same call with the recomputation turned off, and its gradient is
    the same."""
    from path_tracer_c_tpu_torch.grad import diff

    scene, cam = pdemo.random_spheres_scene(cuda_device), P.Camera.reference(cuda_device)
    target = rk.render_kernel(scene, cam, 64, 64, 4, 3, 12345)
    real = diff.render_radiance
    peaks, grads = {}, {}
    for remat in (True, False):
        if not remat:
            monkeypatch.setattr(diff, "render_radiance",
                                lambda *a, remat, **k: real(*a, remat=False, **k))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, d_scene = diff.loss_and_grad(scene, target, cam, 64, 64, 4, 3, 1, engine="core")
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated()
        grads[remat] = d_scene.materials.albedo
    assert peaks[True] < peaks[False]
    assert torch.equal(grads[True], grads[False])


# -- row blocks and the parallel layer ------------------------------------------


def _join(outs):
    """Row blocks' outputs joined: images (rows, W, 3) along dim 0, planes
    (n, rows, W) along dim 1, counts and dicts of counts summed."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(outs, dim=0 if first.shape[-1] == 3 else 1)
    if isinstance(first, dict):
        return {k: sum(o[k] for o in outs) for k in first}
    if isinstance(first, tuple):
        return tuple(_join([o[i] for o in outs]) for i in range(len(first)))
    return sum(outs)


def _assert_blocks_equal_whole(fn, args, kw, blocks):
    whole = fn(*args, **kw)
    joined = _join([fn(*args, row_start=r0, rows=n, **kw) for r0, n in blocks])
    whole, joined = ((whole, joined) if isinstance(whole, tuple) else ((whole,), (joined,)))
    for a, b in zip(whole, joined):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), (fn.__name__, kw)


ROW_BLOCK_CASES = [
    (rk.render_kernel, dict(count_rounds=True)),
    (rk.render_kernel_round_counts, {}),
    *((rk.render_kernel_variant, dict(variant=v)) for v in rk.VARIANTS),
    *((rk.render_kernel_round_counts, dict(variant=v)) for v in rk.VARIANTS),
    (rg.render_fused, dict(count_rounds=True)),
    (rg.render_fused_round_counts, {}),
    (rg.render_fused_variant, dict(variant="sink")),
    (rg.render_fused_variant, dict(variant="local_records")),
    (rp.render_physical_kernel, dict(count_events=True)),
    *((rp.render_physical_kernel_variant, dict(variant=v)) for v in rk.VARIANTS),
    *((rp.render_physical_kernel_round_counts, dict(variant=v)) for v in (None, *rk.VARIANTS)),
    (pg.render_physical_fused, dict(n_em_cap=2, count_events=True)),
    (pg.render_physical_fused, dict(rough_grad=True, tri_nee=True, tri_em_cap=1)),
    (pg.render_physical_fused_round_counts, {}),
    *((pg.render_physical_fused_variant, dict(variant=v, n_em_cap=1))
      for v in ("sink", "shared_records")),
    (pg.render_physical_fused, dict(n_em_cap=4, tri_nee=True, tri_em_cap=1, count_events=True)),
    *((pg.render_physical_fused_variant, dict(variant=v, n_em_cap=2, tri_nee=True, tri_em_cap=1))
      for v in pg.POLICY_VARIANTS),
]


@pytest.mark.parametrize("fn, kw", ROW_BLOCK_CASES,
                         ids=[f"{fn.__name__}-{i}" for i, (fn, _) in enumerate(ROW_BLOCK_CASES)])
def test_row_blocks_equal_the_whole_launch(cuda_device, fn, kw):
    """Every render kernel and each of its instantiations over row blocks
    (7 + 12 rows of a ragged 19x45, and 3 x 16 rows of 48x64) equals the
    same rows of the whole launch bit for bit: images, planes and counters
    summed."""
    scene, cam = pdemo.cornell_spheres_scene(cuda_device), P.Camera.reference(cuda_device)
    for h, w, blocks in ((19, 45, [(0, 7), (7, 12)]), (48, 64, [(0, 16), (16, 16), (32, 16)])):
        _assert_blocks_equal_whole(fn, (scene, cam, h, w, 2, 3, 7), kw, blocks)


def test_two_pass_kernel_blocks_sum_to_the_whole(cuda_device):
    scene, cam = pdemo.cornell_spheres_scene(cuda_device), P.Camera.reference(cuda_device)
    g = torch.randn((19, 45, 3), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    whole = pg.render_physical_bwd(scene, cam, g, 19, 45, 2, 3, 7)
    parts = [pg.render_physical_bwd(scene, cam, g[r0:r0 + n], 19, 45, 2, 3, 7, row_start=r0,
                                    rows=n) for r0, n in ((0, 7), (7, 12))]
    for name in ("albedo", "emission_color", "emission_strength", "transparency"):
        ref = getattr(whole.materials, name)
        got = sum(getattr(p.materials, name) for p in parts)
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-6 * max(float(ref.abs().max()), 1.0))


def test_two_pass_kernel_blocks_sum_to_the_whole_with_geometry(cuda_device):
    """The glossy scene with its live emitter's geometry: every leaf of the
    blocks summed against the whole at the same tolerance, and the blocks'
    counts summed equal to the whole's."""
    scene, cam = pdemo.glossy_scene(cuda_device), P.Camera.reference(cuda_device)
    g = torch.randn((40, 70, 3), generator=torch.Generator().manual_seed(6)).to(cuda_device)
    kw = dict(n_em_cap=rp.live_emitter_count(scene), count_sites=True)
    whole, counts = pg.render_physical_bwd(scene, cam, g, 40, 70, 3, 5, 7, **kw)
    parts = [pg.render_physical_bwd(scene, cam, g[r0:r0 + n], 40, 70, 3, 5, 7, row_start=r0,
                                    rows=n, **kw) for r0, n in ((0, 13), (13, 27))]
    assert {k: sum(p[1][k] for p in parts) for k in counts} == counts
    for ref, *got in zip(*(_two_pass_leaves(d) for d in (whole, *(p[0] for p in parts)))):
        torch.testing.assert_close(sum(got), ref, rtol=2e-4,
                                   atol=1e-6 * max(float(ref.abs().max()), 1.0))


def test_row_block_bounds_are_checked_on_the_card(cuda_device):
    scene, cam = pdemo.demo_scene(cuda_device), P.Camera.reference(cuda_device)
    for row_start, rows in ((-1, 2), (0, 0), (18, 2)):
        with pytest.raises(ValueError):
            rk.render_kernel(scene, cam, 19, 45, 1, 1, 0, row_start=row_start, rows=rows)


@pytest.mark.parametrize("engine, fn", [("cuda", rk.render_kernel),
                                        ("physical_pallas", rp.render_physical_kernel)])
def test_render_sharded_on_cuda0_repeated(cuda_device, engine, fn):
    """A mesh laid on one card (cuda:0 repeated): tile-only equals the
    unsharded kernel render bit for bit, a spp split within the JAX suite's
    rtol 1e-6 (tests/test_parallel.py); one launch a slot."""
    from path_tracer_c_tpu_torch import parallel

    scene, cam = pdemo.glossy_scene(cuda_device), P.Camera.reference(cuda_device)
    whole = fn(scene, cam, 64, 96, 8, 4, 3, jitter=False)
    for tile, spp_ax in ((4, 1), (2, 2)):
        mesh = parallel.make_mesh(tile=tile, spp=spp_ax, devices=[cuda_device] * (tile * spp_ax))
        before = tracing.counters()
        img = parallel.render_sharded(scene, cam, 64, 96, 8, 4, 3, mesh, engine=engine)
        assert (tracing.counters() - before)[LAUNCH[fn]] == tile * spp_ax
        if spp_ax == 1:
            assert torch.equal(img, whole)
        else:
            torch.testing.assert_close(img, whole, rtol=1e-6, atol=1e-6)


def test_mesh_larger_than_the_cards_is_refused(cuda_device):
    from path_tracer_c_tpu_torch import parallel

    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"!= {n} devices"):
        parallel.make_mesh(tile=n + 1, spp=1)


# -- launch shapes ---------------------------------------------------------


@pytest.mark.parametrize("shape", ["glossy 19x45/4spp/8b (ragged)",
                                   "glossy 48x80/4spp/8b rows 11-47"])
def test_every_tile_equals_the_default_point(cuda_device, shape):
    """chip_smoke.py phase 18's checks at one shape: B1-B4 at every point
    equal to the default point bit for bit (images, planes, counts), warp
    lane-rounds the twin's under each footprint, B5 within its gate and
    two launches the same bits; B2's 512-thread point fitted at the bounce
    cap."""
    from path_tracer_c_tpu_torch.utils import tile_sweep as ts

    summary = ts.check_tiles(cuda_device, shapes=[shape], log=lambda line: None)
    assert summary["points"]["B1"] == sorted(rk.KIND_TILES["fwd"])
    assert summary["points"]["B5"] == sorted(rk.KIND_TILES["phys_bwd"])
    assert summary["fit"]["fitted"] == "8x32/1x32"


@pytest.mark.parametrize("kind", ["fwd", "fused", "phys", "phys_fused", "phys_bwd"])
def test_tile_sweep_alone_launch_equals_the_call(cuda_device, kind):
    """The sweep's kernel alone (operands packed once, its C entry called
    directly) gives the output that the call as a user makes it gives, at
    the default point and at a point of the sweep library, on the
    triangle-lit scene with tri_nee."""
    from path_tracer_c_tpu_torch.utils import tile_sweep as ts

    scene = ts.scene_named("tri_lit", cuda_device)
    cam = P.Camera.reference(cuda_device)
    shape = (19, 45, 2, 4)
    for point in (None, "8x16/4x8"):
        call = ts._call(kind, scene, cam, shape, point, True)
        alone = ts._alone(kind, scene, cam, shape, point, True)
        ts._same_work(kind, alone(5), call(5), scene, f"{kind} {point}")
