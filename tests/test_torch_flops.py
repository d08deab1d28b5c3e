"""PyTorch port: operation accounting (``utils/flops.py``), the calibration
kernel's twin (B6) against the JAX package's kernel, ``sol_report``, and
``utils/profiling.py``.

Tolerances. The calibration twin against the Pallas kernel run in interpret
mode: rtol 1e-6 and atol 1e-6, because XLA:CPU and PyTorch may round cos and
log1p differently in the last place (each chain converges, so a difference
stays there); the alu and sqrt chains agree bit for bit. Everything else is
exact: counts are integers, and the bound arithmetic is held to the
arithmetic ``chip_smoke.py`` used before the counts moved here.
"""

import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from path_tracer_c_tpu.utils import flops as jflops
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.ops import render_grad as rg
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
from path_tracer_c_tpu_torch.utils import flops, profiling, tracing

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kind", ["alu", "sqrt", "trig", "explog"])
def test_calib_twin_matches_the_pallas_kernel(kind):
    """B6's twin against ``_calib_kernel`` run by Pallas in interpret mode
    with the in-specs of ``measure_vpu_rate``, 8 rounds of 16 steps on a
    (64, 128) input from a seed."""
    x = np.random.default_rng(6).uniform(-1.0, 1.0, (64, 128)).astype(np.float32)
    want = pl.pallas_call(
        partial(jflops._calib_kernel, kind=kind),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray([8], jnp.int32), jnp.asarray(x))
    launches = tracing.counters()
    got = flops.calib_kernel(kind, 8, torch.from_numpy(x).reshape(-1)).reshape(x.shape).numpy()
    assert (tracing.counters() - launches)["launch.calib"] == 0  # the twin ran
    want = np.asarray(want)
    print(f"{kind}: exact share {np.mean(got == want):.6f}")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if kind in ("alu", "sqrt"):
        np.testing.assert_array_equal(got, want)


def test_calib_ops_and_probe_counts():
    assert flops.calib_ops("alu", 8, 100)["alu"] == 100 * 8 * 16 * 4
    sq = flops.calib_ops("sqrt", 8, 100)
    assert (sq["sqrt"], sq["alu"], sq["trig"]) == (100 * 8 * 16, 100 * 8 * 16, 0)
    ex = flops.calib_ops("explog", 2, 10)
    assert (ex["explog"], ex["alu"], ex["transcendental"]) == (320, 640, 320)
    # B8 at 1024^2: 200 x 8 x 6 operations a pixel, 0.150 ms at 67 TFLOP/s.
    micro = flops.probe_op_counts("sol_micro", 1024, 1024)
    assert micro["alu"] == 9600 * 1024 * 1024
    ms, by = flops.bound_ms(micro)
    assert by == "operations" and ms == pytest.approx(0.15024, abs=1e-5)
    # B7: 12 bytes a pixel, 3.76 us at 3.35 TB/s.
    ms, by = flops.bound_ms(flops.probe_op_counts("sol_null", 1024, 1024))
    assert by == "bytes" and ms == pytest.approx(12 * 2**20 / 3.35e9, rel=1e-6)


def test_count_ops_simple():
    """The counterpart of tests/test_utils.py's exact count."""
    c = flops.count_ops(lambda x: torch.sum(torch.sqrt(x * 2.0 + 1.0)), torch.ones((8, 16)))
    assert c["alu"] == 128 * 2 + 128  # mul + add + reduce
    assert c["transcendental"] == c["sqrt"] == 128
    assert c["unknown"] == 0 and c["unknown_prims"] == []


def test_count_ops_counts_the_trips_taken():
    """PyTorch runs eagerly: a loop counts the trips it took (the JAX walker
    needs ``while_trips``)."""
    def f(x):
        for _ in range(5):
            x = x * 2.0
        while float(x.sum()) < 200.0:
            x = x + 1.0
        return x

    c = flops.count_ops(f, torch.ones(4))
    # 5 x 4 multiplies; 18 trips of 4 adds; 19 sums of 4 elements
    assert c["alu"] == 20 + 18 * 4 + 19 * 4, c
    assert c["unknown"] == 0


def test_count_ops_covers_the_forward_twin():
    """Every aten operation of B1's twin is classified (the counterpart of
    test_kernel_op_counts_covers_all_prims), and its per-ray-bounce ALU
    count sits in the JAX test's band."""
    scene, cam = P.demo.glossy_scene("cpu"), P.Camera.reference("cpu")
    c = flops.count_ops(rk.render_kernel_reference, scene, cam, 8, 16, 2, 3, 1)
    assert c["unknown"] == 0, c["unknown_prims"]
    per_ray_bounce = c["alu"] / (8 * 16 * 2 * 4)
    assert 500 < per_ray_bounce < 2500, per_ray_bounce
    assert c["sqrt"] > 0 and c["explog"] == 0


def test_count_ops_classes():
    x = torch.linspace(0.1, 1.0, 10)
    c = flops.count_ops(lambda v: torch.cos(v) + torch.log1p(v) + v.pow(2) + torch.exp(v), x)
    assert (c["trig"], c["explog"], c["alu"]) == (10, 20, 10 + 30)
    c = flops.count_ops(lambda v: torch.special.zeta(v, v), x)
    assert c["unknown"] == 10 and c["unknown_prims"] == ["special_zeta"]


# The parent's bound arithmetic (chip_smoke.py before the counts moved to
# utils/flops.py), transcribed with its per-event totals.
OLD = dict(sphere=29, triangle=61, hit_rest=25, shade=138, sweep=24, phys_hit=54,
           phys_diffuse=65, phys_mirror=9, phys_light=139, phys_shadow_rest=10, pf_sweep=27,
           pf_sweep_valid=18, pf_sweep_rough=9, cone_adjoint=180, pf_geo_planes=33,
           pb_sweep=43, pb_sweep_valid=27, pb_geo=20)


def old_reference_ops(scene, pixels_spp, rounds, fused):
    hit = max(rounds - pixels_spp, 0)
    ops = (rounds * (scene.num_spheres * OLD["sphere"] + scene.num_triangles * OLD["triangle"]
                     + OLD["hit_rest"]) + hit * OLD["shade"])
    return ops + (hit * OLD["sweep"] if fused else 0)


def old_physical_ops(scene, pixels_spp, ev):
    scan = scene.num_spheres * OLD["sphere"] + scene.num_triangles * OLD["triangle"]
    hit = max(ev["rounds"] - pixels_spp, 0)
    return (ev["rounds"] * (scan + OLD["hit_rest"]) + hit * OLD["phys_hit"]
            + ev["diffuse_vertices"] * OLD["phys_diffuse"]
            + max(hit - ev["diffuse_vertices"], 0) * OLD["phys_mirror"]
            + ev["light_samples"] * OLD["phys_light"]
            + ev["shadow_scans"] * (scan + scene.num_spheres + scene.num_triangles
                                    + OLD["phys_shadow_rest"]))


def old_fused_physical_ops(scene, pixels_spp, ev, fwd, geom, rough):
    hit = max(ev["rounds"] - pixels_spp, 0)
    return (old_physical_ops(scene, pixels_spp, {**fwd, "rounds": ev["rounds"]})
            + hit * (OLD["pf_sweep"] + (OLD["pf_sweep_rough"] if rough else 0))
            + ev["valid_samples"] * (OLD["pf_sweep_valid"] + (
                (OLD["cone_adjoint"] + OLD["pf_geo_planes"]) if geom else 0)))


def old_bwd_ops(scene, pixels_spp, ev, fwd, n_em_cap):
    hit = max(ev["rounds"] - pixels_spp, 0)
    return (old_physical_ops(scene, pixels_spp, {**fwd, "rounds": ev["rounds"]})
            + hit * OLD["pb_sweep"] + ev["valid_samples"] * (OLD["pb_sweep_valid"] + (
                (OLD["cone_adjoint"] + OLD["pb_geo"]) if n_em_cap else 0)))


@pytest.fixture(scope="module")
def small_events():
    """The twins' counted events on the glossy scene at 12x20, 2 spp, 3
    bounces, seed 1 (the counting instantiations report the same)."""
    scene, cam = P.demo.glossy_scene("cpu"), P.Camera.reference("cpu")
    args = (scene, cam, 12, 20, 2, 3, 1)
    n_live = rp.live_emitter_count(scene)
    return {
        "scene": scene, "n_live": n_live,
        "forward": {"rounds": rk.render_kernel_reference(*args, count_rounds=True)[1]},
        "fused": {"rounds": rg.render_fused_reference(*args, count_rounds=True)[2]},
        "physical": rp.render_physical_kernel_reference(*args, count_events=True)[1],
        "physical_fused": pg.render_physical_fused_reference(
            *args, count_events=True, n_em_cap=n_live)[-1],
    }


# Pinned totals at that shape: (kind, events key, keywords, operations, bytes).
PINNED = [
    ("forward", "forward", {}, 758123, 3936),
    ("fused", "fused", {}, 775235, 136416),
    ("physical", "physical", {}, 934252, 4324),
    ("physical_fused", "physical_fused", {}, 956878, 136804),
    ("physical_fused_geom", "physical_fused", {"n_em_cap": 1}, 983077, 148324),
    ("physical_fused", "physical_fused", {"rough_grad": True}, 963682, 180004),
    ("physical_bwd", "physical_fused", {"n_em_cap": 1}, 994681, 5032),
    ("physical_bwd", "physical_fused", {}, 970081, 5032),
]


@pytest.mark.parametrize("kind, key, kw, ops, nbytes", PINNED)
def test_kernel_op_counts_keep_the_parent_arithmetic(small_events, kind, key, kw, ops, nbytes):
    """Each kind's classes sum to the parent's bound arithmetic for the
    same events, the data-sheet bound is the parent's, and the totals are
    pinned; trig and explog are 0 (the kernels call no cosf or logf)."""
    ev, scene = small_events, small_events["scene"]
    events = ev[key]
    extra = {"fwd_events": ev["physical"]} if kind.startswith("physical_") else {}
    if kw.get("n_em_cap"):
        kw = {**kw, "n_em_cap": ev["n_live"]}
    c = flops.kernel_op_counts(kind, scene, 12, 20, 2, 3, events, **extra, **kw)
    total = sum(c[k] for k in flops.CLASSES)
    pix_spp = 12 * 20 * 2
    if kind in ("forward", "fused"):
        old = old_reference_ops(scene, pix_spp, events["rounds"], kind == "fused")
    elif kind == "physical":
        old = old_physical_ops(scene, pix_spp, events)
    elif kind == "physical_bwd":
        old = old_bwd_ops(scene, pix_spp, events, ev["physical"], kw.get("n_em_cap", 0))
    else:
        old = old_fused_physical_ops(scene, pix_spp, events, ev["physical"],
                                     kind == "physical_fused_geom", kw.get("rough_grad", False))
    assert total == old
    assert (total, c["bytes"]) == (ops, nbytes)
    assert c["trig"] == c["explog"] == 0 and c["sqrt"] > 0
    assert c["transcendental"] == c["sqrt"]
    assert flops.bound_ms(c)[0] == max(old / 67e12, nbytes / 3.35e12) * 1e3


def test_nominal_basis_counts_every_round(small_events):
    scene = small_events["scene"]
    nominal = 12 * 20 * 2 * 4
    c = flops.kernel_op_counts("forward", scene, 12, 20, 2, 3, small_events["forward"],
                               basis="nominal")
    assert sum(c[k] for k in flops.CLASSES) == old_reference_ops(scene, 480, nominal, False)
    executed = flops.kernel_op_counts("forward", scene, 12, 20, 2, 3, small_events["forward"])
    assert c["alu"] > executed["alu"]
    with pytest.raises(ValueError):
        flops.kernel_op_counts("forward", scene, 12, 20, 2, 3, small_events["forward"],
                               basis="tile")
    with pytest.raises(ValueError):
        flops.kernel_op_counts("physical_bwd", scene, 12, 20, 2, 3, small_events["forward"])


def test_sol_report_is_the_counts_over_the_rates(small_events):
    scene = small_events["scene"]
    rates = {"alu": 3e13, "sqrt": 4e12, "trig": 1e12, "explog": 2e12}
    rep = flops.sol_report("physical", scene, 12, 20, 2, 3, 1e-3, small_events["physical"],
                           alu_rate=rates["alu"],
                           transc_rate={k: rates[k] for k in ("sqrt", "trig", "explog")})
    c = flops.kernel_op_counts("physical", scene, 12, 20, 2, 3, small_events["physical"])
    assert rep["sol_seconds"] == pytest.approx(c["alu"] / 3e13 + c["sqrt"] / 4e12, rel=1e-12)
    assert rep["sol_fraction"] == pytest.approx(rep["sol_seconds"] / 1e-3, rel=1e-12)
    assert (rep["alu_ops"], rep["sqrt_ops"], rep["trig_ops"], rep["explog_ops"]) == (
        c["alu"], c["sqrt"], 0, 0)
    assert rep["unknown_ops"] == 0 and rep["unknown_prims"] == []
    assert rep["sustained_alu_ops_per_sec"] == pytest.approx(c["alu"] / 1e-3)
    blended = flops.sol_report("physical", scene, 12, 20, 2, 3, 1e-3, small_events["physical"],
                               alu_rate=3e13, transc_rate=4e12)
    assert blended["sol_seconds"] == pytest.approx(rep["sol_seconds"])
    ms, by = flops.measured_bound_ms(c, rates)
    assert by == "operations" and ms == pytest.approx(rep["sol_seconds"] * 1e3)


def test_kernels_call_no_trig_or_log():
    """The render kernels and probes take roots only: no cosf, sinf, logf,
    log1pf, expf or powf outside the calibration kernel."""
    csrc = REPO / "path_tracer_c_tpu_torch" / "csrc"
    pattern = re.compile(r"\b(cosf|sinf|logf|log1pf|expf|powf)\s*\(")
    sources = sorted(csrc.glob("*.cu*"))
    assert len(sources) >= 9
    for path in sources:
        found = pattern.findall(path.read_text())
        if path.name == "calib.cu":
            assert set(found) == {"cosf", "log1pf"}
        else:
            assert not found, (path.name, found)


def test_measuring_a_rate_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        flops.measure_op_rate("alu", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        flops.measure_op_rates(device="cpu")
    with pytest.raises(ValueError):
        flops.calib_kernel("fma", 1, torch.ones(4))


def test_time_fn_and_trace(tmp_path):
    t = profiling.time_fn(lambda x: x * 2, torch.ones(16), warmup=1, iters=3)
    assert t >= 0
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("cumsum" in e.key for e in prof.key_averages())
