"""PyTorch port: the spans and counters of ``utils/tracing.py`` on the CPU.

A span enters the profiler only while it runs and costs nothing else while
no recording is open; under ``torch.profiler`` the phases of a call are CPU
host events named ``pt.<phase>.<stem>``, siblings that never nest; a
recording sums them by name; the fit loop counts each wait for the device;
the command line's ``--metrics`` ends with the recording's record. The
card's spans (pack, launch, the camera's wait) are held in
``tests/test_torch_cuda.py``.
"""

import sys
import threading
import time

import pytest
import torch
from torch.autograd import DeviceType

import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.app import main as app
from path_tracer_c_tpu_torch.grad import diff
from path_tracer_c_tpu_torch.ops import render_grad as rg
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.utils import tracing
from path_tracer_c_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)

SHAPE = (6, 8, 1, 2)  # height, width, spp, bounces


@pytest.fixture
def small():
    return P.demo.demo_scene("cpu"), P.Camera.reference("cpu")


def _pt_spans(prof) -> list:
    """The ``pt.`` spans of a trace, as (start, end, name) on the host."""
    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name.startswith("pt.")]


def _nested(spans) -> list:
    """Pairs of spans of which the first holds the second."""
    return [(a[2], b[2]) for a in spans for b in spans
            if a is not b and a[0] <= b[0] and b[1] <= a[1]]


def _grad_scene(scene):
    albedo = scene.materials.albedo.clone().requires_grad_()
    return rg.replace_leaves(scene, [("materials", "albedo", albedo)]), albedo


def test_a_span_enters_no_profiler_while_none_runs(small, monkeypatch):
    def refuse(name):
        raise AssertionError(f"the profiler's event {name!r} made with the profiler off")

    monkeypatch.setattr(tracing, "_record", refuse)
    scene, cam = small
    with tracing.span("pt.check.test"):
        pass
    img = P.render_kernel(scene, cam, *SHAPE, 3)
    live, albedo = _grad_scene(scene)
    rg.render_kernel_vjp(live, cam, *SHAPE, 3).sum().backward()
    assert img.shape == (6, 8, 3) and albedo.grad is not None


@pytest.mark.parametrize("call, want", [
    ("render", ["pt.check.render_fwd"]),
    ("vjp", ["pt.check.render_fused"] * 2 + ["pt.contract.render_fused"]),
])
def test_spans_are_sibling_host_events_of_the_trace(small, call, want):
    """A CPU ``render_kernel`` call (the twin: its check), and a CPU
    ``render_kernel_vjp`` forward (the leaves replaced, then the entry's
    checks) and backward (the contraction) under the profiler: named
    ``pt.<phase>.<stem>``, host events with no twin on a device, inside no
    other span."""
    scene, cam = small
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if call == "render":
            P.render_kernel(scene, cam, *SHAPE, 3)
        else:
            live, _ = _grad_scene(scene)
            rg.render_kernel_vjp(live, cam, *SHAPE, 3).sum().backward()
    spans = _pt_spans(prof)
    assert sorted(n for _, _, n in spans) == sorted(want)
    assert {e.device_type for e in prof.events() if e.name in want} == {DeviceType.CPU}
    assert not _nested(spans)


def test_recording_sums_spans_and_counters_add():
    with tracing.recording() as rec:
        for _ in range(3):
            with tracing.span("pt.test.slept"):
                time.sleep(0.002)
        with tracing.span("pt.test.empty"):
            pass
        tracing.count("test.counted", 2)
        tracing.count("test.counted")
        assert rec.counters() == {"test.counted": 3}
    slept = rec.spans()["pt.test.slept"]
    assert slept["count"] == 3 and slept["total_ms"] >= 6.0
    assert 2.0 <= slept["max_ms"] <= slept["total_ms"]
    assert rec.spans()["pt.test.empty"]["count"] == 1
    # A closed recording keeps what it saw; the counters go on.
    before = tracing.counters()
    with tracing.span("pt.test.slept"):
        tracing.count("test.counted")
    assert rec.spans()["pt.test.slept"]["count"] == 3
    assert rec.summary() == {"spans": rec.spans(), "counters": {"test.counted": 3}}
    assert (tracing.counters() - before) == {"test.counted": 1}
    assert tracing.counters()["test.never"] == 0


def test_counters_and_recordings_lose_no_update_across_threads():
    """Autograd runs a backward on a thread of its own: counts and spans from
    many threads at once, switching often, all arrive."""
    threads, n = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = tracing.counters()
        with tracing.recording() as rec:
            def work():
                for _ in range(n):
                    tracing.count("test.threads")
                    with tracing.span("pt.test.threads"):
                        pass

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert (tracing.counters() - before)["test.threads"] == threads * n
    assert rec.spans()["pt.test.threads"]["count"] == threads * n


@pytest.mark.parametrize("with_callback", [True, False])
def test_the_fit_loop_counts_its_waits(small, with_callback):
    """With a callback the loop waits for every step's loss (``wait.loss``
    once a step); without one, once at the end (``wait.flush``)."""
    scene, cam = small
    target = P.render_kernel(scene, cam, *SHAPE, 11)
    seen = []
    before = tracing.counters()
    _, losses = diff.fit_materials(scene, target, cam, *SHAPE, steps=3,
                                   callback=(lambda i, loss: seen.append(i)) if with_callback
                                   else None)
    waits = {k: v for k, v in (tracing.counters() - before).items() if k.startswith("wait.")}
    assert waits == ({"wait.loss": 3} if with_callback else {"wait.flush": 1})
    assert len(losses) == 3 and seen == ([0, 1, 2] if with_callback else [])


def test_a_geometry_step_maps_its_variables_beside_b4():
    """A geometry fit through B4 (here its plain twin) under the profiler and
    a recording: one ``pt.apply.geometry`` a step, neither inside a span of
    B4's wrapper nor holding one; ``planes.render_phys_fused`` counts 12
    geometry planes a live sphere emitter a call."""
    scene = P.demo.random_spheres_scene("cpu", n=9, emissive_every=4)
    cam = P.Camera.reference("cpu")
    n_em = rp.live_emitter_count(scene)
    target = P.render_physical_kernel(scene, cam, *SHAPE, 5, jitter=False)
    before = tracing.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            tracing.recording() as rec:
        diff.fit_geometry(scene, target, cam, *SHAPE, sphere_indices=(0,), steps=2,
                          engine="physical_pallas")
    assert n_em == 3 and rec.spans()["pt.apply.geometry"]["count"] == 2
    spans = _pt_spans(prof)
    assert [n for _, _, n in spans].count("pt.apply.geometry") == 2
    assert any(n.endswith(".render_phys_fused") for _, _, n in spans)
    assert not [pair for pair in _nested(spans) if "pt.apply.geometry" in pair]
    assert (tracing.counters() - before)["planes.render_phys_fused"] == 2 * 12 * n_em


@pytest.mark.parametrize("command", ["render", "fit"])
def test_metrics_end_with_the_spans_record(tmp_path, command):
    """``--metrics``: the command's last record holds each span's count,
    total and largest milliseconds, and what the counters counted."""
    metrics = tmp_path / "m.jsonl"
    size = ["--device", "cpu", "--scene", "diffuse", "--width", "8", "--height", "6",
            "--spp", "1", "--max-bounces", "1", "--metrics", str(metrics)]
    if command == "render":
        app.main(["render", *size, "--out", str(tmp_path / "r.bmp")])
    else:
        app.main(["fit", *size, "--steps", "2"])
    rec = MetricsLogger.read(metrics)[-1]
    assert rec["kind"] == "spans" and set(rec) == {"ts", "kind", "spans", "counters"}
    span = "pt.check.render_fwd" if command == "render" else "pt.check.render_fused"
    got = rec["spans"][span]
    assert got["count"] == (1 if command == "render" else 4)  # a fit step checks twice
    assert 0.0 < got["max_ms"] <= got["total_ms"]
    assert rec["counters"] == ({} if command == "render" else {"wait.loss": 2})
