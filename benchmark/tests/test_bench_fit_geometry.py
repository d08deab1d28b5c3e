"""The geometry fit's cell (``loops/fit_geometry.py``) driven on the CPU at a
test's size, where B4 runs as its plain twin: a sound run passes and a
traced one reads the scene's rebuild; the control and the faults the loop
reads on the card fail the cell's numbers; the benchmark's count of B4's
events is the program's; and each fault planted in the port under a whole
run makes ``correct`` false. ``apply_ms.geometry`` reads the program's
``pt.apply.*`` spans on a hand-made trace, and nothing without them."""

from __future__ import annotations

import pytest
import torch
from conftest import SEED, small_cell, small_run
from test_bench_spans import DEVICE, HOST, _context, _read

import controls
from harness import core
from path_tracer_c_tpu_torch.grad import diff
from path_tracer_c_tpu_torch.ops import render_physical_grad as rpg

CELL = "glossy_1024.fit_geometry"


def test_a_sound_run_is_correct():
    result = core.run_cell(small_run(CELL))
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in small_cell(CELL).end_to_end}


def test_a_traced_run_reads_the_scenes_rebuild():
    result = core.run_cell(small_run(CELL, traced=True))
    assert result["correct"], result["checks"]
    assert result["metrics"]["apply_ms.geometry"]["value"] > 0.0


def test_the_control_and_the_faults_fail():
    """bfloat16 in the program's place, and each fault the loop reads on the
    card, fail one of the cell's numbers."""
    cell = small_cell(CELL)
    limits = cell.traffic["limits"]
    for seed in (SEED, 7, 123456789):
        readings = cell.loop().controls(cell, seed, torch.device("cpu"), {"control", "faults"})
        assert [r["reading"] for r in readings] == [
            "control", "fault half_batch", "fault answer_altered", "fault radius_chain_dropped"]
        for reading in readings:
            assert any(reading[k] > limits[k] for k in limits), reading


def test_the_counts_reading():
    """B4's events as the benchmark counts them and as the program does, at
    a test's size: the same events, each counted."""
    reading = controls.counts_reading(small_cell(CELL), SEED, torch.device("cpu"))
    assert set(reading["benchmark"]) == set(reading["program"])
    assert all(v > 0 for v in reading["benchmark"].values())
    assert all(v > 0 for v in reading["program"].values())


def _plant(monkeypatch, fault):
    if fault == "state_unchanged":  # the step computes its loss and updates nothing
        monkeypatch.setattr(diff, "_adam_step", lambda opt, loss_fn: lambda s: loss_fn(s).detach())
    elif fault == "half_batch":  # the loss over every other row, the mean over those
        monkeypatch.setattr(diff, "mse_loss", lambda img, t: torch.mean((img[::2] - t[::2]) ** 2))
    elif fault == "answer_altered":  # every step's render drawn at the next seed
        sound = diff.render_physical_kernel_vjp
        monkeypatch.setattr(diff, "render_physical_kernel_vjp", lambda *a, **kw: sound(
            *a[:6], (a[6] + 1) & 0xFFFFFFFF, *a[7:], **kw))
    else:  # the radius's cone-weight term left out of the cotangent
        sound = rpg._scatter_emitter_geometry

        def scatter(*a):
            d_center, d_radius = sound(*a)
            return d_center, torch.zeros_like(d_radius)
        monkeypatch.setattr(rpg, "_scatter_emitter_geometry", scatter)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered",
                                   "radius_chain_dropped"])
def test_a_fault_makes_the_run_incorrect(monkeypatch, fault):
    _plant(monkeypatch, fault)
    result = core.run_cell(small_run(CELL))
    assert not result["correct"], result["checks"]


def test_the_rebuild_reader():
    """The mean of the ``pt.apply.*`` spans; ``None`` without them or
    without a trace."""
    host = HOST + [(101.0, 101.2, "pt.apply.geometry"), (104.0, 104.4, "pt.apply.geometry")]
    assert _read("apply_ms.geometry", _context(DEVICE, host)) == pytest.approx(300.0, rel=1e-9)
    assert _read("apply_ms.geometry", _context(DEVICE, HOST)) is None
    ctx = _context(DEVICE, host)
    ctx.trace = None
    assert _read("apply_ms.geometry", ctx) is None
