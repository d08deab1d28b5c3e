"""The comparison that decides ``correct``, driven on the CPU at a test's
size: a sound run passes; the control (the reference in bfloat16 put in
the program's place) and the faults the loop reads on the card fail the
cell's numbers; and each fault a cell can have, planted in the port under
a whole run, makes ``correct`` false. The faults are chosen by the traffic
mix's loop and planted at its entry."""

from __future__ import annotations

import importlib
import json
import subprocess
import sys

import pytest
import torch
from conftest import ROOT, SEED, small_cell, small_run

import controls
from harness import core

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = core.run_cell(small_run(name))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"] for m in small_cell(name).end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_and_the_faults_fail(name):
    """bfloat16 in the program's place, and each fault the loop reads on
    the card, fail one of the cell's numbers."""
    cell = small_cell(name)
    limits = cell.traffic["limits"]
    for seed in (SEED, 7, 123456789):
        readings = cell.loop().controls(cell, seed, torch.device("cpu"), {"control", "faults"})
        assert readings[0]["reading"] == "control"
        for reading in readings:
            assert any(reading[k] > limits[k] for k in limits), reading


@pytest.mark.parametrize("name", CELLS)
def test_the_counts_reading(name):
    """The benchmark's count of the kernel's events and the program's, at a
    test's size: the same events, each counted."""
    reading = controls.counts_reading(small_cell(name), SEED, torch.device("cpu"))
    assert set(reading["benchmark"]) == set(reading["program"])
    assert all(v > 0 for v in reading["benchmark"].values())
    assert all(v > 0 for v in reading["program"].values())


def _entry(monkeypatch, traffic, broken):
    """Put ``broken(sound)`` in the place of the traffic mix's entry."""
    module, _, fn = traffic["entry"].partition(":")
    module = importlib.import_module(module)
    monkeypatch.setattr(module, fn, broken(getattr(module, fn)))


def _render_fault(fault):
    def broken(sound):
        def render(scene, camera, H, W, spp, B, seed, **kw):
            if fault == "answer_altered":  # the frame drawn at the next seed
                return sound(scene, camera, H, W, spp, B, (seed + 1) & 0xFFFFFFFF, **kw)
            if fault == "half_batch":  # half the samples
                return sound(scene, camera, H, W, max(spp // 2, 1), B, seed, **kw)
            img = sound(scene, camera, H, W, spp, B, seed, **kw).clone()
            if fault == "tile_dropped":  # one 8x16 tile of pixels never written
                img[-8:, -16:] = -1.0
            else:  # one pixel never written
                img[-1, -1] = -1.0
            return img
        return render
    return broken


def _fit_fault(monkeypatch, traffic, fault):
    module = importlib.import_module(traffic["entry"].partition(":")[0])
    if fault == "state_unchanged":  # the step computes its loss and updates nothing
        monkeypatch.setattr(module, "_adam_step",
                            lambda opt, loss_fn: lambda s: loss_fn(s).detach())
    elif fault == "half_batch":  # the loss over every other row, the mean over those
        monkeypatch.setattr(module, "mse_loss",
                            lambda img, t: torch.mean((img[::2] - t[::2]) ** 2))
    else:  # every step's render drawn at the next seed
        sound = module.render_kernel_vjp
        monkeypatch.setattr(module, "render_kernel_vjp",
                            lambda *a: sound(*a[:6], (a[6] + 1) & 0xFFFFFFFF, *a[7:]))


FAULTS = {"render": ("half_batch", "answer_altered", "tile_dropped", "pixel_dropped"),
          "fit_materials": ("state_unchanged", "half_batch", "answer_altered")}


@pytest.mark.parametrize("name,fault", [
    (c, f) for c in CELLS for f in FAULTS[small_cell(c).traffic["loop"]]])
def test_a_fault_makes_the_run_incorrect(monkeypatch, name, fault):
    traffic = small_cell(name).traffic
    if traffic["loop"] == "render":
        _entry(monkeypatch, traffic, _render_fault(fault))
    else:
        _fit_fault(monkeypatch, traffic, fault)
    result = core.run_cell(small_run(name))
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of each cell through ``run.py`` on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in CELLS:
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                              str(SEED), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                             capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
