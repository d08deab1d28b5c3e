"""The benchmark's CPU tests: the harness's folder and the checkout's root
on the path, as ``run.py`` puts them, and a cell cut to a test's size."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec, window  # noqa: E402

SEED = 2**31 + 12345  # above 32 signed bits, as the driver's seeds are


def small_cell(name: str, root: Path = ROOT):
    """The cell ``name`` at 24x16 pixels, 2 spp, 2 bounces, fits of 4 steps."""
    cell = spec.cell(name, root)
    cell.config.update(width=24, height=16, spp=2, max_bounces=2)
    if "steps" in cell.traffic:
        cell.traffic["steps"] = 4
    return cell


def small_run(name: str, traced: bool = False, seconds: float = 0.3, root: Path = ROOT,
              seed: int = SEED):
    """A run of the cell at a test's size on the CPU, where the port's
    kernels run as their plain twins."""
    import torch

    return window.Run(small_cell(name, root), seed, seconds, traced, torch.device("cpu"),
                     time.perf_counter())


@pytest.fixture
def cpu_run():
    return small_run
