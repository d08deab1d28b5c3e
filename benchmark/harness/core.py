"""One run of one cell: set-up, the window, the check and the result line.

``run_cell`` is the whole run but for the look for a card, which
``run.py`` makes first; the tests drive it on the CPU, where the port's
kernels run as their plain twins. Its order: the loop's set-up and window
(``loops/<loop>.py``, ``window.py``); the device's peak memory, read
before anything else runs; the program's state freed; the loop's numbers
against the reference, judged by ``check.py``; with ``--trace 1`` the
per-layer metrics (``metrics/<name>.py``) and the trace's breakdown.
``run.py`` then looks for JAX in ``sys.modules`` (``forbidden_modules``).
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from reference import tracer

from . import check, flops
from . import trace as _trace

FORBIDDEN = ("jax", "jaxlib", "flax", "path_tracer_c_tpu")


class Context:
    """What a per-layer metric's reader reads: the trace (``None`` where
    the run was not traced), the benchmark's spans of the units under the
    profiler (``spans``) and of those after it (``untraced``, free of the
    profiler's host cost), the cell, and the events of a kernel counted by
    the reference."""

    def __init__(self, run, window, trace):
        self.run, self.window, self.trace = run, window, trace
        n = window.traced_units
        self.spans = {k: v[:n] for k, v in window.spans.items()}
        self.untraced = {k: v[n:] for k, v in window.spans.items()}
        self._events = {}

    @property
    def cell(self):
        return self.run.cell

    def mean_ms(self, seconds: list):
        return statistics.fmean(seconds) * 1e3 if seconds else None

    def roofline_pct(self, kernel: str):
        """The kernel's least time (``harness/flops.py``, events counted by
        the reference at the inputs the loop's ``count_at`` names) over its
        mean device time a launch in the trace, in percent; ``None`` where
        the trace has no launch of it."""
        counts = self.cell.counts(kernel)
        times = self.trace.kernel_seconds(counts.KERNEL) if self.trace else []
        if not times:
            return None
        at = self.cell.loop().count_at(self.cell, self.run.seed)
        H, W, spp, B = self.run.shape
        if kernel not in self._events:
            scene = tracer.tensors(at["tables"], self.run.device)
            cam = tracer.camera_tensors(at["camera"], self.run.device)
            self._events[kernel], _ = tracer.count_events(
                counts.RENDER, scene, cam, H, W, spp, B, at["seed"], at["jitter"])
        dims = {"spheres": len(at["tables"]["spheres"]["radius"]),
                "triangles": len(at["tables"]["triangles"]["material"]),
                "materials": len(at["tables"]["materials"]["roughness"])}
        least, _ = flops.least_seconds(counts.counts(dims, H, W, spp, self._events[kernel]))
        return 100.0 * least / statistics.fmean(times)

    def idle_pct(self):
        """The share of the traced window in which nothing ran on the card."""
        if self.trace is None or not self.trace.device:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)


def _quartiles(values: list) -> list:
    """Smallest, quartiles and largest of a span's seconds."""
    if len(values) < 2:
        return list(values)
    return [min(values), *statistics.quantiles(values, n=4), max(values)]


def device_info(run, peak: int) -> dict:
    if run.device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
                "count": run.cell.chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(run) -> dict:
    """The result line's object for one run (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, with a trace ``breakdown``, and
    last ``checks``: each number compared with its limit)."""
    loop = run.cell.loop()
    window = loop.run(run)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    trace = _trace.Trace(window.prof) if window.prof is not None else None
    window.prof = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ok, checks = check.judge(loop.numbers(run, window), run.cell.traffic["limits"])
    reference_s = time.perf_counter() - t0
    device = device_info(run, peak)
    result = {"correct": ok, "attempted": window.attempted, "failed": 0}
    if run.traced:
        ctx = Context(run, window, trace)
        metrics = {}
        for m in run.cell.per_layer:
            value = run.cell.reader(m)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["device"] = device
        result["breakdown"] = trace.breakdown()
    else:
        values = {**window.e2e, "setup_s": window.setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in run.cell.end_to_end}
        result["device"] = device
    result["setup_phases"] = {**run.marks, "setup": window.setup_s}
    n = window.traced_units
    result["units"] = {k: _quartiles(v[n:]) for k, v in window.spans.items()}
    if run.traced:
        result["units_traced"] = {k: _quartiles(v[:n]) for k, v in window.spans.items()}
    result["reference_s"] = reference_s
    result["checks"] = checks
    return result
