"""Profiling: ``torch.profiler`` traces and timing.

The counterpart of ``path_tracer_c_tpu/utils/profiling.py``. ``trace()``
records host and device activity around a block and writes a Chrome trace,
the program's spans (``utils/tracing.py``) among its events; ``time_fn`` is
the median time of a call, by CUDA events on the card. The roofline model
(operation counts from the kernels' sources against rates measured on the
card by kernel B6) is ``utils/flops.sol_report``.

The measurement scripts' common ground: ``bench_device`` (the card, or the
CPU only where the caller asks for it), ``card_line`` (the card's name and
power limit, written beside every time) and ``time_fn`` (CUDA events on
the card).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import time

import torch

__all__ = ["trace", "time_fn", "bench_device", "card_line"]


@contextlib.contextmanager
def trace(logdir: str):
    """Record the body with ``torch.profiler`` (the CPU, and CUDA where a
    device is present) and write ``trace.json`` (Chrome trace format) into
    ``logdir``. Yields the profiler, for ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _force(out) -> torch.Tensor:
    """The sum of every tensor in ``out`` (a tensor, or a tuple, list or
    dict of them; other entries skipped): what makes a call's work finish."""
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else (out,))
    return sum(torch.sum(t) for t in items if isinstance(t, torch.Tensor))


def time_fn(fn, *args, warmup: int = 1, iters: int = 3, seeds=None, device=None) -> float:
    """Median seconds of ``iters`` calls of ``fn(*args)`` after ``warmup``
    calls (a first CUDA call also builds the kernels, ``ops/build.py``).
    With ``seeds`` (``warmup + iters`` of them, the warm-up calls' first),
    call i is ``fn(*args, seeds[i])``. Each call's result (a tensor, or a
    tuple, list or dict of them) is summed, which ends its work. On a CUDA
    ``device`` a call is timed by CUDA events on its current stream, from
    before the call to after the sum, then the host waits for the device;
    otherwise by the host's clock, up to the sum's arrival."""
    if seeds is not None and len(seeds) != warmup + iters:
        raise ValueError(f"time_fn: {len(seeds)} seeds for {warmup} + {iters} calls")
    call = (lambda i: fn(*args)) if seeds is None else (lambda i: fn(*args, seeds[i]))
    device = None if device is None else torch.device(device)
    for i in range(warmup):
        float(_force(call(i)))
    times = []
    for i in range(warmup, warmup + iters):
        if device is not None and device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(stream)
            _force(call(i))
            end.record(stream)
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            float(_force(call(i)))
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bench_device(cpu: bool, script: str) -> torch.device:
    """The device a measurement script runs on: the CPU where the caller
    asks for it (``cpu``, the scripts' ``--cpu``), else CUDA device 0.
    Without a CUDA device it raises, naming the missing device: a
    measurement never moves to the CPU by itself."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(f"{script}: no CUDA device (torch.cuda.is_available() is False); "
                         "pass --cpu to run on the CPU")
    return torch.device("cuda", 0)


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (its
    first line); ``"cpu"`` for the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()

