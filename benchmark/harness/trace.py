"""The traced window: ``torch.profiler`` around the measured loop, and what
the per-layer metrics read from it.

The window is marked by a ``record_function`` span of the benchmark's own
(``WINDOW``). From the profiler's events it keeps the device's activity
(kernels, copies and sets, on the card's streams) and the host's
operations, each as (start, end, name) in seconds on the profiler's clock.
"""

from __future__ import annotations

import bisect
import contextlib
import re

import torch
from torch.autograd import DeviceType

WINDOW = "bench.window"


@contextlib.contextmanager
def profiled(enabled: bool):
    """``torch.profiler`` over the body (the host, and the card where there
    is one), yielding the profiler, or ``None`` where ``enabled`` is false."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def short_name(name: str, most: int = 96) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    argument list (the first parenthesis outside template brackets), cut
    to ``most`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    name = name.strip()
    return (name[5:] if name.startswith("void ") else name)[:most]


def _merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The events of one traced window.

    ``device``: the card's activities inside the window; ``host``: the
    host's operations inside it, on every thread; ``busy_s``: the time in
    which some activity ran on the card; ``window_s``: the window's
    length."""

    def __init__(self, prof):
        events = prof.events()
        marks = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
        if not marks:
            raise RuntimeError(f"the traced window holds no {WINDOW!r} span")
        w = marks[0].time_range
        self.start, self.end = w.start * 1e-6, w.end * 1e-6
        self.window_s = self.end - self.start
        self.device, self.host = [], []
        self._spans = {e.name for e in events if e.device_type == DeviceType.CPU
                       and getattr(e, "is_user_annotation", False)} | {WINDOW}
        for e in events:
            s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if t <= self.start or s >= self.end or t <= s:
                continue
            s, t = max(s, self.start), min(t, self.end)
            if e.device_type == DeviceType.CUDA:
                # A record_function span has a twin on the device's timeline
                # (a user annotation over its kernels): no activity of its own.
                if not getattr(e, "is_user_annotation", False) and e.name not in self._spans:
                    self.device.append((s, t, e.name))
            elif e.device_type == DeviceType.CPU and e.name != WINDOW:
                self.host.append((s, t, e.name))
        self.busy = _merge((s, t) for s, t, _ in self.device)
        self.busy_s = sum(t - s for s, t in self.busy)

    def kernel_seconds(self, pattern: str) -> list:
        """Durations of the device activities whose name the regular
        expression ``pattern`` matches."""
        rx = re.compile(pattern)
        return [t - s for s, t, n in self.device if rx.search(n)]

    def host_seconds(self, name: str) -> list:
        """Durations of the host operations named ``name``."""
        return [t - s for s, t, n in self.host if n == name]

    def gaps(self):
        """The card's idle intervals inside the window."""
        out, at = [], self.start
        for s, t in self.busy:
            if s > at:
                out.append((at, s))
            at = max(at, t)
        if self.end > at:
            out.append((at, self.end))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by name, summed), and
        the card's idle time by what the host was doing meanwhile: the
        shortest outermost host operation spanning the gap's middle, or
        ``"(host outside any operation)"``."""
        ops = {}
        for s, t, n in self.device:
            n = short_name(n)
            ops[n] = ops.get(n, 0.0) + (t - s)
        outer = []  # outermost host operations of each thread's nesting
        for s, t, n in sorted(self.host, key=lambda h: (h[0], -h[1])):
            if not outer or s >= outer[-1][1] or t > outer[-1][1]:
                outer.append((s, t, n))
        starts = [o[0] for o in outer]
        idle = {}
        for s, t in self.gaps():
            mid = 0.5 * (s + t)
            i = bisect.bisect_right(starts, mid)
            cover = [o for o in outer[max(0, i - 64):i] if o[1] >= mid]
            name = min(cover, key=lambda o: o[1] - o[0])[2] if cover else \
                "(host outside any operation)"
            idle[name] = idle.get(name, 0.0) + (t - s)
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
