"""Spans and counters: where the program's host time goes, and what ran.

``span(name)`` marks one phase of the host's work. While ``torch.profiler``
runs, a span is a host event of the profiler's trace, on the same clock as
the card's kernels and copies. It is a ``_RecordFunctionFast``, which leaves
no twin on the card's timeline and costs the profiled host about an eighth
of a ``record_function``. While a ``recording()`` block
is open, the span's duration (``time.perf_counter_ns``) is added to the
block's summary: count, total and largest, by name. Otherwise a span costs
two checks. Spans never nest, but for a library's build, which runs inside
the first call that needs it: each is a sibling over one phase of one call,
so that a trace names the phase, not a call around it.

Span names are ``pt.<phase>.<stem>``, the stem a kernel's source
(``csrc/<stem>.cu``):

- ``pt.check.<stem>``: the inputs' checks and the launch shape's fit (also
  on the plain twins' path);
- ``pt.pack.<stem>``: the library loaded (built on its first use), the
  scene's operands; for B1 and B3 the lookups of the scene's tables and the
  camera's parameters (``ops/pack_cache.py``) and the tables packed on a
  miss;
- ``pt.launch.<stem>``: the outputs and counters allocated, the launch's
  arguments, the entry's lookup, the call into the library and its error
  check;
- ``pt.contract.<stem>``: an autograd backward, the Jacobian's contraction;
- ``pt.apply.<variables>``: a fit's variables mapped onto its scene before
  the render (``geometry``: ``grad/diff.fit_geometry``'s spheres and
  triangles);
- ``pt.wait.<site>``: the host waiting for the device (a launch's camera
  parameters, copied from pageable memory, for B1 and B3 on a miss only;
  the fit loop's loss readbacks; a counting launch's counters; a
  checkpoint's save);
- ``pt.build.<library>``: a library compiled (``ops/build.py``,
  ``utils/native.py``).

``count(name, n)`` adds to a counter of the process; counters are always
on and ``counters()`` reads them: ``launch.<stem>`` (a launch of the timed
kernel or its counting instantiation), ``launch.<stem>.variant`` (of a
measurement instantiation), ``launch.<probe>`` (``sol_null``,
``sol_micro``, ``calib``), ``wait.<site>``, ``build.<library>``, and
``pack.hit.<stem>`` and ``pack.miss.<stem>`` (a launch of B1 or B3 that
reused or packed the scene's tables; a camera's miss counts in
``wait.camera_params``), and ``planes.render_phys_fused`` (the geometry
planes a call of B4, or of its plain twin, writes: 12 a tracked sphere
emitter, 27 a tracked triangle emitter).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter

import torch
from torch.autograd import profiler as _profiler

_record = torch._C._profiler._RecordFunctionFast

__all__ = ["span", "wait", "count", "counters", "recording", "Record"]

_COUNTS: Counter = Counter()
_OPEN: list = []  # the open recordings
# Autograd runs a backward on a thread of its own: what is read, changed and
# written back (a counter, a recording's sums) is changed under this lock.
_LOCK = threading.Lock()


class span:
    """One phase of the host's work: ``with span("pt.pack.render_fwd"):``."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._rf = _record(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self._t0 = time.perf_counter_ns() if _OPEN else None
        return self

    def __exit__(self, kind, value, tb):
        if self._t0 is not None:
            ns = time.perf_counter_ns() - self._t0
            with _LOCK:
                for rec in _OPEN:
                    rec._add(self.name, ns)
        if self._rf is not None:
            self._rf.__exit__(kind, value, tb)
        return False


def wait(site: str) -> span:
    """The span ``pt.wait.<site>``, counted in ``wait.<site>``: the host
    waits for the device there."""
    count("wait." + site)
    return span("pt.wait." + site)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _LOCK:
        _COUNTS[name] += n


def counters() -> Counter:
    """A copy of every counter; a name never counted reads 0, and
    ``counters() - before`` is what was counted since ``before``."""
    with _LOCK:
        return Counter(_COUNTS)


class Record:
    """What a ``recording()`` block saw: its spans' durations by name, and
    what the counters counted while it was open."""

    def __init__(self):
        self._spans: dict = {}  # name -> [count, total ns, largest ns]
        self._base = counters()
        self._end: Counter | None = None

    def _add(self, name: str, ns: int) -> None:
        s = self._spans.get(name)
        if s is None:
            self._spans[name] = [1, ns, ns]
        else:
            s[0] += 1
            s[1] += ns
            s[2] = max(s[2], ns)

    def spans(self) -> dict:
        """``{name: {"count", "total_ms", "max_ms"}}``, by name."""
        return {name: {"count": c, "total_ms": total / 1e6, "max_ms": most / 1e6}
                for name, (c, total, most) in sorted(self._spans.items())}

    def counters(self) -> dict:
        """What each counter counted from the block's start to its end (to
        now while it is open), by name; counters that did not move are
        left out."""
        now = counters() if self._end is None else self._end
        return dict(sorted((now - self._base).items()))

    def summary(self) -> dict:
        """``{"spans": spans(), "counters": counters()}``."""
        return {"spans": self.spans(), "counters": self.counters()}


@contextlib.contextmanager
def recording():
    """Summarise every span that runs inside the block: yields its
    ``Record``. Blocks may overlap; each sees the spans that ran while it
    was open."""
    rec = Record()
    with _LOCK:
        _OPEN.append(rec)
    try:
        yield rec
    finally:
        with _LOCK:
            _OPEN.remove(rec)
        rec._end = counters()
