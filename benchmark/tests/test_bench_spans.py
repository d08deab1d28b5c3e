"""The per-layer metrics that read the program's spans (``pt.*``), each on a
hand-made trace whose card activity and host spans are known: the value
they must give, and ``None`` where the trace holds no program span, as
from a program without them."""

from __future__ import annotations

import pytest
from conftest import BENCH

from harness import core, spec
from harness import trace as _trace

WINDOW = (100.0, 110.0)  # seconds on the profiler's clock


def _context(device: list, host: list):
    """A ``core.Context`` over a trace of a 10 s window with the card busy
    over ``device`` and the host in ``host`` ((start, end, name) each)."""
    trace = object.__new__(_trace.Trace)
    trace.start, trace.end = WINDOW
    trace.window_s = WINDOW[1] - WINDOW[0]
    trace.device, trace.host = device, host
    trace.busy = _trace._merge((s, t) for s, t, _ in device)
    trace.busy_s = sum(t - s for s, t in trace.busy)
    run = type("Run", (), {})()
    window = type("Window", (), {"traced_units": 0, "spans": {}})()
    return core.Context(run, window, trace)


def _read(name: str, ctx):
    return spec.load_module(BENCH / "metrics" / f"{name}.py", f"bench_test_{name}").read(ctx)


# The card busy over 101-103 and 104-109: idle 100-101, 103-104, 109-110.
DEVICE = [(101.0, 103.0, "render_fwd_kernel"), (104.0, 106.0, "Memcpy DtoH"),
          (105.0, 109.0, "render_fused_kernel")]
HOST = [
    # a frame's phases: check and pack inside the first idle second, the
    # launch across the card's start
    (100.2, 100.4, "pt.check.render_fwd"), (100.4, 100.9, "pt.pack.render_fwd"),
    (100.9, 101.5, "pt.launch.render_fwd"),
    (100.5, 100.6, "aten::cat"),  # an operation inside the pack span
    # a second thread's span over the same idle second adds nothing twice
    (100.3, 100.7, "pt.wait.flush"),
    # a pack of 0.3 s across the second gap's start, a contraction inside it
    (102.8, 103.1, "pt.pack.render_fused"), (103.4, 103.6, "pt.contract.render_fused"),
    (103.6, 103.8, "pt.contract.render_fused"),
    # host work that is not the program's
    (109.2, 109.9, "aten::to"),
]


@pytest.mark.parametrize("name, want", [
    # idle and in a span: 100.2-100.9 and 100.9-101.0, 103.0-103.1, 103.4-103.8
    ("idle_in_program_pct.render", 100.0 * (0.8 + 0.1 + 0.4) / 10.0),
    ("idle_in_program_pct.fit", 100.0 * (0.8 + 0.1 + 0.4) / 10.0),
    ("pack_ms.render", 1e3 * (0.5 + 0.3) / 2),
    ("pack_ms.fit", 1e3 * (0.5 + 0.3) / 2),
    ("contract_ms", 1e3 * 0.2),
])
def test_a_reader_reads_the_spans(name, want):
    assert _read(name, _context(DEVICE, HOST)) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", ["idle_in_program_pct.render", "idle_in_program_pct.fit",
                                  "pack_ms.render", "pack_ms.fit", "contract_ms"])
def test_no_program_span_reads_none(name):
    """A trace of a program without spans, and an untraced run, read
    nothing; nor does a span of another phase make a mean of this one."""
    other = [(s, t, n) for s, t, n in HOST if not n.startswith("pt.")]
    assert _read(name, _context(DEVICE, other)) is None
    ctx = _context(DEVICE, HOST)
    ctx.trace = None
    assert _read(name, ctx) is None
    if not name.startswith("idle"):
        prefix = "pt.pack." if name.startswith("pack") else "pt.contract."
        rest = [(s, t, n) for s, t, n in HOST if not n.startswith(prefix)]
        assert _read(name, _context(DEVICE, rest)) is None


def test_idle_in_the_program_is_within_the_idle_share():
    """Spans over the whole window: the reading is the card's idle share."""
    ctx = _context(DEVICE, [(WINDOW[0], WINDOW[1], "pt.wait.flush")])
    assert _read("idle_in_program_pct.render", ctx) == pytest.approx(ctx.idle_pct(), rel=1e-9)
