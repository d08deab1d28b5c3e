"""What the per-layer metrics read from the program's own spans (``pt.*``,
``path_tracer_c_tpu_torch/utils/tracing.py``) in a traced window. Each
returns ``None`` where the run was not traced or the trace holds no such
span, as from a program without them."""

from __future__ import annotations

from .trace import _merge


def mean_ms(ctx, prefix: str):
    """Mean duration, in milliseconds, of the host spans whose name starts
    with ``prefix``."""
    if ctx.trace is None:
        return None
    return ctx.mean_ms([t - s for s, t, name in ctx.trace.host if name.startswith(prefix)])


def idle_pct(ctx, prefix: str = "pt."):
    """The share of the window, in percent, in which the card was idle while
    a span whose name starts with ``prefix`` was open on any host thread."""
    trace = ctx.trace
    if trace is None:
        return None
    spans = _merge((s, t) for s, t, name in trace.host if name.startswith(prefix))
    if not spans or trace.window_s <= 0:
        return None
    held, i = 0.0, 0
    for s, t in trace.gaps():
        while i < len(spans) and spans[i][1] <= s:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < t:
            held += min(t, spans[j][1]) - max(s, spans[j][0])
            j += 1
    return 100.0 * held / trace.window_s
