"""Mean host time of the program's ``pt.apply.*`` spans in the traced
window, one a geometry fit step: the scene rebuilt from the fit's
variables (``grad/diff.apply_geometry_params``) before B4's wrapper runs.
It holds no wait for the card, which the program names ``pt.wait.*``.
``None`` where the trace holds none (a program without the span). A
traced-window reading: it holds the profiler's host cost, as
``device_idle_pct.fit`` does."""

from harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "pt.apply.")
