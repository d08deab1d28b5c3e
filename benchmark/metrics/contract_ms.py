"""Mean host time of the program's contraction spans (``pt.contract.*``,
``utils/tracing.py``) in the traced window, one a fit step's backward: the
autograd backward of B2, its Jacobian contracted with the image's
cotangent into the materials' and the sky's. ``None`` where the trace
holds none (a program without them). A traced-window reading: it holds
the profiler's host cost, as ``device_idle_pct.fit`` does."""

from harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "pt.contract.")
