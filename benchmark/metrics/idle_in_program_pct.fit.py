"""The share of the traced window in which the card was idle while the
program's host work held the host: the card's idle intervals (no kernel
and no copy on it) intersected with the union of the program's spans
(``pt.*``, ``utils/tracing.py``: check, pack, launch, contract, wait) on
any host thread, over the window. ``None`` where the trace holds no
program span (a program without them). A traced-window reading: it holds
the profiler's host cost, as ``device_idle_pct.fit`` does."""

from harness import program_spans


def read(ctx):
    return program_spans.idle_pct(ctx)
