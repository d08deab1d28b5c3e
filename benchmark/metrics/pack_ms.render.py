"""Mean host time of the program's packing spans (``pt.pack.*``,
``utils/tracing.py``) in the traced window, one a frame: the library
looked up and the scene's tables packed (for B3 also its emitter tables).
The camera's parameters, whose copy waits for the card, are a span of
their own (``pt.wait.camera_params``); the image is allocated after it,
in ``pt.launch``. ``None`` where the trace holds none (a program without
them). A traced-window reading: it holds the profiler's host cost, as
``device_idle_pct.render`` does."""

from harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "pt.pack.")
