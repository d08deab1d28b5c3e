"""Mean host time of the call into the render entry until it returns,
before the image is brought to the host: the benchmark's own span around
each frame's call, over the frames of the traced run that ran after the
profiler had stopped, so that the profiler's host cost is not in it. It
holds the packing and the launch, and any wait the entry makes for the
device."""


def read(ctx):
    return ctx.mean_ms(ctx.untraced.get("render_call_s", []))
