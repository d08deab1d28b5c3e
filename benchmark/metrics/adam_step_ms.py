"""Mean host time of the optimizer's step, one a fit step: the benchmark's
own clock around each call of ``Optimizer.step`` (torch's global step
hooks, which span what the profiler's ``Optimizer.step#Adam.step`` event
does), over the fits of the traced run that ran after the profiler had
stopped, so that the profiler's host cost is not in it."""


def read(ctx):
    return ctx.mean_ms(ctx.untraced.get("adam_step_s", []))
