"""B4's share of its roofline, with the light's geometry planes: the least
time its counted operations and bytes need on the card (67 TFLOP/s
float32, 3.35 TB/s; ``counts/b4.py``) over its mean device time a launch
in the trace."""


def read(ctx):
    return ctx.roofline_pct("b4")
