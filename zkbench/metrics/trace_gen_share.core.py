"""The chips' trace fills (``prove.trace_gen``, wall time) as a share of the window, in %."""


def read(ctx):
    t = ctx.span_total("prove.trace_gen")
    return 100.0 * t / ctx.window_s if t else None
