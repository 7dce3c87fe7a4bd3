"""The window's share in which no operation ran on the device, in %: one
minus the union of the profiler's device intervals over the window."""


def read(ctx):
    d = ctx.device
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"]) if d and d["window_s"] > 0 else None
