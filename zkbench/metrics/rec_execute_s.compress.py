"""Seconds a job of the recursion programs' execution on the host
(``lift.execute`` and ``compress.execute``, thread seconds)."""


def read(ctx):
    t = ctx.span_total("lift.execute") + ctx.span_total("compress.execute")
    return t / len(ctx.jobs) if t and ctx.jobs else None
