"""Seconds a job of the Global chip's fill (``fill.Global``, thread seconds)."""


def read(ctx):
    t = ctx.span_total("fill.Global")
    return t / len(ctx.jobs) if t and ctx.jobs else None
