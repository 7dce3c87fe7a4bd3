"""Seconds a job of the recursion proofs (``lift.prove`` and
``compress.prove``, thread seconds)."""


def read(ctx):
    t = ctx.span_total("lift.prove") + ctx.span_total("compress.prove")
    return t / len(ctx.jobs) if t and ctx.jobs else None
