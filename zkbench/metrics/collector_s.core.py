"""Seconds a job of Python's cyclic garbage collector: the program's
``gc.gen0``, ``gc.gen1`` and ``gc.gen2`` spans (one a collection, in the
thread that ran it) over the window, per job.  None on a program that
records no such spans."""

GENERATIONS = ("gc.gen0", "gc.gen1", "gc.gen2")


def read(ctx):
    t = sum(ctx.span_total(g) for g in GENERATIONS)
    return t / len(ctx.jobs) if t and ctx.jobs else None
