"""The prover's long-lived heap, kept out of the cyclic garbage collector's walks.

A client's proving key holds every chip's constraint DAG, about a million
expression nodes; the recursion prover's caches hold each lift and join
program as millions of instruction objects and the closures that extract its
witness.  They live as long as the client, and each full collection of
Python's cyclic collector walks all of them: at the core configuration some
ten million objects, a pause of 3-5 s on an H100 host in every compressed
proof.

``freeze_long_lived`` is called where such a structure has just been built:
it collects what is garbage now, then moves every object still alive into
the collector's permanent generation (``gc.freeze``).  Later collections
skip those objects; reference counting still frees any of them that is
dropped.  What the collector alone could free among them (a cycle that
becomes garbage later) stays until the process ends.
"""

from __future__ import annotations

import gc


def freeze_long_lived():
    """Collect the garbage there is, then freeze every object alive."""
    gc.collect()
    gc.freeze()
