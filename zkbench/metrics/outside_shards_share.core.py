"""The window's share outside the ``shard<N>`` spans (``MipsMachine.prove_record``):
the executor, the deferred split and the client's own work, in %."""

import re

SHARD = re.compile(r"shard\d+")


def read(ctx):
    inside = sum(t for path, (t, _n) in ctx.spans.items() if SHARD.fullmatch(path))
    if not inside:
        return None
    return 100.0 * (1.0 - inside / ctx.window_s)
