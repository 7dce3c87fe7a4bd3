"""Shape of every chip of the port's full MIPS machine, one JSON line each.

    python3 -m zkmips_tpu_torch.utils.chip_stats

Prints, per chip of ``core_chip_airs()`` in machine order: main and
preprocessed columns, constraints, log quotient degree, permutation ext
columns, the nodes of its constraint DAG, and the most DAG values the
prover's quotient holds at once (``stark/air.fold_constraints`` drops a
value after its last reader).  Host only; no device is needed.
"""

from __future__ import annotations

import json

from zkmips_tpu_torch.machine.machine import core_chip_airs
from zkmips_tpu_torch.machine.pv import NUM_PV
from zkmips_tpu_torch.stark import air
from zkmips_tpu_torch.stark.chip import Chip


def live_values(constraints) -> int:
    """Most values held at once by a post-order walk that drops each value
    after its last reader and folds each constraint as it is reached."""
    order, readers = air._schedule(constraints)
    roots = {id(c) for c in constraints}
    live = most = 0
    for e in order:
        for c in air._children(e):
            readers[id(c)] -= 1
            live -= readers[id(c)] == 0
        if id(e) in roots:
            readers[id(e)] -= sum(c is e for c in constraints)
        live += readers[id(e)] > 0
        most = max(most, live)
    return most


def main():
    for a in core_chip_airs():
        chip = Chip(a, num_public_values=NUM_PV)
        order, _ = air._schedule(chip.constraints)
        print(json.dumps({
            "chip": a.name, "main_cols": a.main_width, "prep_cols": a.preprocessed_width,
            "constraints": len(chip.constraints), "log_quotient_degree": chip.log_quotient_degree,
            "perm_ext_cols": chip.perm_width_ext, "dag_nodes": len(order),
            "live_values": live_values(chip.constraints),
        }), flush=True)


if __name__ == "__main__":
    main()
