"""Shape-menu generation from observed trace heights over a guest corpus.

Analog of the reference's shape-finder scripts
(crates/prover/scripts/find_maximal_shapes.rs) + maximal_shapes.json
(crates/core/machine/src/shape/mod.rs:40): run representative guests, record
every shard's per-chip trace heights, and derive one maximal shape per CPU
log-height bucket.  The menu is written to the port's own
``machine/shapes_data.json`` and loaded by ShapeConfig at prover start.

Run:  python -m zkmips_tpu_torch.machine.shape_gen
"""

from __future__ import annotations

import json
import os

from .shapes import DATA_PATH, lattice_log

# chips whose presence at scale defines a shape family (the reference's
# distinct precompile shape clusters, shape/mod.rs): keying on them keeps
# e.g. keccak-heavy guests from inflating the plain-ALU buckets
FAMILY_CHIPS = (
    "KeccakSponge", "ShaCompress", "ShaExtend", "Poseidon2Permute",
    "Uint256Mul", "U256x2048Mul",
)


def observe_heights(machine, records) -> list[dict]:
    """Per-record {chip_name: rows} using the machine's real trace fills
    (exactly what ``prove_shard`` pads)."""
    out = []
    for record in records:
        machine.generate_dependencies(record)
        record.byte_lookups.pop("arrays", None)
        heights = {}
        for chip in machine.machine.chips:
            if not chip.air.included(record):
                continue
            t = chip.air.generate_trace(record, None)
            heights[chip.name] = int(t.shape[0])
        record.byte_lookups.pop("arrays", None)
        out.append(heights)
    return out


def corpus_programs() -> list:
    """Representative guests: ALU-heavy (fib at several scales crossing shard
    boundaries), memory-heavy, each precompile family, and the keccak chain.

    The reference builds its precompile guests with the functions of its
    ``examples/``; the port has its own copies (``executor/guests.py``).  A
    guest that cannot be built raises.  (The reference also adds its upstream
    project's compiled ELF when that file is on disk; it is not part of this
    repository.)"""
    from ..executor import Instruction, Opcode, Register, asm, guests

    R, O = Register, Opcode
    progs = []

    def fib(n):
        body = [
            *asm.li(R.T0, 0), *asm.li(R.T1, 1), *asm.li(R.T2, n),
            asm.alu(O.ADD, R.T3, R.T0, R.T1),
            Instruction(O.ADD, R.T0, R.T1, 0, False, True),
            Instruction(O.ADD, R.T1, R.T3, 0, False, True),
            asm.addi(R.T2, R.T2, -1 & 0xFFFFFFFF),
            asm.branch(O.BGTZ, R.T2, 0, -20),
            asm.nop(),
        ]
        return asm.prog(body + asm.halt_sequence())

    for n in (100, 3_000, 40_000, 200_000):
        progs.append(("fib%d" % n, fib(n)))

    def memory_sweep(words):
        body = [*asm.li(R.T0, 0x2000), *asm.li(R.T1, words)]
        body += [
            asm.sw(R.T1, R.T0),
            asm.lw(R.T2, R.T0),
            asm.addi(R.T0, R.T0, 4),
            asm.addi(R.T1, R.T1, -1 & 0xFFFFFFFF),
            asm.branch(O.BGTZ, R.T1, 0, -20),
            asm.nop(),
        ]
        return asm.prog(body + asm.halt_sequence())

    progs.append(("mem20k", memory_sweep(20_000)))

    def mixed(n):
        body = [*asm.li(R.T0, 1), *asm.li(R.T1, 3), *asm.li(R.T2, n)]
        body += [
            asm.alu(O.MUL, R.T3, R.T0, R.T1),
            asm.alu(O.XOR, R.T4, R.T3, R.T2),
            asm.alu(O.SLT, R.T5, R.T4, R.T1),
            asm.alu(O.SLL, R.T6, R.T4, R.T1),
            asm.alu(O.DIVU, R.T7, R.T4, R.T1),
            asm.addi(R.T2, R.T2, -1 & 0xFFFFFFFF),
            asm.branch(O.BGTZ, R.T2, 0, -24),
            asm.nop(),
        ]
        return asm.prog(body + asm.halt_sequence())

    progs.append(("mixed30k", mixed(30_000)))

    progs.append(("keccak", guests.keccak_message_program(b"shape corpus " * 64)))
    progs.append(("sha256", guests.sha256_message_program(b"shape corpus guest")))
    progs.append(("poseidon2", guests.poseidon2_program(list(range(16)))))

    # keccak-chain (the bench's second headline guest) at two scales
    for n in (600, 12_000):
        progs.append(("keccak_chain%d" % n, guests.keccak_chain_program(n)))
    return progs


def generate_menu(shard_size: int = 1 << 20, margin: int = 0) -> list[dict]:
    """Execute the corpus, bucket shard height-vectors by CPU log height,
    and emit one maximal shape per bucket (+ per deferred-shard family)."""
    from ..executor import execute_for_proving
    from ..stark.machine import StarkConfig
    from .machine import MipsMachine

    m = MipsMachine(StarkConfig.core(), use_shapes=False)
    buckets: dict[str, dict[str, int]] = {}
    for _name, prog in corpus_programs():
        records, _info = execute_for_proving(prog, shard_size=shard_size)
        for heights in observe_heights(m, records):
            fams = "".join(
                "+%s" % c for c in FAMILY_CHIPS
                if heights.get(c, 0) > (1 << 10)
            )
            if "Cpu" in heights:
                key = "cpu%d%s" % (lattice_log(heights["Cpu"]), fams)
            else:
                fam = max(heights, key=lambda n: heights[n])
                key = "deferred-%s-%d" % (fam, lattice_log(heights[fam]))
            b = buckets.setdefault(key, {})
            for n, h in heights.items():
                b[n] = max(b.get(n, 0), lattice_log(h) + margin)
    return [
        {"key": k, "log_heights": dict(sorted(v.items()))}
        for k, v in sorted(buckets.items())
    ]


def main(additive: bool = True):
    """Regenerate the port's menu.  ``additive`` (default): existing entries
    are kept verbatim and only new keys are appended, so existing guests
    keep their exact shapes (and their proofs their layout)."""
    menu = generate_menu()
    if additive and os.path.exists(DATA_PATH):
        with open(DATA_PATH) as fh:
            old = json.load(fh).get("shapes", [])
        old_keys = {s["key"] for s in old}
        menu = old + [s for s in menu if s["key"] not in old_keys]
    with open(DATA_PATH, "w") as fh:
        json.dump({"version": 1, "shapes": menu}, fh, indent=1, sort_keys=True)
    print("wrote %d shapes -> %s" % (len(menu), DATA_PATH))
    for s in menu:
        print(" ", s["key"], s["log_heights"])


if __name__ == "__main__":
    main()
