"""Merkle-authenticated allowed-vks tree for the vk_map artifact.

The reference binds its recursion-program vk set under one Merkle root
(crates/recursion/circuit/src/machine/vkey_proof.rs:33-126,
crates/prover/src/shapes.rs:275-304): a verifier that pins the root accepts
only proofs whose (final) vk belongs to the committed set.  In our ladder
the child vks of every parent program are baked in as circuit constants, so
a parent program's own vk transitively pins the whole sub-tree of programs
— the remaining trust gap is the vk_map artifact itself.  This module
closes it: the exported map carries a Poseidon2 Merkle root over canonical
leaf encodings of every entry, and loading verifies each entry against it.
A verifier process therefore needs only (vk_map.json, the 8-felt root) —
a tampered or extended map is rejected.

Leaf encoding (canonical u32 felts, hashed with Poseidon2-KB16):
    [len(root_felts)] ++ root_felts ++ [n_heights] ++ per height:
    [len(name)] ++ utf8 bytes as felts ++ [log_h]
Outer-config (BN254) single-Fr roots are split into 16-bit limbs first.
Leaves are sorted; the tree pads to a power of two with the zero digest.
"""

from __future__ import annotations

from ..ops import poseidon2 as p2


def _root_felts(root_ints: list) -> list:
    if len(root_ints) == 1:  # BN254 outer single-Fr digest -> 16-bit limbs
        v = int(root_ints[0])
        return [(v >> (16 * i)) & 0xFFFF for i in range(16)]
    return [int(x) for x in root_ints]


def leaf_encoding(root_ints: list, heights: list) -> list:
    felts = [len(root_ints)]
    felts.extend(_root_felts(root_ints))
    felts.append(len(heights))
    for name, log_h in heights:
        b = str(name).encode()
        felts.append(len(b))
        felts.extend(b)
        felts.append(int(log_h))
    return felts


def leaf_digest(root_ints: list, heights: list) -> tuple:
    return tuple(p2.hash_canonical(leaf_encoding(root_ints, heights)))


def merkle_root(leaves: list) -> tuple:
    """Root over sorted leaf digests (canonical 8-tuples), zero-padded."""
    layer = [list(l) for l in sorted(leaves)]
    if not layer:
        return tuple([0] * 8)
    n = 1 << (len(layer) - 1).bit_length() if len(layer) > 1 else 1
    layer = layer + [[0] * 8] * (n - len(layer))
    while len(layer) > 1:
        layer = [p2.compress_canonical(layer[i], layer[i + 1]) for i in range(0, len(layer), 2)]
    return tuple(layer[0])


def map_entries_root(entries: list) -> tuple:
    """Root over vk_map entries [{'root': [...], 'heights': [[n, lh]...]}]."""
    leaves = [
        leaf_digest([int(x) for x in e["root"]], [(n, int(lh)) for n, lh in e["heights"]])
        for e in entries
    ]
    return merkle_root(leaves)
