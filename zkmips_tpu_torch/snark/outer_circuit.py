"""The outer Groth16 circuit: a BN254 R1CS verifying a wrap-stage STARK proof.

This is the final link of the reference's proof ladder
(crates/prover/src/lib.rs:1062-1130 ``wrap_groth16_bn254``): the wrap proof,
already proven under the BN254 outer config (Poseidon2-BN254 Merkle,
MultiField32 transcript), is verified *inside* an R1CS over Fr(BN254), and
that R1CS instance is proven with Groth16 (or PLONK).  The in-DSL shard
verifier emitter (``recursion/verifier.py``) is re-run against the R1CS
gadget backend (``snark/gadgets.py``): one emitter, two backends.

Public inputs (2 Fr): the wrap proof's 8 public values (its pv digest,
binding every core shard's vk, public values and septic digests through
the compress tree) packed 4 per Fr with 2^32 stride.  The wrap machine's
verifying key is baked into the circuit as constants, so the Groth16
verifying key pins the entire recursion program tree.

The circuit reads the port's wrap ``ShardProof`` through one host copy
(``recursion.verifier.host_proof``): opened values canonical, BN254 digests
as the Python ints they are.  Everything here is host code; ``rng`` is the
SNARKs' source of randomness (``secrets.randbelow`` by default).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import field as ff
from ..recursion.verifier import _VerifierCircuitBase, host_proof
from ..utils.logger import note, span
from . import groth16
from .gadgets import (
    FrVal,
    OuterBuilder,
    OuterCircuitChallenger,
    compress_gadget,
    hash_felts_gadget,
    reduce_32_pack,
)
from .r1cs import ConstraintSystem, R


def pack_public_values(pv) -> list[int]:
    """Pack canonical KoalaBear felts into Fr scalars (4 per Fr, 2^32
    stride): the Groth16 public-input encoding (8 pv -> 2 Fr for the wrap
    machine's digest public values)."""
    vals = [int(x) for x in pv]
    out = []
    for k in range(0, len(vals), 4):
        acc = 0
        for i, v in enumerate(vals[k : k + 4]):
            acc += v << (32 * i)
        out.append(acc % R)
    return out


class OuterVerifierCircuit(_VerifierCircuitBase):
    """R1CS instance verifying one wrap-stage ShardProof.

    Eager build (r1cs.py): the witness is produced alongside the constraints,
    so proving needs no separate solver.  The constraint *structure* depends
    only on the proof shape (chip set, log-degrees, FRI plan): rebuilt with
    a different proof of the same shape it yields the same system, so one
    setup serves every proof of the shape."""

    def __init__(self, machine, vk, proof):
        self.machine = machine
        self.config = machine.config.fri
        assert self.config.hash_family == "bn254", "outer circuit requires the outer config"
        self._spec: list = []
        self._cursel = lambda p: p
        self.proof = host_proof(proof)
        self.cs = ConstraintSystem()

        # public inputs must be allocated before any witness (r1cs.py)
        self.packed_pv = pack_public_values(self.proof.public_values)
        pub_vars = [self.cs.public(v) for v in self.packed_pv]

        self.b = OuterBuilder(self.cs)
        _vk_root, pv, _gs = self._verify_shard(vk, proof, lambda p: p)

        # bind the packed public inputs to the in-circuit (hinted and
        # transcript-observed) wrap public values
        for k, pub_var in enumerate(pub_vars):
            chunk = pv[4 * k : 4 * k + 4]
            packed = reduce_32_pack(self.b, [self.b._reduce(f) for f in chunk])
            self.b.fr.assert_eq(
                packed, self.b.fr.from_public(pub_var, self.packed_pv[k], R - 1)
            )

    # -- eager hints (values resolved at build time) ------------------------

    def _hf(self, extract):
        sel = self._cursel
        return self.b.hint_felt(int(extract(sel(self.proof))) % ff.P)

    def _hext(self, extract):
        sel = self._cursel
        return self.b.hint_ext([int(x) for x in extract(sel(self.proof))])

    def _hfs_rows(self, n, extract):
        sel = self._cursel
        vals = extract(sel(self.proof))
        return [self.b.hint_felt_loose(int(vals[i])) for i in range(n)]

    # -- digest/transcript layer: BN254 outer overrides ---------------------

    def _new_challenger(self):
        return OuterCircuitChallenger(self.b)

    def _const_root(self, root_arr) -> FrVal:
        return self.b.fr.const(int(np.asarray(root_arr).reshape(-1)[0]))

    def _hint_root(self, extract) -> FrVal:
        sel = self._cursel
        v = int(np.asarray(extract(sel(self.proof)), dtype=object).reshape(-1)[0])
        return self.b.fr.witness(v, R - 1)

    def _observe_root(self, ch, digest: FrVal):
        ch.observe_digest(digest)

    def _leaf_hash(self, felts) -> FrVal:
        return hash_felts_gadget(self.b, felts)

    def _compress_digest(self, left: FrVal, right: FrVal) -> FrVal:
        return compress_gadget(self.b, left, right)

    def _digest_select(self, bit, digest: FrVal, sib: FrVal):
        fx = self.b.fr
        bitf = bit.fr if hasattr(bit, "fr") else bit
        lc_d = dict(sib.lc)
        for k, c in digest.lc.items():
            lc_d[k] = (lc_d.get(k, 0) - c) % R
        diff = FrVal(lc_d, (sib.value - digest.value) % R, R - 1)
        left = fx.add(digest, fx.mul(bitf, diff))
        lc_i = dict(digest.lc)
        for k, c in sib.lc.items():
            lc_i[k] = (lc_i.get(k, 0) - c) % R
        diff_i = FrVal(lc_i, (digest.value - sib.value) % R, R - 1)
        right = fx.add(sib, fx.mul(bitf, diff_i))
        return left, right

    def _assert_digest_eq(self, digest: FrVal, root: FrVal):
        self.b.fr.assert_eq(digest, root)


def _outer_circuit(rp, wrapped):
    """(circuit, setup-cache key) for a wrap-stage CompressedProof."""
    assert wrapped.stage == "wrap"
    vk = rp._find_final_vk(wrapped)
    with span("snark.circuit"):
        circ = OuterVerifierCircuit(rp.wrap_machine.machine, vk, wrapped.proof)
        assert circ.cs.is_satisfied(), "outer circuit witness unsatisfied"
    note("snark.constraints", len(circ.cs.constraints))
    note("snark.variables", len(circ.cs.values))
    key = (
        tuple(int(x) for x in np.asarray(vk.prep_root).reshape(-1)),
        tuple(wrapped.proof.chip_names),
        tuple(ov.log_degree for ov in wrapped.proof.opened),
    )
    return circ, key


def _wrap_public_values(wrapped) -> list:
    return [int(x) for x in wrapped.proof.public_values.tolist()]


# ---------------------------------------------------------------------------
# Groth16 wrap pipeline
# ---------------------------------------------------------------------------


@dataclass
class Groth16WrappedProof:
    """Final on-chain-style proof: Groth16 over the outer circuit.  O(1):
    the Groth16 public inputs ARE the packed rec_pv aggregation record, so
    verification needs only the pairing check plus the record completeness
    conditions (the analog of ZKMProofWithPublicValues in groth16 mode,
    sdk/src/proof.rs:17-37)."""

    proof: groth16.ProofG16
    groth16_vk: groth16.VerifyingKeyG16
    wrap_public_values: list  # the wrap proof's rec_pv record (canonical)
    num_shards: int


def wrap_groth16(rp, wrapped, rng=None, _setup_cache={}) -> Groth16WrappedProof:
    """CompressedProof(stage="wrap") -> Groth16 proof over the outer circuit.

    ``rp`` is the RecursionProver that produced the wrap proof (its caches
    hold the wrap vk).  Setup is cached per (wrap vk, proof shape):
    rebuilding the circuit for another proof of the same shape reuses it
    (the reference's analog is the downloaded fixed-circuit trusted setup,
    sdk/src/install.rs:36).  ``rng`` draws the setup's toxic waste (on a
    cache miss) and the proof's blinding."""
    circ, key = _outer_circuit(rp, wrapped)
    entry = _setup_cache.get(key)
    if entry is None:
        with span("snark.setup"):
            entry = groth16.setup(circ.cs, rng=rng)
        _setup_cache[key] = entry
    pk, g16_vk = entry

    with span("snark.prove"):
        proof = groth16.prove(pk, circ.cs, rng=rng)
    return Groth16WrappedProof(
        proof=proof,
        groth16_vk=g16_vk,
        wrap_public_values=_wrap_public_values(wrapped),
        num_shards=wrapped.num_shards,
    )


def verify_groth16(core_vk, program, wg: Groth16WrappedProof) -> bool:
    """Verify the Groth16 proof: one pairing check on the packed rec_pv
    record public inputs plus the O(1) record completeness conditions
    (prover/src/verify.rs:295+ verify_groth16_bn254 analog)."""
    from ..recursion.compress import RecursionProver
    from ..stark.machine import VerificationError

    with span("snark.verify"):
        publics = pack_public_values(wg.wrap_public_values)
        if not groth16.verify(wg.groth16_vk, wg.proof, publics):
            raise VerificationError("groth16 pairing check failed")
        RecursionProver._check_complete_record(
            core_vk, program, [int(x) for x in wg.wrap_public_values], wg.num_shards
        )
    return True


# ---------------------------------------------------------------------------
# PLONK wrap pipeline (the reference's .plonk() action / wrap_plonk_bn254)
# ---------------------------------------------------------------------------


@dataclass
class PlonkWrappedProof:
    """Final proof in PLONK mode: vanilla PLONK (KZG) over the same outer
    circuit (prover/src/lib.rs:1062 wrap_plonk_bn254 analog)."""

    proof: object  # plonk.PlonkProof
    plonk_vk: object  # plonk.PlonkVerifyingKey
    wrap_public_values: list  # the wrap proof's rec_pv record (canonical)
    num_shards: int


def wrap_plonk(rp, wrapped, rng=None, _setup_cache={}) -> PlonkWrappedProof:
    """CompressedProof(stage="wrap") -> PLONK proof over the outer circuit.

    The R1CS outer circuit is converted to a plonkish gate system
    (``plonk.gates_from_r1cs``) and proven with vanilla PLONK; setup is
    cached per (wrap vk, proof shape) like the Groth16 path."""
    from . import plonk

    circ, key = _outer_circuit(rp, wrapped)
    with span("snark.gates"):
        gates = plonk.gates_from_r1cs(circ.cs)
    note("snark.gates", gates.num_gates)
    entry = _setup_cache.get(key)
    if entry is None:
        with span("snark.setup"):
            entry = plonk.setup(gates, rng=rng)
        _setup_cache[key] = entry
    pk, p_vk = entry

    with span("snark.prove"):
        proof = plonk.prove(pk, gates, rng=rng)
    return PlonkWrappedProof(
        proof=proof,
        plonk_vk=p_vk,
        wrap_public_values=_wrap_public_values(wrapped),
        num_shards=wrapped.num_shards,
    )


def verify_plonk(core_vk, program, wp: PlonkWrappedProof) -> bool:
    """PLONK analog of verify_groth16 (prover/src/verify.rs verify_plonk_bn254)."""
    from ..recursion.compress import RecursionProver
    from ..stark.machine import VerificationError
    from . import plonk

    with span("snark.verify"):
        publics = pack_public_values(wp.wrap_public_values)
        if not plonk.verify(wp.plonk_vk, wp.proof, publics):
            raise VerificationError("plonk pairing check failed")
        RecursionProver._check_complete_record(
            core_vk, program, [int(x) for x in wp.wrap_public_values], wp.num_shards
        )
    return True
