"""Recursive proof aggregation: lift core shards, binary-tree compress.

The analog of ``ZKMProver::compress`` (crates/prover/src/lib.rs:614-958,
REDUCE_BATCH_SIZE=2): every core shard proof is first *lifted* — re-verified
inside a recursion program that derives the shard's rec_pv aggregation
record in-circuit — then pairs of recursion proofs are joined by *compress*
programs that enforce the shard chain rules in-circuit and fold the two
records (machine/compress.rs:94-480 analog), until one O(1) proof remains.

Programs are cached by (vk, proof-shape) key — the reference's per-shape
recursion program LRU (lib.rs:366-438); odd nodes are promoted to the next
level unchanged (expected-height rule, lib.rs:631-639).

Trust model: child vks are baked into each parent program as constants,
so the final program's identity transitively pins the whole tree down to
the core vk.  ``verify_compressed`` finds the final vk in the same caches
(same-process verification) or in a loaded vk map (``load_vk_map``).

Every proving entry point takes ``device=``: the recursion proofs run
through ``StarkMachine.prove_shard`` on a CUDA device unless the caller
passes another (``device="cpu"``); circuit building, execution and
verification are host work.  Each stage's parts are timed as spans
(``utils/logger``): ``<stage>.circuit``, ``<stage>.setup``,
``<stage>.execute`` and ``<stage>.prove`` (the prover's own spans nested
under it), for the stages lift, compress, shrink, wrap and deferred.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..stark.machine import VerificationError, VerifyingKey
from ..utils.logger import span
from .machine import RecursionMachine
from .rec_pv import canonical_digest
from .verifier import (
    CompressVerifierCircuit,
    ShardVerifierCircuit,
    compress_digest,
)


@dataclass
class CompressedProof:
    """One recursion proof standing for a whole core MachineProof.

    O(1): the aggregated execution state travels as the proof's own
    rec_pv record public values (pc/shard ranges, digests, addr endpoints,
    the summed septic global digest) — chain rules were enforced IN-CIRCUIT
    by the compress programs, so nothing per-shard is carried
    (reference machine/compress.rs:94-480).

    stage: "compress" (the core machine's FRI config), "shrink" (log blowup
    one more, half the queries) or "wrap" (the BN254 outer config): which
    machine's verifier accepts ``proof``."""

    proof: object  # final recursion-machine ShardProof
    final_vk_root: tuple  # the final program's prep root: 8 Montgomery ints, or one BN254 int
    num_shards: int
    stage: str = "compress"

    @property
    def record(self) -> list:
        """The authenticated rec_pv aggregation record (canonical ints)."""
        return [int(x) for x in self.proof.public_values.tolist()]


@dataclass
class DeferredProof:
    """A deferred-chain link: a recursion proof whose pv binds
    Poseidon2_compress(prev_digest, new_digest)
    (verifier.DeferredVerifierCircuit); the chain values are stated
    alongside and re-bound by the verifier."""

    proof: object
    final_vk_root: tuple  # the deferred program's own vk root
    child_vk_root: tuple  # the verified child program's vk root (canonical)
    prev_digest: list
    new_digest: list


def root_key(root) -> tuple:
    """A prep root as a tuple of ints: the 8 Montgomery words of a KoalaBear
    digest (int32 tensor or uint32 array), or the one int of a BN254 digest."""
    if isinstance(root, torch.Tensor):
        return tuple(root.reshape(-1).tolist())
    return tuple(int(x) for x in np.asarray(root).reshape(-1))


def _vk_key(vk) -> tuple:
    return (root_key(vk.prep_root), tuple(vk.prep_heights))


def _shape_key(proof) -> tuple:
    return (
        tuple(proof.chip_names),
        tuple(ov.log_degree for ov in proof.opened),
    )


class RecursionProver:
    """Caches lift/compress circuits + recursion pk/vks; proves and verifies
    compressed proofs for one core machine instance."""

    def __init__(self, core_machine):
        from ..stark.machine import StarkConfig
        from ..stark.pcs import FriConfig

        from . import rec_pv

        self.core = core_machine
        self.rec = RecursionMachine(core_machine.machine.config, num_pv=rec_pv.NUM_REC_PV)
        base = core_machine.machine.config.fri
        # shrink/wrap configs scale the reference ladder (blowup 1->2->3,
        # kb31_poseidon2.rs:203-240) off whatever the core config is, keeping
        # the unsound-but-fast test config cheap in tests
        self.shrink_machine = RecursionMachine(StarkConfig(FriConfig(
            base.log_blowup + 1, max(base.num_queries // 2, 2), base.proof_of_work_bits
        )), num_pv=rec_pv.NUM_REC_PV)
        # wrap re-proves the shrink proof under the BN254 outer config
        # (Poseidon2-BN254 Merkle + MultiField32 transcript,
        # recursion/core/src/stark/config.rs:23-103); the sound parameters are
        # blowup 4 / 21 queries, scaled down when the core config is the fast
        # unsound test ladder
        self.wrap_machine = RecursionMachine(StarkConfig(
            FriConfig.outer() if base.num_queries >= 42 else FriConfig.outer_test()
        ), num_pv=rec_pv.NUM_REC_PV)
        self._lift_cache: dict = {}
        self._compress_cache: dict = {}
        self._shrink_cache: dict = {}
        self._deferred_cache: dict = {}

    # -- program caches ------------------------------------------------------

    def _lift_entry(self, core_vk, template_proof, device=None):
        key = (_vk_key(core_vk), _shape_key(template_proof))
        entry = self._lift_cache.get(key)
        if entry is None:
            with span("lift.circuit"):
                circ = ShardVerifierCircuit(self.core.machine, core_vk, template_proof)
            with span("lift.setup"):
                pk = self.rec.setup(circ.program, device=device)
            entry = (circ, pk)
            self._lift_cache[key] = entry
        return entry

    def _compress_entry(self, left_vk, right_vk, tl, tr, device=None):
        key = (_vk_key(left_vk), _vk_key(right_vk), _shape_key(tl), _shape_key(tr))
        entry = self._compress_cache.get(key)
        if entry is None:
            with span("compress.circuit"):
                circ = CompressVerifierCircuit(self.rec.machine, left_vk, right_vk, tl, tr)
            with span("compress.setup"):
                pk = self.rec.setup(circ.program, device=device)
            entry = (circ, pk)
            self._compress_cache[key] = entry
        return entry

    # -- proving -------------------------------------------------------------

    def lift(self, core_vk, shard_proof, device=None):
        """Core ShardProof -> recursion proof of its rec_pv record."""
        device = resolve_device(device)
        circ, pk = self._lift_entry(core_vk, shard_proof, device)
        with span("lift.execute"):
            record = self.rec.execute(circ.program, circ.witness(shard_proof))
        with span("lift.prove"):
            proof = self.rec.prove(pk, record, device=device)
        assert proof.public_values.tolist() == circ.expected_public_values(shard_proof)
        return proof, pk.vk

    def compress(self, core_vk, shard_proofs: list, device=None) -> CompressedProof:
        """Aggregate all core shard proofs into one recursion proof.

        Tree-parallel (reference prover/src/lib.rs:614-780 worker pools):
        the lift layer and each binary-reduction level prove concurrently in
        a thread pool (numpy, C and torch release the GIL).  Circuit/pk
        cache entries are warmed serially first so threads only read the
        caches."""
        device = resolve_device(device)
        assert shard_proofs, "nothing to compress"
        from ..utils.pool import make_pool

        workers = self._workers()
        with make_pool(workers) as pool:
            for sp in shard_proofs:  # warm unique circuit/pk entries
                self._lift_entry(core_vk, sp, device)
            layer = list(
                pool.map(lambda sp: self.lift(core_vk, sp, device=device), shard_proofs)
            ) if workers > 1 else [self.lift(core_vk, sp, device=device) for sp in shard_proofs]
        return self.join(layer, len(shard_proofs), device=device)

    @staticmethod
    def _workers() -> int:
        from ..utils.opts import ZKMCoreOpts

        return max(1, ZKMCoreOpts.default().trace_gen_workers)

    def join(self, layer: list, num_shards: int, device=None) -> CompressedProof:
        """The binary-tree reduction of ``compress``: [(lifted proof, vk)] in
        shard order, joined pairwise by compress programs (an odd node is
        promoted to the next level unchanged) until one proof remains."""
        device = resolve_device(device)
        from ..utils.pool import make_pool

        workers = self._workers()

        def _pair(args):
            (pl, vl), (prf, vr) = args
            circ, pk = self._compress_entry(vl, vr, pl, prf, device)
            with span("compress.execute"):
                record = self.rec.execute(circ.program, circ.witness((pl, prf)))
            with span("compress.prove"):
                proof = self.rec.prove(pk, record, device=device)
            assert proof.public_values.tolist() == circ.expected_public_values((pl, prf))
            return (proof, pk.vk)

        with make_pool(workers) as pool:
            while len(layer) > 1:
                pairs = [
                    (layer[i], layer[i + 1]) for i in range(0, len(layer) - 1, 2)
                ]
                for (pl, vl), (prf, vr) in pairs:
                    self._compress_entry(vl, vr, pl, prf, device)
                nxt = list(pool.map(_pair, pairs)) if workers > 1 else [
                    _pair(p) for p in pairs
                ]
                if len(layer) % 2:
                    nxt.append(layer[-1])
                layer = nxt
        final_proof, final_vk = layer[0]
        return CompressedProof(
            proof=final_proof,
            final_vk_root=root_key(final_vk.prep_root),
            num_shards=num_shards,
        )

    def _shrink_step(self, cp: CompressedProof, child_machine, prover_machine, stage, device=None):
        from .verifier import ShrinkVerifierCircuit

        device = resolve_device(device)
        child_vk = self._find_final_vk(cp)
        key = (stage, _vk_key(child_vk), _shape_key(cp.proof))
        entry = self._shrink_cache.get(key)
        if entry is None:
            with span(f"{stage}.circuit"):
                circ = ShrinkVerifierCircuit(child_machine.machine, child_vk, cp.proof)
            with span(f"{stage}.setup"):
                pk = prover_machine.setup(circ.program, device=device)
            entry = (circ, pk)
            self._shrink_cache[key] = entry
        circ, pk = entry
        with span(f"{stage}.execute"):
            record = prover_machine.execute(circ.program, circ.witness(cp.proof))
        with span(f"{stage}.prove"):
            proof = prover_machine.prove(pk, record, device=device)
        assert proof.public_values.tolist() == cp.proof.public_values.tolist()
        return CompressedProof(
            proof=proof,
            final_vk_root=root_key(pk.vk.prep_root),
            num_shards=cp.num_shards,
            stage=stage,
        )

    # -- deferred-proof aggregation (machine/deferred.rs analog) -------------

    def prove_deferred(self, child_cp: CompressedProof, prev_digest: list, device=None):
        """Verify a deferred (compressed) guest proof inside a recursion
        program that emits the rolling deferred-digest chain link.

        Returns (DeferredProof, new_digest); chain links like
            d0 = zeros; d_{i+1} = rolling(d_i, child_vk_root, child_pv)
        and the core guest must have committed the final digest via
        COMMIT_DEFERRED_PROOFS (executor/syscalls.py), making
        PV_DEFERRED_DIGEST the chain tail the host verifier checks."""
        from .verifier import DeferredVerifierCircuit

        device = resolve_device(device)
        assert child_cp.stage == "compress", "defer compress-stage proofs"
        child_vk = self._find_final_vk(child_cp)
        key = ("deferred", _vk_key(child_vk), _shape_key(child_cp.proof))
        entry = self._deferred_cache.get(key)
        if entry is None:
            with span("deferred.circuit"):
                circ = DeferredVerifierCircuit(self.rec.machine, child_vk, child_cp.proof)
            with span("deferred.setup"):
                pk = self.rec.setup(circ.program, device=device)
            entry = (circ, pk)
            self._deferred_cache[key] = entry
        circ, pk = entry
        witness_obj = (child_cp.proof, [int(x) for x in prev_digest])
        with span("deferred.execute"):
            record = self.rec.execute(circ.program, circ.witness(witness_obj))
        with span("deferred.prove"):
            proof = self.rec.prove(pk, record, device=device)
        expected = circ.expected_public_values(witness_obj)
        assert proof.public_values.tolist() == expected
        prev, new_digest = circ.chain_link(witness_obj)
        return (
            DeferredProof(
                proof=proof,
                final_vk_root=root_key(pk.vk.prep_root),
                child_vk_root=tuple(canonical_digest(child_vk.prep_root)),
                prev_digest=prev,
                new_digest=new_digest,
            ),
            new_digest,
        )

    def verify_deferred(self, deferred_proofs: list, core_cp: CompressedProof) -> bool:
        """Walk the deferred chain: each DeferredProof verifies under a
        known vk and links prev -> new; the head is zero and the tail must
        equal the core proof's deferred_proofs_digest public values
        (verify.rs digest rules + deferred.rs:113)."""
        from ..machine.pv import PV_DEFERRED_DIGEST

        from .verifier import compress_digest

        chain = [0] * 8
        for dp in deferred_proofs:
            vk = self._find_final_vk(dp)
            self.rec.verify(vk, dp.proof)
            # the proof's pv binds (prev, new) as a compress digest in its
            # first 8 slots (DeferredVerifierCircuit; rest are zero)
            if dp.proof.public_values.tolist()[:8] != compress_digest(
                dp.prev_digest, dp.new_digest
            ):
                raise VerificationError("deferred proof does not bind its chain values")
            if dp.prev_digest != chain:
                raise VerificationError("deferred chain link mismatch")
            chain = dp.new_digest
        from . import rec_pv

        committed = rec_pv.get(core_cp.record, rec_pv.DEFERRED_DIGEST)
        if chain != committed:
            raise VerificationError(
                "deferred chain tail does not match the guest's committed "
                "deferred_proofs_digest"
            )
        return True

    def shrink(self, cp: CompressedProof, device=None) -> CompressedProof:
        """Re-prove the final compress proof under the blowup+1 config."""
        assert cp.stage == "compress"
        return self._shrink_step(cp, self.rec, self.shrink_machine, "shrink", device=device)

    def wrap(self, cp: CompressedProof, device=None) -> CompressedProof:
        """Re-prove a shrunk proof under the BN254 outer config
        (recursion/core/src/stark/config.rs)."""
        assert cp.stage == "shrink"
        return self._shrink_step(cp, self.shrink_machine, self.wrap_machine, "wrap", device=device)

    # -- verification --------------------------------------------------------

    def verify_compressed(self, core_vk, program, cp: CompressedProof) -> bool:
        """Verify a compressed proof: one STARK verification + O(1) checks
        on its aggregated rec_pv record.

        The compress programs enforced the per-pair chain rules in-circuit
        (pc/shard/execution-shard chaining, digest set-once, addr-bit
        chaining, septic digest summation — machine/compress.rs analog), so
        only the completeness conditions on the FINAL record remain
        (machine/root.rs assert_complete analog, host-side on public
        values).
        """
        # 1. the final recursion proof verifies under a known-cached vk
        final_vk = self._find_final_vk(cp)
        stage_machine = {
            "compress": self.rec, "shrink": self.shrink_machine, "wrap": self.wrap_machine,
        }[cp.stage]
        stage_machine.verify(final_vk, cp.proof)

        # 2. completeness conditions on the authenticated record
        self._check_complete_record(core_vk, program, cp.record, cp.num_shards)
        return True

    @staticmethod
    def _check_complete_record(core_vk, program, rec: list, num_shards: int):
        """O(1) completeness checks on an aggregated rec_pv record (the
        host-side analog of the reference's assert_complete,
        crates/recursion/circuit/src/machine/complete.rs).  Also used by
        the Groth16/PLONK wrapped-proof verifiers."""
        from ..machine.global_chip import START
        from . import rec_pv

        def g(span):
            return rec_pv.get(rec, span)

        expected_vk = canonical_digest(core_vk.prep_root)
        if g(rec_pv.CORE_VK_DIGEST) != expected_vk:
            raise VerificationError("record does not bind the expected core vk")
        if g(rec_pv.START_SHARD) != [1]:
            raise VerificationError("record does not start at shard 1")
        if g(rec_pv.NEXT_SHARD) != [num_shards + 1]:
            raise VerificationError("record shard range does not match num_shards")
        if g(rec_pv.START_PC) != [program.pc_start]:
            raise VerificationError("record does not start at pc_start")
        if g(rec_pv.NEXT_PC) != [0]:
            raise VerificationError("record does not halt (next_pc != 0)")
        if g(rec_pv.EXIT_CODE) != [0]:
            raise VerificationError("nonzero exit code")
        if g(rec_pv.CONTAINS_EXECUTION_SHARD) != [1]:
            raise VerificationError("no execution shard in record")
        if g(rec_pv.START_EXECUTION_SHARD) != [1]:
            raise VerificationError("execution shards do not start at 1")
        if g(rec_pv.PREV_INIT_ADDR) != [0, 0] or g(rec_pv.PREV_FINALIZE_ADDR) != [0, 0]:
            raise VerificationError("memory address chains do not start at 0")
        if g(rec_pv.START_RECONSTRUCT_DEFERRED) != [0] * 8:
            raise VerificationError("deferred reconstruct chain does not start at 0")
        # the septic digest sum must be the zero digest (START): digests are
        # START + partial-sum, and the in-circuit fold computed
        # acc + (next - START), so a complete execution folds back to START
        zero_digest = [int(c) for c in START[0]] + [int(c) for c in START[1]]
        if g(rec_pv.GLOBAL_SUM) != zero_digest:
            raise VerificationError("global memory digest does not sum to zero")

    def _find_final_vk(self, cp: CompressedProof):
        for _key, (_circ, pk) in (
            list(self._compress_cache.items())
            + list(self._lift_cache.items())
            + list(self._shrink_cache.items())
            + list(self._deferred_cache.items())
        ):
            if root_key(pk.vk.prep_root) == cp.final_vk_root:
                return pk.vk
        vk = getattr(self, "_vk_map", {}).get(cp.final_vk_root)
        if vk is not None:
            return vk
        raise VerificationError(
            "final vk not in this prover's program caches or loaded vk map "
            "(load one with load_vk_map, or export from the proving side "
            "with export_vk_map — the reference's vk_map.bin artifact, "
            "prover/src/shapes.rs:275-304)"
        )

    # -- vk map (prover/src/shapes.rs vk_map analog) -------------------------

    def export_vk_map(self, path: str | None = None) -> dict:
        """Serialize every recursion-program vk this prover has built, so a
        separate process can verify its compressed/shrunk/wrapped proofs
        without rebuilding the programs (reference ships this as
        ``vk_map.bin``).  The map is the verifier's trust root: only proofs
        whose final vk appears in it are accepted."""
        entries = []
        for _key, (_circ, pk) in (
            list(self._lift_cache.items())
            + list(self._compress_cache.items())
            + list(self._shrink_cache.items())
            + list(self._deferred_cache.items())
        ):
            entries.append({
                "root": [str(x) for x in root_key(pk.vk.prep_root)],
                "heights": [[n, int(lh)] for n, lh in pk.vk.prep_heights],
            })
        from .vk_tree import map_entries_root

        out = {
            "version": 2,
            "vks": entries,
            # Merkle root over canonical entry encodings (vk_tree.py): the
            # verifier's trust anchor — ship the map anywhere, pin the root
            "merkle_root": [str(x) for x in map_entries_root(entries)],
        }
        if path is not None:
            import json

            with open(path, "w") as fh:
                json.dump(out, fh)
        return out

    def load_vk_map(self, map_or_path, expected_root=None):
        """Load a vk map (dict or JSON path) for cross-process verification.

        ``expected_root``: the pinned allowed-vks Merkle root (8-tuple of
        canonical ints, or the map's own "merkle_root" strings).  The map's
        entries are re-hashed and the recomputed root must match both the
        map's embedded root and (when given) the pinned one — a tampered,
        truncated, or extended map is rejected
        (vkey_proof.rs:33-126 trust model, host side)."""
        data = map_or_path
        if isinstance(map_or_path, str):
            import json

            with open(map_or_path) as fh:
                data = json.load(fh)
        from .vk_tree import map_entries_root

        recomputed = map_entries_root(data["vks"])
        embedded = tuple(int(x) for x in data.get("merkle_root", ()))
        if embedded and recomputed != embedded:
            raise VerificationError("vk map entries do not match its merkle root")
        if expected_root is not None:
            pinned = tuple(int(x) for x in expected_root)
            if recomputed != pinned:
                raise VerificationError("vk map merkle root does not match pinned root")

        table = {}
        for e in data["vks"]:
            roots = [int(x) for x in e["root"]]
            if len(roots) == 1:  # outer (BN254) single-Fr digest
                root = np.empty(1, dtype=object)
                root[0] = roots[0]
            else:
                root = torch.tensor(roots, dtype=torch.int32)
            vk = VerifyingKey(prep_root=root, prep_heights=[(n, lh) for n, lh in e["heights"]])
            table[tuple(roots)] = vk
        self._vk_map = table
        return table
