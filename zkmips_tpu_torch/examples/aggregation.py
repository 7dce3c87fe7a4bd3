"""Proof aggregation: a guest verifies another guest's proof in-VM
(examples/aggregation in the reference).

Guest A runs and is compressed; guest B calls VERIFY_ZKM_PROOF on A's
compressed proof and commits the rolling deferred digest; the recursion
layer proves the deferred chain (DeferredVerifierCircuit) and the verifier
matches the chain tail against B's committed deferred_proofs_digest.
"""

from ..executor import Executor, Register, asm
from ..recursion.compress import RecursionProver
from ..recursion.rec_pv import canonical_digest
from ..recursion.verifier import rolling_deferred_digest
from ._common import client_from_args, timed

R = Register


def _sys(code, a0=0, a1=0):
    return [*asm.li(R.V0, int(code)), *asm.li(R.A0, a0), *asm.li(R.A1, a1), asm.syscall()]


def _store_words(addr, words):
    out = []
    for i, w in enumerate(words):
        out += [*asm.li(R.T0, int(w)), *asm.li(R.T1, addr + 4 * i), asm.sw(R.T0, R.T1)]
    return out


def guest_a():
    return asm.prog([*asm.li(R.T0, 5)] + asm.halt_sequence())


def guest_b(vk_root, child_pv, chain):
    """Verify A's proof (VERIFY_ZKM_PROOF) and commit the deferred chain."""
    body = _store_words(0x2000, vk_root) + _store_words(0x2100, child_pv)
    body += _sys(0x1B, 0x2000, 0x2100)
    for i, w in enumerate(chain):
        body += _sys(0x1A, i, w)
    return asm.prog(body + asm.halt_sequence())


def main(argv=None) -> dict:
    client, args = client_from_args(__doc__, argv)
    dev = args.device
    m = client.machine
    rp = RecursionProver(m)

    # guest A
    prog_a = guest_a()
    ex_a = Executor(prog_a)
    records_a = ex_a.run()
    pk_a = m.setup(prog_a, device=dev)
    proofs_a = timed("prove A", m.prove, pk_a, records_a, device=dev)
    cp_a = timed("compress A", rp.compress, pk_a.vk, proofs_a, device=dev)

    child_vk = rp._find_final_vk(cp_a)
    vk_root = canonical_digest(child_vk.prep_root)
    child_pv = [int(x) for x in cp_a.proof.public_values]
    chain = rolling_deferred_digest([0] * 8, vk_root, child_pv)

    # guest B: verify A's proof + commit the deferred chain
    prog_b = guest_b(vk_root, child_pv, chain)
    ex_b = Executor(prog_b)
    ex_b.proof_stream.append((cp_a.proof, child_vk))
    ex_b.subproof_verifier = lambda p, vk, vkey, pvd: rp.rec.verify(vk, p)
    records_b = ex_b.run()
    pk_b = m.setup(prog_b, device=dev)
    proofs_b = timed("prove B", m.prove, pk_b, records_b, device=dev)
    assert m.verify(pk_b.vk, proofs_b, prog_b)

    dp, new_digest = timed("prove deferred chain", rp.prove_deferred, cp_a, [0] * 8, device=dev)
    cp_b = timed("compress B", rp.compress, pk_b.vk, proofs_b, device=dev)
    assert rp.verify_compressed(pk_b.vk, prog_b, cp_b)
    rp.verify_deferred([dp], cp_b)
    print("aggregated: guest B verifiably verified guest A; chain tail matches")
    return {"chain": chain, "new_digest": list(new_digest)}


if __name__ == "__main__":
    main()
