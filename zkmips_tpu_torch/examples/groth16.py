"""Groth16 wrap: the full ladder core -> compress -> shrink -> wrap (BN254
outer config) -> outer R1CS -> Groth16, ending in a 256-byte proof
(the reference's .groth16() action).  The core and recursion proofs run on
the card, the SNARK on the host."""

from ..snark.outer_circuit import pack_public_values
from ..verifier import Groth16Verifier, encode_groth16_proof, encode_groth16_vk, encode_public_inputs
from ._common import ZKMStdin, client_from_args, timed
from .fibonacci import fibonacci_guest


def main(argv=None) -> dict:
    client, _ = client_from_args(__doc__, argv)
    program = fibonacci_guest()
    stdin = ZKMStdin()
    stdin.write_u32(50)

    pk, vk = timed("setup", client.setup, program)
    proof = timed("prove(groth16)", client.prove, pk, program, stdin,
                  shard_size=1 << 11, mode="groth16")
    assert timed("verify", client.verify, vk, proof, program)

    wg = proof.proofs[0]
    proof_bytes = encode_groth16_proof(wg.proof)
    vk_bytes = encode_groth16_vk(wg.groth16_vk)
    publics = encode_public_inputs(pack_public_values(wg.wrap_public_values))
    print(f"groth16 proof: {len(proof_bytes)} bytes; vk: {len(vk_bytes)} bytes")
    assert Groth16Verifier.verify(proof_bytes, vk_bytes, publics)
    print("standalone byte-API verification ok")
    return {"proof_bytes": len(proof_bytes), "vk_bytes": len(vk_bytes), "proof": proof}


if __name__ == "__main__":
    main()
