"""PLONK wrap: the full ladder core -> compress -> shrink -> wrap (BN254
outer config) -> outer plonkish circuit -> PLONK/KZG, ending in a ~770-byte
proof (the reference's .plonk() action).  The core and recursion proofs run
on the card, the SNARK on the host (at the test config its 8.7 M gates
need about 80 GiB of host memory)."""

from ..snark.outer_circuit import pack_public_values
from ..verifier import PlonkVerifier, encode_plonk_proof, encode_plonk_vk, encode_public_inputs
from ._common import ZKMStdin, client_from_args, timed
from .fibonacci import fibonacci_guest


def main(argv=None) -> dict:
    client, _ = client_from_args(__doc__, argv)
    program = fibonacci_guest()
    stdin = ZKMStdin()
    stdin.write_u32(50)

    pk, vk = timed("setup", client.setup, program)
    proof = timed("prove(plonk)", client.prove, pk, program, stdin,
                  shard_size=1 << 11, mode="plonk")
    assert timed("verify", client.verify, vk, proof, program)

    wp = proof.proofs[0]
    proof_bytes = encode_plonk_proof(wp.proof)
    vk_bytes = encode_plonk_vk(wp.plonk_vk)
    publics = encode_public_inputs(pack_public_values(wp.wrap_public_values))
    print(f"plonk proof: {len(proof_bytes)} bytes; vk: {len(vk_bytes)} bytes")
    assert PlonkVerifier.verify(proof_bytes, vk_bytes, publics)
    print("standalone byte-API verification ok")
    return {"proof_bytes": len(proof_bytes), "vk_bytes": len(vk_bytes), "proof": proof}


if __name__ == "__main__":
    main()
