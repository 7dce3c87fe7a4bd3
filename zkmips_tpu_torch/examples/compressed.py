"""Compressed proofs: all shard proofs recursively aggregated into one
recursion proof of constant size (the reference's .compressed() action +
compress tree, prover/src/lib.rs:614)."""

from ._common import ZKMStdin, client_from_args, timed
from .fibonacci import fibonacci_guest


def main(argv=None) -> dict:
    client, _ = client_from_args(__doc__, argv)
    program = fibonacci_guest()
    stdin = ZKMStdin()
    stdin.write_u32(120)

    pk, vk = timed("setup", client.setup, program)
    # small shards force a multi-shard execution -> a real compress tree
    # (each leaf builds + proves an in-DSL shard verifier)
    proof = timed("prove(compressed)", client.prove, pk, program, stdin,
                  shard_size=1 << 9, mode="compressed")
    cp = proof.proofs[0]
    print(f"{cp.num_shards} shard proof(s) aggregated; stage={cp.stage}")
    assert timed("verify", client.verify, vk, proof, program)
    print("ok")
    return {"num_shards": cp.num_shards, "stage": cp.stage, "proof": proof}


if __name__ == "__main__":
    main()
