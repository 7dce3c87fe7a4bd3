"""The prover's long-lived heap is kept out of the cyclic garbage collector's
walks (``utils/heap.py``): what ``ProverClient.setup`` built (the proving key,
the chips' constraint DAGs) and what the recursion prover's cache built for a
compressed proof (the lift program, its instructions, its proving key) is
frozen once built, and stays out after a second job, which hits the cache and
builds nothing again.  The second job's proof verifies."""

import gc

import torch

from zkmips_tpu_torch.executor import Opcode, Register, asm
from zkmips_tpu_torch.sdk import ProverClient, ZKMStdin
from zkmips_tpu_torch.stark.machine import StarkConfig

torch.set_num_threads(2)


def _walked(objs) -> list:
    """The objects of ``objs`` that the collector walks."""
    ids = {id(o) for o in gc.get_objects()}
    return [o for o in objs if id(o) in ids]


def test_long_lived_heap_stays_out_of_the_collector_after_a_second_job():
    R, O = Register, Opcode
    program = asm.prog([asm.addi(R.A0, 0, 5), asm.addi(R.A0, R.A0, -1),
                        asm.branch(O.BNE, R.A0, R.ZERO, -8), asm.nop()] + asm.halt_sequence())
    client = ProverClient(config=StarkConfig.test(), device="cpu")
    pk, vk = client.setup(program)
    dags = [c.constraints for c in client.machine.machine.chips]
    setup_built = [pk, pk.vk, *dags, *(e for dag in dags for e in dag)]
    assert _walked(setup_built) == []

    client.prove(pk, program, ZKMStdin(), mode="compressed")
    cache = client._recursion_prover()._lift_cache
    (entry,) = cache.values()
    circ, lift_pk = entry
    lift_built = [circ, circ.program, circ.program.instructions, lift_pk, *circ.program.instructions]
    assert _walked(lift_built) == []

    proof = client.prove(pk, program, ZKMStdin(), mode="compressed")
    assert len(cache) == 1 and next(iter(cache.values())) is entry
    assert _walked(setup_built + lift_built) == []
    assert client.verify(vk, proof, program)
