"""``fibonacci`` of ``zkmips_tpu_torch/examples/`` proves on the CPU
(``main(["--cpu"])``, the test config) with its own assertions; the proof's
bytes equal the reference client's proof of the same guest and stdin, and
the reference's ``MipsMachine.verify`` accepts the port's shard proofs
(through ``convert.shard_proof_to_reference``).  ``io`` is held the same
way in ``test_torch_examples_prove_io.py`` (a file each keeps each under a
minute and a half on one worker)."""

from zkmips_tpu.sdk import ProverClient as JProverClient, ZKMStdin as JZKMStdin
from zkmips_tpu.stark import machine as jmachine, pcs as jpcs

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.examples import fibonacci, io

from test_torch_interpreter import ref_program

CASES = {
    "fibonacci": (fibonacci, fibonacci.fibonacci_guest, [1000]),
    "io": (io, io.adder_guest, [1000, 58]),
}


def check_example_proof(name: str):
    mod, build, words = CASES[name]
    out = mod.main(["--cpu"])
    proof = out["proof"]
    assert proof.mode == "core" and proof.config == "test"

    jclient = JProverClient(config=jmachine.StarkConfig.test())
    jprogram = ref_program(build())
    jpk, jvk = jclient.setup(jprogram)
    stdin = JZKMStdin()
    for w in words:
        stdin.write_u32(w)
    jproof = jclient.prove(jpk, jprogram, stdin)
    assert proof.to_bytes() == jproof.to_bytes()
    assert proof.committed_value_digest == jproof.committed_value_digest
    ref_proofs = [convert.shard_proof_to_reference(p, jmachine, jpcs) for p in proof.proofs]
    assert jclient.machine.verify(jvk, ref_proofs, jprogram)


def test_example_proof_equals_the_reference():
    check_example_proof("fibonacci")
