"""``io`` of ``zkmips_tpu_torch/examples/`` proves on the CPU with its own
assertions, its proof's bytes equal the reference's and the reference's
verifier accepts it (the check of ``test_torch_examples_prove.py``)."""

from test_torch_examples_prove import check_example_proof


def test_example_proof_equals_the_reference():
    check_example_proof("io")
