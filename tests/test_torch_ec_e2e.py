"""End to end on the full machine with an EC precompile guest: secp256r1
double and add, proved by the port's ``MipsMachine`` on the CPU and by the
reference package's numpy prover, each package running its own interpreter.

Proofs are integer data and must be equal bit for bit (tolerance 0): every
field through ``convert.shard_proof_to_numpy`` and the ``encode_core_proof``
bytes.  At ``StarkConfig.test()``.  The guest is a file of its own so that a
test run spread over workers by file proves it beside the keccak guest of
``test_torch_full_e2e.py``.
"""

import pytest

from zkmips_tpu_torch.executor import guests

from test_torch_full_e2e import prove_both, to_reference
from test_torch_stark import _assert_same

# secp256r1 double and add: the two curve chips with the fewest DAG nodes
# (37,000 and 38,000)
WEI = guests.WEI_CURVES["secp256r1"]
CHIPS = {"Secp256r1Add", "Secp256r1Double", "SyscallCore", "SyscallPrecompile"}


@pytest.fixture(scope="module")
def run():
    return prove_both(guests.wei_body(*WEI[:3], None, *WEI[4:]))


def test_ec_proofs_equal_the_reference_field_by_field(run):
    assert len(run["tproofs"]) == len(run["jproofs"])
    for i, (got, ref) in enumerate(zip(to_reference(run["tproofs"]), run["jproofs"])):
        _assert_same(got, ref, f"proof[{i}]")


def test_ec_encoded_bytes_equal_the_reference(run):
    from zkmips_tpu.verifier import stark_codec

    assert stark_codec.encode_core_proof(to_reference(run["tproofs"])) == \
        stark_codec.encode_core_proof(run["jproofs"])


def test_ec_port_verifier_accepts(run):
    assert run["tm"].verify(run["tpk"].vk, run["tproofs"], run["tp"])


def test_ec_guest_reaches_the_curve_chips(run):
    assert CHIPS <= {n for p in run["tproofs"] for n in p.chip_names}
