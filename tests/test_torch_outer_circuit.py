"""The port's outer verifier circuit and Groth16 over it (``snark/outer_circuit``)
against the reference's, on the toy 3-chip machine of ``test_torch_stark.py``
at ``FriConfig.outer_test()`` (the port's proof equals the reference's):
equal constraint systems and packed public values, a tampered opening
refused by the eager build, Groth16 keys and proofs equal byte for byte
under equal random draws, each package's verifier accepting the other's
proof and rejecting a wrong public input.  Tolerance 0: every value is an
integer."""

import copy
import secrets

import pytest
import torch

from zkmips_tpu import verifier as jverifier
from zkmips_tpu.snark import groth16 as jg16
from zkmips_tpu.snark.outer_circuit import OuterVerifierCircuit as JOuterCircuit
from zkmips_tpu.stark import machine as jm, pcs as jpcs
from zkmips_tpu.verifier import stark_codec as jcodec

from zkmips_tpu_torch import verifier
from zkmips_tpu_torch.snark import groth16
from zkmips_tpu_torch.snark.outer_circuit import OuterVerifierCircuit, pack_public_values
from zkmips_tpu_torch.stark import machine as tm, pcs as tpcs

from test_torch_snark_curve import seeded
from test_torch_stark import PV, RECORD, _jax_machine, _port_machine, _to_reference_proof

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def circuits():
    jmach = _jax_machine(jm.StarkConfig(jpcs.FriConfig.outer_test()))
    jpk = jmach.setup(None)
    jproof = jmach.prove_shard(jpk, RECORD, PV)
    tmach = _port_machine(tm.StarkConfig(tpcs.FriConfig.outer_test()))
    tpk = tmach.setup(None, device="cpu")
    tproof = tmach.prove_shard(tpk, RECORD, PV, device="cpu")
    return {"jcirc": JOuterCircuit(jmach, jpk.vk, jproof), "circ": OuterVerifierCircuit(tmach, tpk.vk, tproof),
            "tmach": tmach, "tpk": tpk, "tproof": tproof, "jproof": jproof}


@pytest.fixture(scope="module")
def groth16_pair(circuits):
    """Groth16 over each package's outer circuit: the reference drawing from
    a patched ``secrets.randbelow``, the port from the same sequence."""
    mp = pytest.MonkeyPatch()
    mp.setattr(secrets, "randbelow", seeded(21))
    try:
        jpk, jvk = jg16.setup(circuits["jcirc"].cs)
        jproof = jg16.prove(jpk, circuits["jcirc"].cs)
    finally:
        mp.undo()
    rng = seeded(21)
    pk, vk = groth16.setup(circuits["circ"].cs, rng=rng)
    return vk, groth16.prove(pk, circuits["circ"].cs, rng=rng), jvk, jproof


def test_the_proofs_are_equal(circuits):
    assert jcodec.encode_core_proof([_to_reference_proof(circuits["tproof"])]) == \
        jcodec.encode_core_proof([circuits["jproof"]])


def test_outer_circuit_equals_the_reference(circuits):
    circ, jcirc = circuits["circ"], circuits["jcirc"]
    assert circ.cs.is_satisfied()
    assert circ.cs.num_public == jcirc.cs.num_public == 1
    assert len(circ.cs.constraints) == len(jcirc.cs.constraints) == 264_730
    assert circ.cs.constraints == jcirc.cs.constraints
    assert circ.cs.values == jcirc.cs.values
    assert circ.packed_pv == jcirc.packed_pv == pack_public_values(circuits["tproof"].public_values.tolist())


def test_tampered_opening_refused(circuits):
    bad = copy.deepcopy(circuits["tproof"])
    bad.opened[0].main_local = bad.opened[0].main_local.clone()
    bad.opened[0].main_local[0, 0] ^= 1
    with pytest.raises(AssertionError):
        OuterVerifierCircuit(circuits["tmach"], circuits["tpk"].vk, bad)


def test_groth16_bytes_equal_the_reference(groth16_pair):
    vk, proof, jvk, jproof = groth16_pair
    assert verifier.encode_groth16_vk(vk) == jverifier.encode_groth16_vk(jvk)
    assert verifier.encode_groth16_proof(proof) == jverifier.encode_groth16_proof(jproof)


def test_each_verifier_accepts_the_others_proof(circuits, groth16_pair):
    vk, proof, jvk, jproof = groth16_pair
    publics = circuits["circ"].packed_pv
    assert groth16.verify(vk, proof, publics)
    assert groth16.verify(vk, jproof, publics)
    assert jg16.verify(jvk, proof, publics)
    bad = [(publics[0] + 1) % groth16.R] + publics[1:]
    assert not groth16.verify(vk, proof, bad)
    assert not jg16.verify(jvk, proof, bad)


@pytest.mark.gpu
def test_card_proof_gives_the_same_circuit(circuits):
    """The toy proof made on the card (the default device) builds the same
    outer circuit as the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    tmach = circuits["tmach"]
    pk = tmach.setup(None)
    circ = OuterVerifierCircuit(tmach, pk.vk, tmach.prove_shard(pk, RECORD, PV))
    assert circ.cs.values == circuits["circ"].cs.values
    assert circ.cs.constraints == circuits["circ"].cs.constraints
