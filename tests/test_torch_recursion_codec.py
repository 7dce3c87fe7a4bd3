"""The port's compressed-proof bytes (``verifier/stark_codec``).

A one-shard guest is compressed by the port at ``StarkConfig.test()`` on the
minimal machine: ``encode_compressed_proof`` round-trips,
``verify_compressed`` accepts the proof in the port and, through the port's
exported vk map, in the reference; a flipped byte and a tampered public
value are rejected.  The bytes of a two-shard guest against the reference's
are in ``test_torch_recursion_ladder.py`` (``slow``: both sides prove the
ladder).
"""

import copy

import pytest
import torch

from zkmips_tpu.machine.machine import mips_machine as j_mips_machine
from zkmips_tpu.recursion.compress import RecursionProver as JRecursionProver
from zkmips_tpu.stark import machine as jm
from zkmips_tpu.verifier import stark_codec as jcodec

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.executor import Register as R, asm, execute_for_proving
from zkmips_tpu_torch.machine.machine import mips_machine
from zkmips_tpu_torch.recursion import rec_pv
from zkmips_tpu_torch.recursion.compress import RecursionProver
from zkmips_tpu_torch.stark.machine import StarkConfig, VerificationError
from zkmips_tpu_torch.verifier import stark_codec as codec

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def compressed():
    program = asm.prog([*asm.li(R.T0, 5)] + asm.halt_sequence())
    m = mips_machine(StarkConfig.test(), minimal=True)
    pk = m.setup(program, device="cpu")
    proofs = m.prove(pk, execute_for_proving(program)[0], device="cpu", workers=1)
    rp = RecursionProver(m)
    cp = rp.compress(pk.vk, proofs, device="cpu")
    return program, m, pk, proofs, rp, cp


def test_compressed_proof_bytes_round_trip(compressed):
    program, _m, pk, _proofs, rp, cp = compressed
    assert cp.stage == "compress" and cp.num_shards == 1
    b = codec.encode_compressed_proof(cp, config="test")
    cp2, cfg = codec.decode_compressed_proof(b)
    assert cfg == "test"
    assert codec.encode_compressed_proof(cp2, config=cfg) == b
    assert cp2.final_vk_root == cp.final_vk_root and cp2.num_shards == cp.num_shards
    assert cp2.record == cp.record
    assert rp.verify_compressed(pk.vk, program, cp2)
    with pytest.raises(codec.CodecError):
        codec.decode_compressed_proof(b[: len(b) // 2])


def test_reference_accepts_the_ports_compressed_proof(compressed):
    """The reference's ``verify_compressed`` accepts the port's bytes, with
    the port's exported vk map as its trust root."""
    program, _m, pk, _proofs, rp, cp = compressed
    b = codec.encode_compressed_proof(cp, config="test")
    jcp, _cfg = jcodec.decode_compressed_proof(b)
    assert jcodec.encode_compressed_proof(jcp, config="test") == b
    jrp = JRecursionProver(j_mips_machine(jm.StarkConfig.test(), minimal=True))
    exported = rp.export_vk_map()
    jrp.load_vk_map(exported, expected_root=tuple(int(x) for x in exported["merkle_root"]))
    assert jrp.verify_compressed(convert.verifying_key_to_reference(pk.vk, jm), program, jcp)
    assert convert.compressed_proof_to_port(jcp).record == cp.record


def test_flipped_byte_and_tampered_public_value_rejected(compressed):
    program, _m, pk, _proofs, rp, cp = compressed
    b = bytearray(codec.encode_compressed_proof(cp, config="test"))
    b[len(b) // 2] ^= 1
    with pytest.raises((VerificationError, codec.CodecError)):
        rp.verify_compressed(pk.vk, program, codec.decode_compressed_proof(bytes(b))[0])
    bad = copy.deepcopy(cp)
    bad.proof.public_values[rec_pv.EXIT_CODE[0]] += 1
    with pytest.raises(VerificationError):
        rp.verify_compressed(pk.vk, program, bad)


@pytest.mark.gpu
def test_compressed_proof_on_the_card_equals_the_cpu(compressed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    program, m, _pk, _proofs, _rp, cp = compressed
    pk = m.setup(program)
    card = RecursionProver(m).compress(pk.vk, m.prove(pk, execute_for_proving(program)[0]))
    assert codec.encode_compressed_proof(card, config="test") == codec.encode_compressed_proof(cp, config="test")
