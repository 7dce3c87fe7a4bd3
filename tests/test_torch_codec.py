"""The port's proof bytes and byte-API verifier (``verifier/stark_codec``)
against the reference package's.

A guest that writes "hi!!" to the public-values stream and commits its
sha256 digest (``tests/test_stark_codec.py``'s) is proved by both packages
on the full machine at ``StarkConfig.test()``.  The bytes must be equal
(tolerance 0), each package's ``verify_core`` must accept the other's
bytes, and the port must reject what the reference rejects.
"""

import hashlib

import pytest
import torch

from zkmips_tpu.executor import Executor as JExecutor
from zkmips_tpu.machine.machine import mips_machine as j_mips_machine
from zkmips_tpu.stark import machine as jmachine
from zkmips_tpu.stark import pcs as jpcs
from zkmips_tpu.verifier import stark_codec as jcodec

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.executor import Register as R, asm, execute_for_proving, stream_for_proving
from zkmips_tpu_torch.machine.machine import mips_machine
from zkmips_tpu_torch.stark.machine import StarkConfig, VerificationError
from zkmips_tpu_torch.verifier import stark_codec as codec

from test_torch_interpreter import ref_program
from test_torch_stark import _assert_same

torch.set_num_threads(2)

PV_STREAM = b"hi!!"
TEST_ONLY = ("core", "test")


def _sys(code, a0=0, a1=0):
    return [*asm.li(R.V0, int(code)), *asm.li(R.A0, a0), *asm.li(R.A1, a1), asm.syscall()]


def pv_guest():
    digest = hashlib.sha256(PV_STREAM).digest()
    words = [int.from_bytes(digest[4 * i : 4 * i + 4], "little") for i in range(8)]
    body = [
        *asm.li(R.T0, int.from_bytes(PV_STREAM, "little")),
        *asm.li(R.T1, 0x2000),
        asm.sw(R.T0, R.T1),
        *asm.li(R.A2, 4),
        *_sys(2, 3, 0x2000),  # WRITE(fd=3, ptr, len=a2)
    ]
    for i, w in enumerate(words):
        body += _sys(0x10, i, w)  # COMMIT(word index, value)
    return asm.prog(body + asm.halt_sequence())


@pytest.fixture(scope="module")
def proven():
    tp = pv_guest()
    jp = ref_program(tp)
    records, info = execute_for_proving(tp, shard_size=256)
    assert info["public_values"] == PV_STREAM
    m = mips_machine(StarkConfig.test())
    pk = m.setup(tp, device="cpu")
    proofs = m.prove(pk, records, device="cpu")
    jm = j_mips_machine(jmachine.StarkConfig.test())
    jpk = jm.setup(jp)
    jproofs = jm.prove(jpk, JExecutor(jp, shard_size=256).run())
    return {"tp": tp, "m": m, "pk": pk, "proofs": proofs, "jp": jp, "jpk": jpk, "jproofs": jproofs,
            "bytes": codec.encode_core_proof(proofs, config="test"),
            "vk": codec.encode_vk(pk.vk, tp.pc_start)}


def test_bytes_equal_the_reference(proven):
    assert proven["bytes"] == jcodec.encode_core_proof(proven["jproofs"], config="test")
    assert proven["vk"] == jcodec.encode_vk(proven["jpk"].vk, proven["jp"].pc_start)
    converted = [convert.shard_proof_to_reference(p, jmachine, jpcs) for p in proven["proofs"]]
    assert proven["bytes"] == jcodec.encode_core_proof(converted, config="test")


def test_roundtrip_is_deterministic_and_rebuilds_the_ports_objects(proven):
    decoded, cfg = codec.decode_core_proof(proven["bytes"])
    assert cfg == "test"
    assert codec.encode_core_proof(decoded, config=cfg) == proven["bytes"]
    p = decoded[0]
    assert p.main_root.dtype == torch.int32 and p.main_root.device.type == "cpu"
    assert p.opened[0].quotient[0].shape == (4, 4)
    ref = convert.shard_proof_to_reference(p, jmachine, jpcs)
    _assert_same(ref, proven["jproofs"][0])
    vk, pc = codec.decode_vk(proven["vk"])
    assert pc == proven["tp"].pc_start
    assert codec.encode_vk(vk, pc) == proven["vk"]
    assert torch.equal(vk.prep_root, proven["pk"].vk.prep_root)


def test_each_verify_core_accepts_the_others_bytes(proven):
    jbytes = jcodec.encode_core_proof(proven["jproofs"], config="test")
    jvk = jcodec.encode_vk(proven["jpk"].vk, proven["jp"].pc_start)
    assert codec.verify_core(jbytes, jvk, expected_pv_stream=PV_STREAM, allowed_configs=TEST_ONLY)
    assert jcodec.verify_core(proven["bytes"], proven["vk"], expected_pv_stream=PV_STREAM,
                              allowed_configs=TEST_ONLY)


def _flip(b: bytes, at: int) -> bytes:
    out = bytearray(b)
    out[at] ^= 1
    return bytes(out)


@pytest.mark.parametrize("where", ["middle", "last_public_value"])
def test_flipped_byte_is_rejected(proven, where):
    b = proven["bytes"]
    at = len(b) // 2 if where == "middle" else len(b) - 1
    with pytest.raises((VerificationError, codec.CodecError)):
        codec.verify_core(_flip(b, at), proven["vk"], allowed_configs=TEST_ONLY)
    if where == "middle":  # the reference's own case (tests/test_stark_codec.py)
        with pytest.raises((jmachine.VerificationError, jcodec.CodecError)):
            jcodec.verify_core(_flip(b, at), proven["vk"], allowed_configs=TEST_ONLY)


def test_wrong_public_values_stream_is_rejected(proven):
    with pytest.raises(VerificationError, match="digest"):
        codec.verify_core(proven["bytes"], proven["vk"], expected_pv_stream=b"not the committed stream",
                          allowed_configs=TEST_ONLY)


def test_config_is_pinned(proven):
    with pytest.raises(VerificationError, match="allowed_configs"):
        codec.verify_core(proven["bytes"], proven["vk"])


@pytest.mark.parametrize("cut", [1, 5, 17, "third"])
def test_truncated_bytes_raise(proven, cut):
    b = proven["bytes"]
    n = len(b) // 3 if cut == "third" else cut
    with pytest.raises((codec.CodecError, VerificationError)):
        codec.verify_core(b[:n], proven["vk"], allowed_configs=TEST_ONLY)
    with pytest.raises(codec.CodecError):
        codec.decode_core_proof(b + b"\x00\x00\x00\x00")


def test_header_and_bn254_arrays_are_refused(proven):
    b = proven["bytes"]
    with pytest.raises(codec.CodecError, match="header"):
        codec.decode_core_proof(b"ZKSX" + b[4:])
    with pytest.raises(codec.CodecError, match="header"):
        codec.decode_vk(b"ZKVX" + proven["vk"][4:])
    # the first array (the main root) tagged as a BN254 (fr256) array
    fr = b[:20] + (0xFFFF_FFFF).to_bytes(4, "little") + b[20:]
    with pytest.raises(codec.CodecError, match="BN254"):
        codec.decode_core_proof(fr)


@pytest.mark.gpu
def test_card_streamed_bytes_equal_the_reference(proven):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    m, tp = proven["m"], proven["tp"]
    pk = m.setup(tp)
    proofs = m.prove_streaming(pk, stream_for_proving(tp, shard_size=256))
    b = codec.encode_core_proof(proofs, config="test")
    assert b == proven["bytes"]
    assert codec.verify_core(b, codec.encode_vk(pk.vk, tp.pc_start), expected_pv_stream=PV_STREAM,
                             allowed_configs=TEST_ONLY)
    with pytest.raises((VerificationError, codec.CodecError)):
        codec.verify_core(_flip(b, len(b) // 2), proven["vk"], allowed_configs=TEST_ONLY)
