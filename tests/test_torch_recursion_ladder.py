"""The whole recursion ladder against the reference's (``slow``: each side
proves every stage, several minutes on a CPU).

* lift -> compress -> shrink -> wrap of ``tests/test_recursion.py``'s
  guest, run for 25 iterations so that ``shard_size=128`` gives two shards
  and compress joins a pair, on the minimal machine at
  ``StarkConfig.test()``: the ``encode_compressed_proof`` bytes are equal at
  every stage (the wrap's BN254 digests included, at ``FriConfig.outer_test``),
  and each package's ``verify_compressed`` accepts the other's proof;
* the deferred chain of ``tests/test_deferred_aggregation.py``: guest A's
  compressed proof is verified inside guest B, and ``prove_deferred`` gives
  the reference's ``encode_deferred_proof`` bytes; each package's
  ``verify_deferred`` accepts the chain against guest B's compressed proof.
"""

import pytest
import torch

from zkmips_tpu.executor import Executor as JExecutor, asm as jasm
from zkmips_tpu.executor import execute_for_proving as j_execute_for_proving
from zkmips_tpu.machine import machine as j_machine_mod
from zkmips_tpu.recursion import compress as jcompress
from zkmips_tpu.recursion.verifier import record_digest as j_record_digest
from zkmips_tpu.stark import machine as jm, pcs as jpcs
from zkmips_tpu.verifier import stark_codec as jcodec

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.executor import Executor, asm, execute_for_proving
from zkmips_tpu_torch.machine import machine as t_machine_mod
from zkmips_tpu_torch.recursion.compress import RecursionProver
from zkmips_tpu_torch.recursion.rec_pv import canonical_digest
from zkmips_tpu_torch.recursion.verifier import record_digest, rolling_deferred_digest
from zkmips_tpu_torch.stark.machine import StarkConfig
from zkmips_tpu_torch.verifier import stark_codec as codec

from test_torch_executor import JAX_SIDE, PORT_SIDE

torch.set_num_threads(4)


LADDER_ITERS = 25  # 160 cycles: two shards of up to 128 (the reference's 9 run in one)


def _ladder_body(side, n=LADDER_ITERS):
    a, _I, R, O = side
    return [
        a.addi(R.A0, 0, n), a.addi(R.T0, 0, 0), a.addi(R.T1, 0, 1),
        a.alu(O.ADD, R.T2, R.T0, R.T1),
        a.alu(O.ADD, R.T0, R.T1, R.ZERO),
        a.alu(O.ADD, R.T1, R.T2, R.ZERO),
        a.addi(R.A0, R.A0, -1),
        a.branch(O.BNE, R.A0, R.ZERO, -5 * 4),
        a.nop(),
    ]


@pytest.mark.slow
def test_compress_shrink_wrap_ladder_bytes_equal_the_reference():
    jp = jasm.prog(_ladder_body(JAX_SIDE) + jasm.halt_sequence())
    tp = asm.prog(_ladder_body(PORT_SIDE) + asm.halt_sequence())
    jrecords = JExecutor(jp, shard_size=128).run()
    trecords, _ = execute_for_proving(tp, shard_size=128)
    jmach = j_machine_mod.mips_machine(jm.StarkConfig.test(), minimal=True)
    tmach = t_machine_mod.mips_machine(StarkConfig.test(), minimal=True)
    jpk, tpk = jmach.setup(jp), tmach.setup(tp, device="cpu")
    jproofs = jmach.prove(jpk, jrecords, device=False, workers=1)
    tproofs = tmach.prove(tpk, trecords, device="cpu")
    assert len(tproofs) == len(jproofs) == 2
    jrp, trp = jcompress.RecursionProver(jmach), RecursionProver(tmach)
    jstage = jrp.compress(jpk.vk, jproofs)
    tstage = trp.compress(tpk.vk, tproofs, device="cpu")
    jvk = convert.verifying_key_to_reference(tpk.vk, jm)
    for step in ("compress", "shrink", "wrap"):
        if step != "compress":
            jstage = getattr(jrp, step)(jstage)
            tstage = getattr(trp, step)(tstage, device="cpu")
        assert tstage.stage == jstage.stage == step
        tb = codec.encode_compressed_proof(tstage, config="test")
        assert tb == jcodec.encode_compressed_proof(jstage, config="test"), step
        assert trp.verify_compressed(tpk.vk, tp, codec.decode_compressed_proof(tb)[0])
        assert jrp.verify_compressed(jvk, jp, jcodec.decode_compressed_proof(tb)[0])
        assert trp.verify_compressed(tpk.vk, tp, convert.compressed_proof_to_port(jstage))
        assert jrp.verify_compressed(
            jpk.vk, jp, convert.compressed_proof_to_reference(tstage, jcompress, jm, jpcs))
    assert tstage.proof.main_root.dtype == object  # the wrap's BN254 digests


def _sys(a, R, code, a0=0, a1=0):
    return [*a.li(R.V0, int(code)), *a.li(R.A0, a0), *a.li(R.A1, a1), a.syscall()]


def _store_words(a, R, addr, words):
    out = []
    for i, w in enumerate(words):
        out += [*a.li(R.T0, int(w)), *a.li(R.T1, addr + 4 * i), a.sw(R.T0, R.T1)]
    return out


_DEFERRED_AIRS = ("CpuAir", "AddSubAir", "BitwiseAir", "LtAir", "ShiftLeftAir", "ShiftRightAir",
                  "BranchAir", "JumpAir", "MemoryInstrAir", "SyscallInstrAir", "MemoryLocalAir",
                  "MemoryGlobalInitAir", "MemoryGlobalFinalizeAir", "GlobalAir", "ProgramAir",
                  "ByteAir")


def _deferred_machine(mod, config):
    """The sixteen-chip machine of ``tests/test_deferred_aggregation.py``."""
    airs = {type(a).__name__: type(a) for a in mod.core_chip_airs()}
    return mod.MipsMachine(config, chip_airs=[airs[n]() for n in _DEFERRED_AIRS])


def _deferred_chain(side, mod, config, Exec, rp_cls, execute, prove_kw, stage_kw):
    """Guest A compressed, guest B verifying it in the VM and committing the
    chain, the deferred link proved; returns what the two packages compare."""
    a, _I, R, _O = side
    mA = _deferred_machine(mod, config)
    progA = a.prog([*a.li(R.T0, 5)] + a.halt_sequence())
    recordsA, _ = execute(progA)
    pkA = mA.setup(progA, **stage_kw)
    proofsA = mA.prove(pkA, recordsA, **prove_kw)
    rp = rp_cls(mA)
    cpA = rp.compress(pkA.vk, proofsA, **stage_kw)
    assert rp.verify_compressed(pkA.vk, progA, cpA)
    child_vk = rp._find_final_vk(cpA)
    vk_root = canonical_digest(child_vk.prep_root)
    child_pv = [int(x) for x in cpA.proof.public_values.tolist()]
    chain1 = rolling_deferred_digest([0] * 8, vk_root, child_pv)
    child_pvd = record_digest(child_pv)
    assert child_pvd == j_record_digest(child_pv)

    VKEY_PTR, PVD_PTR = 0x2000, 0x2100
    body = _store_words(a, R, VKEY_PTR, vk_root) + _store_words(a, R, PVD_PTR, child_pvd)
    body += _sys(a, R, 0x1B, VKEY_PTR, PVD_PTR)  # VERIFY_ZKM_PROOF
    for i, w in enumerate(chain1):
        body += _sys(a, R, 0x1A, i, w)  # COMMIT_DEFERRED_PROOFS
    progB = a.prog(body + a.halt_sequence())
    exB = Exec(progB)
    checked = {}

    def subproof_verifier(proof, proof_vk, vkey, pv_digest):
        assert vkey == vk_root and pv_digest == child_pvd
        rp.rec.verify(proof_vk, proof)
        checked["ok"] = True

    exB.subproof_verifier = subproof_verifier
    exB.proof_stream.append((cpA.proof, child_vk))
    recordsB = exB.run()
    assert checked.get("ok") and exB.deferred_proofs_digest == chain1
    mB = _deferred_machine(mod, config)
    pkB = mB.setup(progB, **stage_kw)
    proofsB = mB.prove(pkB, recordsB, **prove_kw)
    assert mB.verify(pkB.vk, proofsB, progB)
    dp, new_digest = rp.prove_deferred(cpA, [0] * 8, **stage_kw)
    assert new_digest == chain1
    cpB = rp_cls(mB).compress(pkB.vk, proofsB, **stage_kw)
    rp.verify_deferred([dp], cpB)
    return rp, dp, cpB, progB, pkB


@pytest.mark.slow
def test_deferred_chain_bytes_equal_the_reference():
    cpu = {"device": "cpu"}
    trp, tdp, tcpB, _tprogB, _tpkB = _deferred_chain(
        PORT_SIDE, t_machine_mod, StarkConfig.test(), Executor, RecursionProver,
        lambda p: execute_for_proving(p), {"device": "cpu", "workers": 1}, cpu)
    jrp, jdp, jcpB, _jprogB, _jpkB = _deferred_chain(
        JAX_SIDE, j_machine_mod, jm.StarkConfig.test(), JExecutor, jcompress.RecursionProver,
        lambda p: j_execute_for_proving(p), {"device": False, "workers": 1}, {})
    tb = codec.encode_deferred_proof(tdp, config="test")
    assert tb == jcodec.encode_deferred_proof(jdp, config="test")
    assert codec.encode_compressed_proof(tcpB, config="test") == \
        jcodec.encode_compressed_proof(jcpB, config="test")
    # each chain walker accepts the other package's link
    trp.verify_deferred([convert.deferred_proof_to_port(jdp)], tcpB)
    jrp.verify_deferred([convert.deferred_proof_to_reference(tdp, jcompress, jm, jpcs)], jcpB)
    bad = codec.decode_deferred_proof(tb)[0]
    bad.new_digest[0] = (bad.new_digest[0] + 1) % 0x7F000001
    with pytest.raises(Exception, match="chain|bind"):
        trp.verify_deferred([bad], tcpB)


@pytest.mark.gpu
def test_ladder_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    tp = asm.prog(_ladder_body(PORT_SIDE) + asm.halt_sequence())
    records, _ = execute_for_proving(tp, shard_size=128)
    m = t_machine_mod.mips_machine(StarkConfig.test(), minimal=True)
    out = {}
    for dev in ("cuda", "cpu"):
        pk = m.setup(tp, device=dev)
        rp = RecursionProver(m)
        stage = rp.compress(pk.vk, m.prove(pk, records, device=dev), device=dev)
        out[dev] = [codec.encode_compressed_proof(stage, config="test")]
        for step in ("shrink", "wrap"):
            stage = getattr(rp, step)(stage, device=dev)
            out[dev].append(codec.encode_compressed_proof(stage, config="test"))
    assert out["cuda"] == out["cpu"]
