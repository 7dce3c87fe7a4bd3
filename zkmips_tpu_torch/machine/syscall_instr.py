"""SyscallInstrs chip: verifies SYSCALL-opcode rows (halt, write, commit,
hint streams).  Precompile syscalls additionally send Syscall-kind lookups
to their precompile chips (added with the precompile work).

Analog of crates/core/machine/src/syscall/instructions/.
"""

from __future__ import annotations

import numpy as np

from ..executor.opcodes import Opcode, SyscallCode
from ..stark.air import AirBuilder, LookupKind
from .gadgets import ColView
from .instr_chip import InstrAir
from .pv import PV_DEFERRED_DIGEST, PV_DIGEST

SYS_FLAGS = [
    ("is_halt_sc", SyscallCode.HALT),
    ("is_write_sc", SyscallCode.WRITE),
    ("is_commit_sc", SyscallCode.COMMIT),
    ("is_commitdef_sc", SyscallCode.COMMIT_DEFERRED_PROOFS),
    ("is_verify_sc", SyscallCode.VERIFY_ZKM_PROOF),
    ("is_hintlen_sc", SyscallCode.SYSHINTLEN),
    ("is_hintread_sc", SyscallCode.SYSHINTREAD),
    ("is_enteru_sc", SyscallCode.ENTER_UNCONSTRAINED),
    ("is_shaext_sc", SyscallCode.SHA_EXTEND),
    ("is_shacmp_sc", SyscallCode.SHA_COMPRESS),
    ("is_p2perm_sc", SyscallCode.POSEIDON2_PERMUTE),
    ("is_keccak_sc", SyscallCode.KECCAK_SPONGE),
    ("is_k1add_sc", SyscallCode.SECP256K1_ADD),
    ("is_k1dbl_sc", SyscallCode.SECP256K1_DOUBLE),
    ("is_k1dec_sc", SyscallCode.SECP256K1_DECOMPRESS),
    ("is_r1add_sc", SyscallCode.SECP256R1_ADD),
    ("is_r1dbl_sc", SyscallCode.SECP256R1_DOUBLE),
    ("is_r1dec_sc", SyscallCode.SECP256R1_DECOMPRESS),
    ("is_bnadd_sc", SyscallCode.BN254_ADD),
    ("is_bndbl_sc", SyscallCode.BN254_DOUBLE),
    ("is_blsadd_sc", SyscallCode.BLS12381_ADD),
    ("is_blsdbl_sc", SyscallCode.BLS12381_DOUBLE),
    ("is_blsdec_sc", SyscallCode.BLS12381_DECOMPRESS),
    ("is_edadd_sc", SyscallCode.ED_ADD),
    ("is_eddec_sc", SyscallCode.ED_DECOMPRESS),
    ("is_bnfpa_sc", SyscallCode.BN254_FP_ADD),
    ("is_bnfps_sc", SyscallCode.BN254_FP_SUB),
    ("is_bnfpm_sc", SyscallCode.BN254_FP_MUL),
    ("is_bnf2a_sc", SyscallCode.BN254_FP2_ADD),
    ("is_bnf2s_sc", SyscallCode.BN254_FP2_SUB),
    ("is_bnf2m_sc", SyscallCode.BN254_FP2_MUL),
    ("is_blfpa_sc", SyscallCode.BLS12381_FP_ADD),
    ("is_blfps_sc", SyscallCode.BLS12381_FP_SUB),
    ("is_blfpm_sc", SyscallCode.BLS12381_FP_MUL),
    ("is_blf2a_sc", SyscallCode.BLS12381_FP2_ADD),
    ("is_blf2s_sc", SyscallCode.BLS12381_FP2_SUB),
    ("is_blf2m_sc", SyscallCode.BLS12381_FP2_MUL),
    ("is_u256m_sc", SyscallCode.UINT256_MUL),
    ("is_u2048_sc", SyscallCode.U256XU2048_MUL),
]
# syscalls whose events are consumed by a precompile chip (should_send bit)
PRECOMPILE_FLAGS = {
    n for n, _c in SYS_FLAGS
    if n not in {"is_halt_sc", "is_write_sc", "is_commit_sc",
                 "is_commitdef_sc", "is_verify_sc",
                 "is_hintlen_sc", "is_hintread_sc", "is_enteru_sc"}
}


class SyscallInstrAir(InstrAir):
    name = "SyscallInstrs"
    OPCODES = [Opcode.SYSCALL]
    EXTRA_COLS = (
        [n for n, _ in SYS_FLAGS]
        + ["is_linux_sc", "is_extgroup_sc", "extgroup_inv"]
        + [f"digest_idx{i}" for i in range(8)]
        # KoalaBear-canonical range check on the COMMIT_DEFERRED_PROOFS
        # operand (reference syscall/instructions/columns.rs:66): the digest
        # word c must be < P = 0x7F000001, i.e. hi < 0x7F00, or
        # hi == 0x7F00 and lo == 0
        + ["kb_hi_max", "kb_lt"]
    )

    def control_flags(self, col, is_real, flag):
        # exit_group (Linux) halts exactly like HALT (executor.rs dispatch)
        is_halt = col("is_halt_sc") + col("is_extgroup_sc")
        return is_halt, is_real - is_halt

    def num_extra_expr(self, col):
        e = 0
        for n, code in SYS_FLAGS:
            if code.num_extra_cycles:
                e = e + col(n) * code.num_extra_cycles
        return e

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        is_real = col("is_real")
        pa = col.word("pa")  # previous $v0 = syscall id
        is_linux = col("is_linux_sc")
        b.assert_bool(is_linux)
        flags = [col(n) for n, _ in SYS_FLAGS]
        total = is_linux
        for f_ in flags:
            total = total + f_
        # unconditional: padding rows are forced all-zero, so no flag can
        # fire a bridge send / precompile send with is_real = 0
        # (reference syscall/instructions/air.rs one-hot over is_real)
        b.assert_eq(total, is_real)
        for f_, (_n, code) in zip(flags, SYS_FLAGS):
            b.assert_bool(f_)
            b.when(f_).assert_eq(pa.lo, int(code) & 0xFFFF)
            b.when(f_).assert_eq(pa.hi, int(code) >> 16)
        # exit_group: a Linux syscall that halts; the SysLinux chip pins the
        # id set, this flag only routes the halt semantics.  Biconditional
        # (reference eval_is_halt_syscall IsZeroOperation, syscall/
        # instructions/air.rs:339-376): under is_linux the inverse witness
        # forces is_extgroup = 1 exactly when pa.lo == SYS_EXT_GROUP (pa.hi
        # is pinned to 0 by the SysLinux bridge message), so a prover cannot
        # suppress the halt on an exit_group row.
        is_extgroup = col("is_extgroup_sc")
        b.assert_bool(is_extgroup)
        b.when(is_extgroup).assert_eq(pa.lo, int(SyscallCode.SYS_EXT_GROUP))
        b.when(is_extgroup).assert_zero(pa.hi)
        b.when(is_extgroup).assert_one(is_linux)
        eg_diff = pa.lo - int(SyscallCode.SYS_EXT_GROUP)
        b.when(is_linux).assert_zero(1 - is_extgroup - eg_diff * col("extgroup_inv"))
        # result register: keep the syscall id, except hint-len (host data),
        # Linux syscalls (result bound via the SysLinux bridge message), and
        # enter-unconstrained (the merged block row returns 0; reference
        # syscall/instructions/air.rs:197-208)
        a = col.word("a")
        is_enteru = col("is_enteru_sc")
        keep = is_real - col("is_hintlen_sc") - is_linux - is_enteru
        b.when(keep).assert_eq(a.lo, pa.lo)
        b.when(keep).assert_eq(a.hi, pa.hi)
        b.when(is_enteru).assert_zero(a.lo)
        b.when(is_enteru).assert_zero(a.hi)
        # halt: exit code (checked against pv by the CPU) must be a clean u32
        bw = col.word("b")
        b.when(col("is_halt_sc") + is_extgroup).assert_zero(bw.hi)
        # commit / commit-deferred: bind the public-values digest word at
        # index b (reference air.rs:245-330 shares one index bitmap)
        idx_flags = [col(f"digest_idx{i}") for i in range(8)]
        isum = 0
        wsum = 0
        for i, f_ in enumerate(idx_flags):
            b.assert_bool(f_)
            isum = isum + f_
            wsum = wsum + f_ * i
        is_commit = col("is_commit_sc")
        is_cd = col("is_commitdef_sc")
        either = is_commit + is_cd
        b.assert_eq(isum, either)
        b.when(either).assert_eq(wsum, bw.lo)
        b.when(either).assert_zero(bw.hi)
        cw = col.word("c")
        for i, f_ in enumerate(idx_flags):
            b.when(f_ * is_commit).assert_eq(b.public_value(PV_DIGEST + 2 * i), cw.lo)
            b.when(f_ * is_commit).assert_eq(b.public_value(PV_DIGEST + 2 * i + 1), cw.hi)
            # deferred digest words are single KoalaBear elements
            b.when(f_ * is_cd).assert_eq(
                b.public_value(PV_DEFERRED_DIGEST + i), cw.lo + cw.hi * 65536
            )
        # range check the deferred digest word to a canonical field element
        # so the reduced PV binding cannot alias c and c - P
        kb_hi_max = col("kb_hi_max")
        kb_lt = col("kb_lt")
        b.assert_bool(kb_hi_max)
        b.when(is_cd * kb_hi_max).assert_eq(cw.hi, 0x7F00)
        b.when(is_cd * kb_hi_max).assert_zero(cw.lo)
        b.assert_eq(kb_lt, is_cd - is_cd * kb_hi_max)
        from .gadgets import send_u16_check

        send_u16_check(b, 0x7EFF - cw.hi, kb_lt)
        # hand precompile syscalls to their chips
        from .lookups import linux_syscall_msg, syscall_msg

        pre_mult = 0
        for n, _code in SYS_FLAGS:
            if n in PRECOMPILE_FLAGS:
                pre_mult = pre_mult + col(n)
        b.send(
            LookupKind.Syscall,
            syscall_msg(col("shard"), col("clk"), pa.lo, pa.hi, bw, cw),
            pre_mult,
        )
        # Linux o32 syscalls go to the SysLinux chip with the result word
        # (the value the CPU wrote to $v0) bound into the message
        b.send(
            LookupKind.Syscall,
            linux_syscall_msg(col("shard"), col("clk"), pa.lo, pa.hi, bw, cw, a),
            is_linux,
        )

    def fill_op(self, t, i, e, op, sink):
        s = self.schema
        sid = int(e.hi_or_prev_a)
        for n, code in SYS_FLAGS:
            if sid == int(code):
                t[i, s.idx(n)] = 1
                if code in (SyscallCode.COMMIT, SyscallCode.COMMIT_DEFERRED_PROOFS):
                    t[i, s.idx(f"digest_idx{int(e.b)}")] = 1
                if code == SyscallCode.COMMIT_DEFERRED_PROOFS:
                    c_hi = int(e.c) >> 16
                    if c_hi == 0x7F00:
                        assert int(e.c) == 0x7F000000, (
                            f"deferred digest word {e.c:#x} is not a canonical "
                            "KoalaBear element"
                        )
                        t[i, s.idx("kb_hi_max")] = 1
                    else:
                        assert c_hi < 0x7F00, (
                            f"deferred digest word {e.c:#x} is not a canonical "
                            "KoalaBear element"
                        )
                        t[i, s.idx("kb_lt")] = 1
                        sink.u16(np.array([0x7EFF - c_hi], dtype=np.uint32))
                break
        else:
            from .sys_linux import LINUX_IDS

            if sid not in LINUX_IDS:
                raise AssertionError(f"unsupported syscall id {sid:#x} in trace")
            t[i, s.idx("is_linux_sc")] = 1
            if sid == int(SyscallCode.SYS_EXT_GROUP):
                t[i, s.idx("is_extgroup_sc")] = 1
            else:
                from ..ops import field as ff

                d = ((sid & 0xFFFF) - int(SyscallCode.SYS_EXT_GROUP)) % ff.P
                t[i, s.idx("extgroup_inv")] = ff.inv_int(d)
