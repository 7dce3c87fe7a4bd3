"""Opcode / register / syscall numbering (reference:
crates/core/executor/src/opcode.rs:15-80, register.rs:6-43,
syscalls/code.rs:27-185)."""

from __future__ import annotations

from enum import IntEnum


class Opcode(IntEnum):
    ADD = 0
    SUB = 1
    MUL = 2
    MULT = 3
    MULTU = 4
    DIV = 5
    DIVU = 6
    MOD = 7
    MODU = 8
    SLL = 9
    SRL = 10
    SRA = 11
    ROR = 12
    SLT = 13
    SLTU = 14
    AND = 15
    OR = 16
    XOR = 17
    NOR = 18
    CLZ = 19
    CLO = 20
    BEQ = 21
    BGEZ = 22
    BGTZ = 23
    BLEZ = 24
    BLTZ = 25
    BNE = 26
    Jump = 27
    Jumpi = 28
    JumpDirect = 29
    SYSCALL = 30
    LB = 31
    LBU = 32
    LH = 33
    LHU = 34
    LW = 35
    LWL = 36
    LWR = 37
    LL = 38
    SB = 39
    SH = 40
    SW = 41
    SWL = 42
    SWR = 43
    SC = 44
    INS = 45
    MADDU = 46
    MSUBU = 47
    MADD = 48
    MSUB = 49
    MEQ = 50
    MNE = 51
    WSBH = 52
    EXT = 53
    TEQ = 54
    SEXT = 55
    UNIMPL = 0xFF


ALU_OPS = {
    Opcode.ADD, Opcode.SUB, Opcode.MULT, Opcode.MULTU, Opcode.MUL, Opcode.DIV,
    Opcode.DIVU, Opcode.SLL, Opcode.SRL, Opcode.SRA, Opcode.ROR, Opcode.SLT,
    Opcode.SLTU, Opcode.AND, Opcode.OR, Opcode.XOR, Opcode.NOR, Opcode.CLZ,
    Opcode.CLO, Opcode.MOD, Opcode.MODU,
}
LOAD_OPS = {Opcode.LB, Opcode.LBU, Opcode.LH, Opcode.LHU, Opcode.LW, Opcode.LWL, Opcode.LWR, Opcode.LL}
STORE_OPS = {Opcode.SB, Opcode.SH, Opcode.SW, Opcode.SWL, Opcode.SWR, Opcode.SC}
BRANCH_OPS = {Opcode.BEQ, Opcode.BNE, Opcode.BGEZ, Opcode.BGTZ, Opcode.BLEZ, Opcode.BLTZ}
JUMP_OPS = {Opcode.Jump, Opcode.Jumpi, Opcode.JumpDirect}
MISC_OPS = {
    Opcode.WSBH, Opcode.SEXT, Opcode.EXT, Opcode.INS, Opcode.MADDU, Opcode.MSUBU,
    Opcode.MEQ, Opcode.MNE, Opcode.TEQ, Opcode.MADD, Opcode.MSUB,
}
MOVCOND_OPS = {Opcode.MEQ, Opcode.MNE}
LO_HI_OPS = {Opcode.DIV, Opcode.DIVU, Opcode.MULT, Opcode.MULTU, Opcode.MADDU, Opcode.MSUBU, Opcode.MADD, Opcode.MSUB}

# MemoryAccessPosition (events/memory.rs:29-40): the clk offset of each access
# within a cycle.  The reference package keeps these beside its Python
# interpreter; the chips need them without it.
POS_MEMORY, POS_C, POS_B, POS_A, POS_HI = 0, 1, 2, 3, 4
ONE_OPERAND_BRANCH = {Opcode.BGEZ, Opcode.BLEZ, Opcode.BGTZ, Opcode.BLTZ}


class Register(IntEnum):
    ZERO = 0
    AT = 1
    V0 = 2
    V1 = 3
    A0 = 4
    A1 = 5
    A2 = 6
    A3 = 7
    T0 = 8
    T1 = 9
    T2 = 10
    T3 = 11
    T4 = 12
    T5 = 13
    T6 = 14
    T7 = 15
    S0 = 16
    S1 = 17
    S2 = 18
    S3 = 19
    S4 = 20
    S5 = 21
    S6 = 22
    S7 = 23
    T8 = 24
    T9 = 25
    K0 = 26
    K1 = 27
    GP = 28
    SP = 29
    FP = 30
    RA = 31
    LO = 32
    HI = 33
    BRK = 34
    HEAP = 35


NUM_REGISTERS = 36


class SyscallCode(IntEnum):
    HALT = 0x00_00_00_00
    WRITE = 0x00_00_00_02
    ENTER_UNCONSTRAINED = 0x00_00_00_03
    EXIT_UNCONSTRAINED = 0x00_00_00_04
    SHA_EXTEND = 0x30_01_00_05
    SHA_COMPRESS = 0x01_01_00_06
    ED_ADD = 0x01_01_00_07
    ED_DECOMPRESS = 0x00_01_00_08
    KECCAK_SPONGE = 0x01_01_00_09
    SECP256K1_ADD = 0x01_01_00_0A
    SECP256K1_DOUBLE = 0x00_01_00_0B
    SECP256K1_DECOMPRESS = 0x00_01_00_0C
    BN254_ADD = 0x01_01_00_0E
    BN254_DOUBLE = 0x00_01_00_0F
    COMMIT = 0x00_00_00_10
    COMMIT_DEFERRED_PROOFS = 0x00_00_00_1A
    VERIFY_ZKM_PROOF = 0x00_00_00_1B
    BLS12381_DECOMPRESS = 0x00_01_00_1C
    UINT256_MUL = 0x01_01_00_1D
    BLS12381_ADD = 0x01_01_00_1E
    BLS12381_DOUBLE = 0x00_01_00_1F
    BLS12381_FP_ADD = 0x01_01_00_20
    BLS12381_FP_SUB = 0x01_01_00_21
    BLS12381_FP_MUL = 0x01_01_00_22
    BLS12381_FP2_ADD = 0x01_01_00_23
    BLS12381_FP2_SUB = 0x01_01_00_24
    BLS12381_FP2_MUL = 0x01_01_00_25
    BN254_FP_ADD = 0x01_01_00_26
    BN254_FP_SUB = 0x01_01_00_27
    BN254_FP_MUL = 0x01_01_00_28
    BN254_FP2_ADD = 0x01_01_00_29
    BN254_FP2_SUB = 0x01_01_00_2A
    BN254_FP2_MUL = 0x01_01_00_2B
    SECP256R1_ADD = 0x01_01_00_2C
    SECP256R1_DOUBLE = 0x00_01_00_2D
    SECP256R1_DECOMPRESS = 0x00_01_00_2E
    U256XU2048_MUL = 0x01_01_00_2F
    POSEIDON2_PERMUTE = 0x00_01_00_30
    # Linux o32-ABI syscalls emulated for Go guests (reference
    # syscalls/code.rs:144-183 + precompiles/sys_linux/)
    SYS_LINUX = 4000
    SYS_READ = 4003
    SYS_WRITE = 4004
    SYS_OPEN = 4005
    SYS_CLOSE = 4006
    SYS_BRK = 4045
    SYS_FCNTL = 4055
    SYS_MMAP2 = 4090
    SYS_MUNMAP = 4091
    SYS_CLONE = 4120
    SYS_RT_SIGACTION = 4194
    SYS_RT_SIGPROCMASK = 4195
    SYS_SIGALTSTACK = 4206
    SYS_MMAP = 4210
    SYS_FSTAT64 = 4215
    SYS_MADVISE = 4218
    SYS_GETTID = 4222
    SYS_SCHED_GETAFFINITY = 4240
    SYS_EXT_GROUP = 4246
    SYS_CLOCK_GETTIME = 4263
    SYS_OPENAT = 4288
    SYS_PRLIMIT64 = 4338
    SYSHINTLEN = 0x00_00_00_F0
    SYSHINTREAD = 0x00_00_00_F1
    SYSVERIFY = 0x00_00_00_F2

    @property
    def syscall_id(self) -> int:
        return self.value & 0xFFFF

    @property
    def should_send(self) -> int:
        """Whether the syscall emits a precompile event (bits 16-23)."""
        return (self.value >> 16) & 0xFF

    @property
    def num_extra_cycles(self) -> int:
        """Extra clk cycles consumed (bits 24-31)."""
        return (self.value >> 24) & 0xFF
