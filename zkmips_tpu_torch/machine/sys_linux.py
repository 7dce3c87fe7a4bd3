"""SysLinux chip: constrains the emulated Linux o32 syscalls for Go guests.

Analog of crates/core/machine/src/syscall/precompiles/sys_linux/ (air.rs:1-323,
columns.rs:13-62): one row per sys_linux event.  Each row receives the
SyscallInstrs chip's linux bridge message (which carries the $v0 result the
CPU wrote), performs the $a3 error-flag register write, and for brk/mmap/write
an extra register access (BRK read / HEAP read-modify-write / A2 read), then
pins the result per syscall:

  brk    v0 = max(a0, BRK)          (unsigned 16-bit-limb compare)
  mmap   a0 == 0: v0 = HEAP, HEAP += round_up(a1, 0x1000); else v0 = a0
  clone  v0 = 1
  read   a0 == 0 (stdin): v0 = 0; else v0 = -1, a3 = EBADF
  write  v0 = A2 (byte count)
  fcntl  F_GETFD/F_GETFL on fds 0-2 per the o32 ABI; else v0 = -1, a3 = EBADF
  exit_group / nops: v0 = 0

Flag classification (a0 in {0,1,2}, a1 in {1,3}, page_offset == 0) is
biconditional via inverse witnesses, unlike the reference's one-directional
flags, so a prover cannot misreport an EBADF path.
"""

from __future__ import annotations

import numpy as np

from ..utils.pool import zeros_mt

from ..executor.opcodes import Register, SyscallCode
from ..ops import field as ff
from ..stark.air import AirBuilder, LookupKind
from ..stark.chip import BaseAir
from .gadgets import ByteSink, ColView, Schema, eval_memory_access, populate_access, send_u16_check
from .lookups import linux_syscall_msg

C = SyscallCode
MAIN_FLAGS = [
    ("is_brk", C.SYS_BRK),
    ("is_mmap", C.SYS_MMAP),
    ("is_mmap2", C.SYS_MMAP2),
    ("is_clone", C.SYS_CLONE),
    ("is_read", C.SYS_READ),
    ("is_write", C.SYS_WRITE),
    ("is_fcntl", C.SYS_FCNTL),
    ("is_extgroup", C.SYS_EXT_GROUP),
]
NOP_CODES = [
    C.SYS_OPEN, C.SYS_CLOSE, C.SYS_MUNMAP, C.SYS_RT_SIGACTION,
    C.SYS_RT_SIGPROCMASK, C.SYS_SIGALTSTACK, C.SYS_FSTAT64, C.SYS_MADVISE,
    C.SYS_GETTID, C.SYS_SCHED_GETAFFINITY, C.SYS_CLOCK_GETTIME, C.SYS_OPENAT,
    C.SYS_PRLIMIT64,
]
LINUX_IDS = {int(c) for _n, c in MAIN_FLAGS} | {int(c) for c in NOP_CODES}
EBADF = 9


class SysLinuxAir(BaseAir):
    name = "SysLinux"

    def included(self, record) -> bool:
        return bool(record.precompile_events.get("sys_linux"))

    def __init__(self):
        names = ["shard", "clk", "id", "is_real"]
        for w in ("a0", "a1", "res", "out", "io"):
            names += [f"{w}_lo", f"{w}_hi"]
        names += [n for n, _ in MAIN_FLAGS] + ["is_nop"]
        names += [f"nop{k}" for k in range(len(NOP_CODES))]
        # biconditional equality witnesses: a0.hi==0, a0.lo in {0,1,2}
        for g in ("a0hi", "a0l0", "a0l1", "a0l2", "a1hi", "a1l1", "a1l3"):
            names += [f"{g}_z", f"{g}_zi"]
        names += ["ia00", "ia01", "ia02", "ia11", "ia13", "if11", "if13"]
        # brk: unsigned compare a0 vs previous BRK (one-hot per limb)
        names += [f"bk_{f}_{l}" for l in ("hi", "lo") for f in ("lt", "eq", "gt")]
        names += ["bk_d_hi", "bk_d_lo", "bk_gt"]
        # mmap: a1 page decomposition + HEAP bump carry
        names += ["page_off", "u4", "po_z", "po_zi", "c0", "c1", "immap_a00"]
        names += ["is_ebadf"]
        s = Schema(names)
        s.names.extend(s.access_cols("oacc"))
        s.names.extend(s.access_cols("iacc"))
        self.schema = Schema(s.names)
        self.main_width = self.schema.width

    # ------------------------------------------------------------------ AIR

    def _bicond(self, b, col, gate, name, d):
        """z <=> (d == 0), under ``gate``; z*d == 0 holds unconditionally."""
        z, zi = col(f"{name}_z"), col(f"{name}_zi")
        b.assert_bool(z)
        b.assert_zero(z * d)
        b.when(gate).assert_zero(z + d * zi - 1)
        return z

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        ir = col("is_real")
        b.assert_bool(ir)
        shard, clk, sid = col("shard"), col("clk"), col("id")
        a0 = col.word("a0")
        a1 = col.word("a1")
        res = col.word("res")
        out = col.word("out")
        io = col.word("io")

        flags = {n: col(n) for n, _ in MAIN_FLAGS}
        is_nop = col("is_nop")
        total = is_nop
        for n, code in MAIN_FLAGS:
            f_ = flags[n]
            b.assert_bool(f_)
            b.when(f_).assert_eq(sid, int(code))
            total = total + f_
        b.assert_bool(is_nop)
        # unconditional (reference InstrAir form): padding rows must zero all
        # flags, else a fake row with ir=0, is_mmap=1 could perform a live
        # HEAP read-modify-write through io_mult with no incoming message
        b.assert_eq(total, ir)
        nsum = 0
        for k, code in enumerate(NOP_CODES):
            nk = col(f"nop{k}")
            b.assert_bool(nk)
            b.when(nk).assert_eq(sid, int(code))
            nsum = nsum + nk
        b.assert_eq(nsum, is_nop)

        b.receive(
            LookupKind.Syscall,
            linux_syscall_msg(shard, clk, sid, 0, a0, a1, res),
            ir,
        )
        send_u16_check(b, res.lo, ir)
        send_u16_check(b, res.hi, ir)

        mm = flags["is_mmap"] + flags["is_mmap2"]
        # a0/a1 classification (gated to the syscalls that branch on them)
        g0 = flags["is_read"] + flags["is_fcntl"] + mm
        a0hi_z = self._bicond(b, col, g0, "a0hi", a0.hi)
        a0l0_z = self._bicond(b, col, g0, "a0l0", a0.lo)
        a0l1_z = self._bicond(b, col, g0, "a0l1", a0.lo - 1)
        a0l2_z = self._bicond(b, col, g0, "a0l2", a0.lo - 2)
        gf = flags["is_fcntl"]
        a1hi_z = self._bicond(b, col, gf, "a1hi", a1.hi)
        a1l1_z = self._bicond(b, col, gf, "a1l1", a1.lo - 1)
        a1l3_z = self._bicond(b, col, gf, "a1l3", a1.lo - 3)
        ia00, ia01, ia02 = col("ia00"), col("ia01"), col("ia02")
        b.assert_eq(ia00, a0hi_z * a0l0_z)
        b.assert_eq(ia01, a0hi_z * a0l1_z)
        b.assert_eq(ia02, a0hi_z * a0l2_z)
        ia11, ia13 = col("ia11"), col("ia13")
        b.assert_eq(ia11, a1hi_z * a1l1_z)
        b.assert_eq(ia13, a1hi_z * a1l3_z)
        if11, if13 = col("if11"), col("if13")
        b.assert_eq(if11, gf * ia11)
        b.assert_eq(if13, gf * ia13)

        # --- the two register accesses ---------------------------------
        immap_a00 = col("immap_a00")
        b.assert_eq(immap_a00, mm * ia00)
        io_mult = flags["is_brk"] + immap_a00 + flags["is_write"]
        io_addr = (
            flags["is_brk"] * int(Register.BRK)
            + immap_a00 * int(Register.HEAP)
            + flags["is_write"] * int(Register.A2)
        )
        eval_memory_access(b, col, "iacc", shard, clk, io_addr, io, io_mult)
        prev = col.word("iacc_prev")
        # read semantics for brk/write: value unchanged
        rd = flags["is_brk"] + flags["is_write"]
        b.when(rd).assert_eq(io.lo, prev.lo)
        b.when(rd).assert_eq(io.hi, prev.hi)

        # $a3 error flag write on every row
        eval_memory_access(b, col, "oacc", shard, clk, int(Register.A3), out, ir)
        is_ebadf = col("is_ebadf")
        b.assert_bool(is_ebadf)
        b.when(ir).assert_eq(out.lo, is_ebadf * EBADF)
        b.when(ir).assert_zero(out.hi)
        ok_zero = (
            flags["is_brk"] + flags["is_clone"] + flags["is_write"]
            + flags["is_extgroup"] + is_nop + mm
        )
        b.when(ok_zero).assert_zero(is_ebadf)
        b.when(flags["is_read"]).assert_eq(is_ebadf, 1 - ia00)
        b.when(gf).assert_eq(is_ebadf, 1 - (ia11 + ia13) * (ia00 + ia01 + ia02))

        # --- brk: v0 = max(a0, BRK) -------------------------------------
        is_brk = flags["is_brk"]
        for limb in ("hi", "lo"):
            lt, eq, gt = col(f"bk_lt_{limb}"), col(f"bk_eq_{limb}"), col(f"bk_gt_{limb}")
            d = col(f"bk_d_{limb}")
            for f_ in (lt, eq, gt):
                b.assert_bool(f_)
            b.when(is_brk).assert_eq(lt + eq + gt, 1)
            av = a0.hi if limb == "hi" else a0.lo
            pv = prev.hi if limb == "hi" else prev.lo
            b.when(eq).assert_eq(av, pv)
            b.when(lt).assert_eq(d, pv - av - 1)
            b.when(gt).assert_eq(d, av - pv - 1)
            send_u16_check(b, d, is_brk)
        bk_gt = col("bk_gt")
        b.assert_eq(bk_gt, col("bk_gt_hi") + col("bk_eq_hi") * col("bk_gt_lo"))
        b.when(is_brk).when(bk_gt).assert_eq(res.lo, a0.lo)
        b.when(is_brk).when(bk_gt).assert_eq(res.hi, a0.hi)
        b.when(is_brk).when_not(bk_gt).assert_eq(res.lo, prev.lo)
        b.when(is_brk).when_not(bk_gt).assert_eq(res.hi, prev.hi)

        # --- mmap: HEAP += round_up(a1, 0x1000) when a0 == 0 -------------
        page_off, u4 = col("page_off"), col("u4")
        b.when(mm).assert_eq(a1.lo, page_off + u4 * 4096)
        send_u16_check(b, page_off * 16, mm)  # page_off < 2^12
        send_u16_check(b, u4 * 4096, mm)  # u4 < 2^4
        po_z = self._bicond(b, col, mm, "po", page_off)
        c0, c1 = col("c0"), col("c1")
        b.assert_bool(c0)
        b.assert_bool(c1)
        pages_lo = (u4 + 1 - po_z) * 4096  # round-up page count, low part
        b.when(immap_a00).assert_eq(io.lo + c0 * 65536, prev.lo + pages_lo)
        b.when(immap_a00).assert_eq(io.hi + c1 * 65536, prev.hi + a1.hi + c0)
        send_u16_check(b, io.lo, immap_a00)
        send_u16_check(b, io.hi, immap_a00)
        b.when(immap_a00).assert_eq(res.lo, prev.lo)
        b.when(immap_a00).assert_eq(res.hi, prev.hi)
        b.when(mm).when_not(ia00).assert_eq(res.lo, a0.lo)
        b.when(mm).when_not(ia00).assert_eq(res.hi, a0.hi)

        # --- clone / read / write / fcntl / exit_group / nop -------------
        is_clone = flags["is_clone"]
        b.when(is_clone).assert_eq(res.lo, 1)
        b.when(is_clone).assert_zero(res.hi)
        is_read = flags["is_read"]
        b.when(is_read).when(ia00).assert_zero(res.lo)
        b.when(is_read).when(ia00).assert_zero(res.hi)
        b.when(is_read).when_not(ia00).assert_eq(res.lo, 0xFFFF)
        b.when(is_read).when_not(ia00).assert_eq(res.hi, 0xFFFF)
        is_write = flags["is_write"]
        b.when(is_write).assert_eq(res.lo, io.lo)
        b.when(is_write).assert_eq(res.hi, io.hi)
        ia0_any = ia00 + ia01 + ia02
        b.when(if13).when(ia00).assert_zero(res.lo)
        b.when(if13).when(ia00).assert_zero(res.hi)
        b.when(if13).when(ia01 + ia02).assert_eq(res.lo, 1)
        b.when(if13).when(ia01 + ia02).assert_zero(res.hi)
        b.when(if13).when_not(ia0_any).assert_eq(res.lo, 0xFFFF)
        b.when(if13).when_not(ia0_any).assert_eq(res.hi, 0xFFFF)
        b.when(if11).when(ia0_any).assert_eq(res.lo, a0.lo)
        b.when(if11).when(ia0_any).assert_eq(res.hi, a0.hi)
        b.when(if11).when_not(ia0_any).assert_eq(res.lo, 0xFFFF)
        b.when(if11).when_not(ia0_any).assert_eq(res.hi, 0xFFFF)
        b.when(gf * (1 - ia11 - ia13)).assert_eq(res.lo, 0xFFFF)
        b.when(gf * (1 - ia11 - ia13)).assert_eq(res.hi, 0xFFFF)
        done = flags["is_extgroup"] + is_nop
        b.when(done).assert_zero(res.lo)
        b.when(done).assert_zero(res.hi)

    # ------------------------------------------------------------- trace

    def generate_trace(self, record, output):
        events = record.precompile_events.get("sys_linux", [])
        s = self.schema
        t = zeros_mt((len(events), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        code_to_flag = {int(c): n for n, c in MAIN_FLAGS}
        nop_idx = {int(c): k for k, c in enumerate(NOP_CODES)}

        def setw(i, prefix, v):
            t[i, s.idx(f"{prefix}_lo")] = v & 0xFFFF
            t[i, s.idx(f"{prefix}_hi")] = (v >> 16) & 0xFFFF

        def bicond(i, name, d):
            d %= ff.P
            if d == 0:
                t[i, s.idx(f"{name}_z")] = 1
            else:
                t[i, s.idx(f"{name}_zi")] = ff.inv_int(d)
            return d == 0

        for i, ev in enumerate(events):
            code, a0, a1, v0, a3 = ev["code"], ev["a0"], ev["a1"], ev["v0"], ev["a3"]
            t[i, s.idx("shard")] = ev["shard"]
            t[i, s.idx("clk")] = ev["clk"]
            t[i, s.idx("id")] = code
            t[i, s.idx("is_real")] = 1
            setw(i, "a0", a0)
            setw(i, "a1", a1)
            setw(i, "res", v0)
            setw(i, "out", a3)
            sink.u16(np.array([v0 & 0xFFFF], dtype=np.uint32))
            sink.u16(np.array([(v0 >> 16) & 0xFFFF], dtype=np.uint32))
            fname = code_to_flag.get(code)
            if fname is not None:
                t[i, s.idx(fname)] = 1
            else:
                t[i, s.idx("is_nop")] = 1
                t[i, s.idx(f"nop{nop_idx[code]}")] = 1
            is_mm = code in (int(C.SYS_MMAP), int(C.SYS_MMAP2))
            z_a0hi = bicond(i, "a0hi", a0 >> 16)
            z_a0l0 = bicond(i, "a0l0", a0 & 0xFFFF)
            z_a0l1 = bicond(i, "a0l1", (a0 & 0xFFFF) - 1)
            z_a0l2 = bicond(i, "a0l2", (a0 & 0xFFFF) - 2)
            z_a1hi = bicond(i, "a1hi", a1 >> 16)
            z_a1l1 = bicond(i, "a1l1", (a1 & 0xFFFF) - 1)
            z_a1l3 = bicond(i, "a1l3", (a1 & 0xFFFF) - 3)
            ia00 = z_a0hi and z_a0l0
            ia11 = z_a1hi and z_a1l1
            ia13 = z_a1hi and z_a1l3
            t[i, s.idx("ia00")] = ia00
            t[i, s.idx("ia01")] = z_a0hi and z_a0l1
            t[i, s.idx("ia02")] = z_a0hi and z_a0l2
            t[i, s.idx("ia11")] = ia11
            t[i, s.idx("ia13")] = ia13
            is_f = code == int(C.SYS_FCNTL)
            t[i, s.idx("if11")] = is_f and ia11
            t[i, s.idx("if13")] = is_f and ia13
            t[i, s.idx("is_ebadf")] = a3 == EBADF

            io = ev["io"]
            if io is not None:
                setw(i, "io", io.value)
                populate_access(
                    t, s, np.array([i]), "iacc",
                    np.array([io.prev_shard]), np.array([io.prev_timestamp]),
                    np.array([io.prev_value if hasattr(io, "prev_value") else io.value]),
                    np.array([ev["shard"]]), np.array([io.timestamp]), sink,
                )
            prev_val = 0
            if io is not None:
                prev_val = io.prev_value if hasattr(io, "prev_value") else io.value
            if code == int(C.SYS_BRK):
                for limb, av, pv in (
                    ("hi", a0 >> 16, prev_val >> 16),
                    ("lo", a0 & 0xFFFF, prev_val & 0xFFFF),
                ):
                    if av < pv:
                        t[i, s.idx(f"bk_lt_{limb}")] = 1
                        d = pv - av - 1
                    elif av == pv:
                        t[i, s.idx(f"bk_eq_{limb}")] = 1
                        d = 0
                    else:
                        t[i, s.idx(f"bk_gt_{limb}")] = 1
                        d = av - pv - 1
                    t[i, s.idx(f"bk_d_{limb}")] = d
                    sink.u16(np.array([d], dtype=np.uint32))
                t[i, s.idx("bk_gt")] = a0 > prev_val
            if is_mm:
                po = a1 & 0xFFF
                u4 = (a1 & 0xFFFF) >> 12
                t[i, s.idx("page_off")] = po
                t[i, s.idx("u4")] = u4
                sink.u16(np.array([po * 16], dtype=np.uint32))
                sink.u16(np.array([u4 * 4096], dtype=np.uint32))
                bicond(i, "po", po)
                if ia00:
                    t[i, s.idx("immap_a00")] = 1
                    pages_lo = (u4 + (1 if po else 0)) * 4096
                    lo_sum = (prev_val & 0xFFFF) + pages_lo
                    c0 = lo_sum >> 16
                    t[i, s.idx("c0")] = c0
                    hi_sum = (prev_val >> 16) + (a1 >> 16) + c0
                    t[i, s.idx("c1")] = hi_sum >> 16
                    sink.u16(np.array([io.value & 0xFFFF], dtype=np.uint32))
                    sink.u16(np.array([(io.value >> 16) & 0xFFFF], dtype=np.uint32))
            out_rec = ev["out"]
            populate_access(
                t, s, np.array([i]), "oacc",
                np.array([out_rec.prev_shard]), np.array([out_rec.prev_timestamp]),
                np.array([out_rec.prev_value]),
                np.array([ev["shard"]]), np.array([out_rec.timestamp]), sink,
            )
        return t
