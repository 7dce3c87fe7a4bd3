"""KeccakSponge precompile chip: one row per keccak-f round (24 rows/block).

Analog of crates/core/machine/src/syscall/precompiles/keccak_sponge (the
reference delegates the permutation to p3-keccak-air and wraps it with the
sponge absorb/squeeze); here the whole sponge is one chip, re-derived for
16-bit limb words:

* theta: C and C' committed as bits; C' = C[x] ^ C[x-1] ^ rot1(C[x+1])
  (degree 3), input-state limbs bound by A = A' ^ C ^ C' per bit (degree 3),
  and xor5_y A'[x][y][z] == C'[x][z] (degree 5) forces C to be the actual
  column parity.
* rho/pi are free bit relabelings of the committed A' bits; chi output
  limbs are sums of B ^ (~B1 & B2) bits (degree 3); iota adds the per-round
  constant through a bit decomposition of lane 0.
* absorb rows (round-0 of each block) xor the 18 input lanes into the
  carried state byte-by-byte against the byte XOR table; the carried state
  is the previous row's iota output (transition constraint).
* 36 input-word reads per block (at the event clk), the input-length read
  at result_ptr+64, and 16 output-word writes (clk+1) use the shared memory
  access gadget; the syscall is received on the event's first row.

Executor events: ``record.precompile_events["keccak_sponge"]``
(executor/syscalls.py::_keccak_sponge).
"""

from __future__ import annotations

import numpy as np

from ..utils.pool import zeros_mt

from ..executor.opcodes import SyscallCode
from ..ops import field as ff
from ..stark.air import AirBuilder, LookupKind
from ..stark.chip import BaseAir
from .gadgets import ByteSink, ColView, Schema, eval_memory_access, populate_access, send_u16_check
from .lookups import ByteOpcode, byte_msg, syscall_msg

CODE = SyscallCode.KECCAK_SPONGE
ID_LO = int(CODE) & 0xFFFF
ID_HI = int(CODE) >> 16

NUM_ROUNDS = 24
BLOCK_U64 = 18
BLOCK_U32 = 36

RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
ROT = [
    [0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56], [27, 20, 39, 8, 14],
]


def _xor2(a, b):
    return a + b - 2 * a * b


def _xor3(a, b, c):
    return _xor2(_xor2(a, b), c)


class KeccakSpongeAir(BaseAir):
    name = "KeccakSponge"

    def __init__(self):
        names = [
            "is_real", "first", "fin", "shard", "clk",
            "iptr_lo", "iptr_hi", "rptr_lo", "rptr_hi",
            "nb", "zi", "cy",
        ]
        names += [f"s{r}" for r in range(NUM_ROUNDS)]
        names += [f"a{n}_{l}" for n in range(25) for l in range(4)]       # state in
        names += [f"c{x}_{z}" for x in range(5) for z in range(64)]       # theta C
        names += [f"cp{x}_{z}" for x in range(5) for z in range(64)]      # theta C'
        names += [f"ap{n}_{z}" for n in range(25) for z in range(64)]     # post-theta bits
        names += [f"app{n}_{l}" for n in range(25) for l in range(4)]     # post-chi limbs
        names += [f"o{z}" for z in range(64)]                             # lane-0 post-chi bits
        names += [f"po{n}_{l}" for n in range(25) for l in range(4)]      # carried state (absorb)
        names += [f"pb{n}_{j}" for n in range(BLOCK_U64) for j in range(8)]
        names += [f"ib{n}_{j}" for n in range(BLOCK_U64) for j in range(8)]
        names += [f"ob{n}_{j}" for n in range(BLOCK_U64) for j in range(8)]
        s = Schema(names)
        for i in range(BLOCK_U32):
            s.names.extend(s.access_cols(f"mi{i}"))
        for i in range(16):
            s.names.extend(s.access_cols(f"mo{i}"))
            s.names.extend([f"w{i}_lo", f"w{i}_hi"])
        s.names.extend(s.access_cols("ml"))
        self.schema = Schema(s.names)
        self.main_width = self.schema.width
        # contiguous block bases for vectorized trace fill
        self._base = {k: self.schema.idx(k) for k in ("a0_0", "c0_0", "cp0_0", "ap0_0",
                                                      "app0_0", "o0", "po0_0", "pb0_0",
                                                      "ib0_0", "ob0_0", "s0")}

    def included(self, record):
        return bool(record.precompile_events.get("keccak_sponge"))

    # ------------------------------------------------------------------ AIR

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        is_real = col("is_real")
        first, fin = col("first"), col("fin")
        shard, clk = col("shard"), col("clk")
        s = [col(f"s{r}") for r in range(NUM_ROUNDS)]
        for f_ in (is_real, first, fin, col("cy"), *s):
            b.assert_bool(f_)
        total = s[0]
        for r in range(1, NUM_ROUNDS):
            total = total + s[r]
        b.assert_eq(total, is_real)

        a = [[col(f"a{n}_{l}") for l in range(4)] for n in range(25)]
        c = [[col(f"c{x}_{z}") for z in range(64)] for x in range(5)]
        cp = [[col(f"cp{x}_{z}") for z in range(64)] for x in range(5)]
        ap = [[col(f"ap{n}_{z}") for z in range(64)] for n in range(25)]
        app = [[col(f"app{n}_{l}") for l in range(4)] for n in range(25)]
        o = [col(f"o{z}") for z in range(64)]
        for x in range(5):
            for z in range(64):
                b.assert_bool(c[x][z])
                b.assert_bool(cp[x][z])
        for n in range(25):
            for z in range(64):
                b.assert_bool(ap[n][z])
        for z in range(64):
            b.assert_bool(o[z])

        # theta C': cp[x] = c[x] ^ c[x-1] ^ rot1(c[x+1])
        for x in range(5):
            for z in range(64):
                b.assert_eq(cp[x][z],
                            _xor3(c[x][z], c[(x + 4) % 5][z], c[(x + 1) % 5][(z + 63) % 64]))
        # input limbs: a == bits of (ap ^ c ^ cp)
        for x in range(5):
            for y in range(5):
                n = x + 5 * y
                for l in range(4):
                    acc = 0
                    for zz in range(16):
                        z = 16 * l + zz
                        acc = acc + _xor3(ap[n][z], c[x][z], cp[x][z]) * (1 << zz)
                    b.assert_eq(a[n][l], acc)
        # column parity: xor5_y ap[x][y][z] == cp[x][z]  (degree 5)
        for x in range(5):
            for z in range(64):
                acc = ap[x][z]
                for y in range(1, 5):
                    acc = _xor2(acc, ap[x + 5 * y][z])
                b.assert_eq(acc, cp[x][z])

        # rho/pi relabeling: B[y][(2x+3y)%5][z] = ap[x+5y][(z - ROT[x][y]) % 64]
        bbit = [[None] * 64 for _ in range(25)]
        for x in range(5):
            for y in range(5):
                src = x + 5 * y
                dst = y + 5 * ((2 * x + 3 * y) % 5)
                r = ROT[x][y]
                for z in range(64):
                    bbit[dst][z] = ap[src][(z - r) % 64]
        # chi: app limbs = bits of B ^ (~B1 & B2)
        chi = [[None] * 64 for _ in range(25)]
        for x in range(5):
            for y in range(5):
                n = x + 5 * y
                n1 = (x + 1) % 5 + 5 * y
                n2 = (x + 2) % 5 + 5 * y
                for z in range(64):
                    t = (1 - bbit[n1][z]) * bbit[n2][z]
                    chi[n][z] = _xor2(bbit[n][z], t)
        for n in range(25):
            for l in range(4):
                acc = 0
                for zz in range(16):
                    acc = acc + chi[n][16 * l + zz] * (1 << zz)
                b.assert_eq(app[n][l], acc)
        # lane-0 bit decomposition (for iota)
        for l in range(4):
            acc = 0
            for zz in range(16):
                acc = acc + o[16 * l + zz] * (1 << zz)
            b.assert_eq(app[0][l], acc)
        # iota output limbs of lane 0 (expressions; rc selected by round flag)
        out0 = []
        for l in range(4):
            acc = 0
            for zz in range(16):
                z = 16 * l + zz
                rc_bit = 0
                for r in range(NUM_ROUNDS):
                    if (RC[r] >> z) & 1:
                        rc_bit = rc_bit + s[r]
                acc = acc + _xor2(o[z], rc_bit) * (1 << zz)
            out0.append(acc)

        def out_limb(n, l):
            return out0[l] if n == 0 else app[n][l]

        # ---------------- control / chaining
        not_last = is_real - s[23]
        b.when_first_row().when(is_real).assert_eq(s[0], 1)
        b.when_first_row().when(is_real).assert_eq(first, 1)
        # within a block: flags/ids constant, round flag advances
        for name in ("first", "fin", "shard", "clk", "iptr_lo", "iptr_hi",
                     "rptr_lo", "rptr_hi", "nb"):
            b.when_transition().when(not_last).assert_eq(col(name, 1), col(name))
        for r in range(NUM_ROUNDS - 1):
            b.when_transition().when(not_last).assert_eq(col(f"s{r + 1}", 1), s[r])
        # round 23, more blocks: next is round 0 of the same event
        cont = s[23] * (1 - fin)
        nxt = lambda name: col(name, 1)  # noqa: E731
        t = b.when_transition()
        t.when(cont).assert_eq(nxt("s0"), 1)
        t.when(cont).assert_eq(nxt("first"), 0)
        t.when(cont).assert_eq(nxt("is_real"), 1)
        for name in ("shard", "clk", "rptr_lo", "rptr_hi"):
            t.when(cont).assert_eq(nxt(name), col(name))
        # input pointer advances by one block (144 bytes) with a carry
        cy = col("cy")
        t.when(cont).assert_eq(nxt("iptr_lo"), col("iptr_lo") + 144 - cy * 65536)
        t.when(cont).assert_eq(nxt("iptr_hi"), col("iptr_hi") + cy)
        # range check the advanced pointer on the next block's own absorb row
        send_u16_check(b, col("iptr_lo"), s[0] * (1 - first))
        # block countdown: fin <=> nb == 1
        t.when(cont).assert_eq(nxt("nb"), col("nb") - 1)
        b.when(s[23]).when(fin).assert_eq(col("nb"), 1)
        b.when(cont).assert_eq((col("nb") - 1) * col("zi"), 1)
        send_u16_check(b, col("nb"), is_real)
        # carried state on the next absorb row == this round's iota output
        for n in range(25):
            for l in range(4):
                t.when(cont).assert_eq(nxt(f"po{n}_{l}"), out_limb(n, l))
        # event end: next real row starts a new event
        endc = s[23] * fin
        t.when(endc * nxt("is_real")).assert_eq(nxt("s0"), 1)
        t.when(endc * nxt("is_real")).assert_eq(nxt("first"), 1)
        # padding is terminal
        t.when(1 - is_real).assert_eq(nxt("is_real"), 0)
        # state chain within a block: next round's input == iota output
        for n in range(25):
            for l in range(4):
                t.when(not_last).assert_eq(nxt(f"a{n}_{l}"), out_limb(n, l))

        # ---------------- absorb rows (round 0)
        s0 = s[0]
        iptr = col.word("iptr")
        rptr = col.word("rptr")
        po = [[col(f"po{n}_{l}") for l in range(4)] for n in range(25)]
        # first block: carried state is zero
        for n in range(25):
            for l in range(4):
                b.when(s0 * first).assert_zero(po[n][l])
        # lanes 0..17: byte xor against the input words
        for n in range(BLOCK_U64):
            pb = [col(f"pb{n}_{j}") for j in range(8)]
            ib = [col(f"ib{n}_{j}") for j in range(8)]
            ob = [col(f"ob{n}_{j}") for j in range(8)]
            for l in range(4):
                b.when(s0).assert_eq(po[n][l], pb[2 * l] + pb[2 * l + 1] * 256)
                b.when(s0).assert_eq(a[n][l], ob[2 * l] + ob[2 * l + 1] * 256)
            # the two input words of this lane (words 2n, 2n+1 of the block)
            for half in range(2):
                w = col.word(f"mi{2 * n + half}_prev")
                b.when(s0).assert_eq(w.lo, ib[4 * half] + ib[4 * half + 1] * 256)
                b.when(s0).assert_eq(w.hi, ib[4 * half + 2] + ib[4 * half + 3] * 256)
            for j in range(8):
                b.send(LookupKind.Byte,
                       byte_msg(int(ByteOpcode.XOR), ob[j], pb[j], ib[j]), s0)
        # lanes 18..24 pass through
        for n in range(BLOCK_U64, 25):
            for l in range(4):
                b.when(s0).assert_eq(a[n][l], po[n][l])
        # input word reads (reads: sent value == previous value)
        for i in range(BLOCK_U32):
            prev = col.word(f"mi{i}_prev")
            eval_memory_access(b, col, f"mi{i}", shard, clk,
                               iptr.value_expr() + 4 * i, prev, s0)

        # ---------------- event first row: syscall + length read
        recv = s0 * first
        b.receive(LookupKind.Syscall, syscall_msg(shard, clk, ID_LO, ID_HI, iptr, rptr), recv)
        lw = col.word("ml_prev")
        eval_memory_access(b, col, "ml", shard, clk, rptr.value_expr() + 64, lw, recv)
        # input length = 36 * total blocks
        b.when(recv).assert_eq(lw.lo + lw.hi * 65536, col("nb") * BLOCK_U32)

        # ---------------- output writes (round 23 of the final block, clk+1)
        wflag = s[23] * fin
        for i in range(16):
            w = col.word(f"w{i}")
            n, half = i // 2, i % 2
            b.when(wflag).assert_eq(w.lo, out_limb(n, 2 * half))
            b.when(wflag).assert_eq(w.hi, out_limb(n, 2 * half + 1))
            eval_memory_access(b, col, f"mo{i}", shard, clk + 1,
                               rptr.value_expr() + 4 * i, w, wflag)

    # ---------------------------------------------------------------- trace

    def generate_trace(self, record, output):
        """Vectorized across blocks: every Keccak round computes all blocks'
        states at once; per-round column writes land via fancy row indexing.
        The block list and absorb witnesses keep small Python loops (O(B)),
        the O(B * 24 * width) work is numpy."""
        events = record.precompile_events.get("keccak_sponge", [])
        s = self.schema
        num_rows = sum(NUM_ROUNDS * (len(ev["xored_states"])) for ev in events)
        t = zeros_mt((max(num_rows, 0), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        if not events:
            return t
        z64 = np.arange(64, dtype=np.uint64)
        j16 = 16 * np.arange(4, dtype=np.uint64)
        j8 = 8 * np.arange(8, dtype=np.uint64)

        # flat block list
        blk_state, blk_meta = [], []
        row = 0
        for ei, ev in enumerate(events):
            blocks = ev["xored_states"]
            nb_total = len(blocks)
            for bi, state_in in enumerate(blocks):
                iptr = (ev["input_ptr"] + 144 * bi) & 0xFFFFFFFF
                blk_state.append(state_in)
                blk_meta.append((ei, bi, nb_total, iptr, row + NUM_ROUNDS * bi))
            row += NUM_ROUNDS * nb_total
        B = len(blk_state)
        av0 = np.array(blk_state, dtype=np.uint64)  # (B, 25)
        base_rows = np.array([m[4] for m in blk_meta], dtype=np.int64)
        ei_arr = np.array([m[0] for m in blk_meta], dtype=np.int64)
        bi_arr = np.array([m[1] for m in blk_meta], dtype=np.int64)
        nbt_arr = np.array([m[2] for m in blk_meta], dtype=np.int64)
        iptr_arr = np.array([m[3] for m in blk_meta], dtype=np.uint64)
        nb_arr = (nbt_arr - bi_arr).astype(np.uint64)
        shard_arr = np.array([events[e]["shard"] for e in ei_arr], dtype=np.uint32)
        clk_arr = np.array([events[e]["clk"] for e in ei_arr], dtype=np.uint32)
        rptr_arr = np.array([events[e]["result_ptr"] for e in ei_arr], dtype=np.uint64)

        # per-block constant columns, repeated over the 24 rows
        all_rows = (base_rows[:, None] + np.arange(NUM_ROUNDS)).reshape(-1)
        rep = lambda a: np.repeat(a, NUM_ROUNDS)
        t[all_rows, s.idx("is_real")] = 1
        t[all_rows, s.idx("first")] = rep((bi_arr == 0).astype(np.uint32))
        t[all_rows, s.idx("fin")] = rep((bi_arr == nbt_arr - 1).astype(np.uint32))
        t[all_rows, s.idx("shard")] = rep(shard_arr)
        t[all_rows, s.idx("clk")] = rep(clk_arr)
        t[all_rows, s.idx("iptr_lo")] = rep((iptr_arr & 0xFFFF).astype(np.uint32))
        t[all_rows, s.idx("iptr_hi")] = rep((iptr_arr >> 16).astype(np.uint32))
        t[all_rows, s.idx("rptr_lo")] = rep((rptr_arr & 0xFFFF).astype(np.uint32))
        t[all_rows, s.idx("rptr_hi")] = rep((rptr_arr >> 16).astype(np.uint32))
        t[all_rows, s.idx("nb")] = rep(nb_arr.astype(np.uint32))
        sink.u16(rep(nb_arr.astype(np.uint32)))
        nz = nb_arr != 1
        if nz.any():
            zi = ff.from_monty(ff.inv(ff.to_monty(((nb_arr - 1) % ff.P).astype(np.uint32))))
            t[all_rows, s.idx("zi")] = rep(np.where(nz, zi, 0).astype(np.uint32))

        def put_limbs(rows, col0, vals64, nlimb=100):
            t[rows, col0 : col0 + nlimb] = (
                (vals64[:, :, None] >> j16) & np.uint64(0xFFFF)
            ).reshape(len(rows), -1).astype(np.uint32)

        def put_bits(rows, col0, vals64):
            t[rows, col0 : col0 + vals64.shape[1] * 64] = (
                (vals64[:, :, None] >> z64) & np.uint64(1)
            ).reshape(len(rows), -1).astype(np.uint32)

        XIDX = np.arange(25) % 5
        PI_DST = np.empty(25, dtype=np.int64)
        PI_ROT = np.empty(25, dtype=np.int64)
        for x in range(5):
            for y in range(5):
                PI_DST[x + 5 * y] = y + 5 * ((2 * x + 3 * y) % 5)
                PI_ROT[x + 5 * y] = ROT[x][y]
        CHI_1 = (XIDX + 1) % 5 + 5 * (np.arange(25) // 5)
        CHI_2 = (XIDX + 2) % 5 + 5 * (np.arange(25) // 5)

        av = av0
        M64 = np.uint64(0xFFFFFFFFFFFFFFFF)
        for r in range(NUM_ROUNDS):
            rows_r = base_rows + r
            t[rows_r, self._base["s0"] + r] = 1
            put_limbs(rows_r, self._base["a0_0"], av)
            cvals = av[:, 0:5] ^ av[:, 5:10] ^ av[:, 10:15] ^ av[:, 15:20] ^ av[:, 20:25]
            cnext = cvals[:, [1, 2, 3, 4, 0]]
            dvals = cvals[:, [4, 0, 1, 2, 3]] ^ (
                ((cnext << np.uint64(1)) | (cnext >> np.uint64(63))) & M64
            )
            cpvals = cvals ^ dvals
            apvals = av ^ dvals[:, XIDX]
            put_bits(rows_r, self._base["c0_0"], cvals)
            put_bits(rows_r, self._base["cp0_0"], cpvals)
            put_bits(rows_r, self._base["ap0_0"], apvals)
            bv = np.empty_like(apvals)
            src = apvals
            # modular shift counts make rot == 0 a no-op (src | src)
            lsh = PI_ROT.astype(np.uint64)
            rsh = ((64 - PI_ROT) % 64).astype(np.uint64)
            rotated = ((src << lsh) | (src >> rsh)) & M64
            bv[:, PI_DST] = rotated
            appv = bv ^ ((~bv[:, CHI_1]) & M64 & bv[:, CHI_2])
            put_limbs(rows_r, self._base["app0_0"], appv)
            put_bits(rows_r, self._base["o0"], appv[:, 0:1])
            out = appv.copy()
            out[:, 0] ^= np.uint64(RC[r])
            av = out

        # prev-state chain: within an event, block bi's prev output is block
        # bi-1's permutation output (zeros for bi == 0)
        prev = np.zeros_like(av0)
        cont = bi_arr > 0
        prev[cont] = av[np.flatnonzero(cont) - 1]

        # absorb witness on the r == 0 rows
        r0 = base_rows
        put_limbs(r0, self._base["po0_0"], prev)
        pbb = ((prev[:, :BLOCK_U64, None] >> j8) & np.uint64(0xFF)).reshape(B, -1).astype(np.uint32)
        ivals = av0[:, :BLOCK_U64] ^ prev[:, :BLOCK_U64]
        ibb = ((ivals[:, :, None] >> j8) & np.uint64(0xFF)).reshape(B, -1).astype(np.uint32)
        obb = pbb ^ ibb
        t[r0, self._base["pb0_0"] : self._base["pb0_0"] + 144] = pbb
        t[r0, self._base["ib0_0"] : self._base["ib0_0"] + 144] = ibb
        t[r0, self._base["ob0_0"] : self._base["ob0_0"] + 144] = obb
        sink.byte_op(ByteOpcode.XOR, obb.reshape(-1), pbb.reshape(-1), ibb.reshape(-1))

        # input word reads (per limb, batched over blocks)
        for wi in range(BLOCK_U32):
            recs = [events[m[0]]["reads"][BLOCK_U32 * m[1] + wi] for m in blk_meta]
            populate_access(
                t, s, r0, f"mi{wi}",
                np.array([x.prev_shard for x in recs], dtype=np.uint32),
                np.array([x.prev_timestamp for x in recs], dtype=np.uint32),
                np.array([x.value for x in recs], dtype=np.uint32),
                shard_arr, np.array([x.timestamp for x in recs], dtype=np.uint32), sink)
        # length read on each event's first block
        f0 = np.flatnonzero(bi_arr == 0)
        lrecs = [events[int(ei_arr[i])]["len_record"] for i in f0]
        populate_access(
            t, s, r0[f0], "ml",
            np.array([x.prev_shard for x in lrecs], dtype=np.uint32),
            np.array([x.prev_timestamp for x in lrecs], dtype=np.uint32),
            np.array([x.value for x in lrecs], dtype=np.uint32),
            shard_arr[f0], np.array([x.timestamp for x in lrecs], dtype=np.uint32), sink)
        # digest writes on each event's last block (last round row)
        fl = np.flatnonzero(bi_arr == nbt_arr - 1)
        rows_fin = base_rows[fl] + NUM_ROUNDS - 1
        for wi in range(16):
            wrecs = [events[int(ei_arr[i])]["writes"][wi] for i in fl]
            wv = np.array([x.value for x in wrecs], dtype=np.uint32)
            t[rows_fin, s.idx(f"w{wi}_lo")] = wv & 0xFFFF
            t[rows_fin, s.idx(f"w{wi}_hi")] = wv >> 16
            populate_access(
                t, s, rows_fin, f"mo{wi}",
                np.array([x.prev_shard for x in wrecs], dtype=np.uint32),
                np.array([x.prev_timestamp for x in wrecs], dtype=np.uint32),
                np.array([x.prev_value for x in wrecs], dtype=np.uint32),
                shard_arr[fl], np.array([x.timestamp for x in wrecs], dtype=np.uint32), sink)
        # pointer-advance carry into the next block (non-last blocks)
        nl = np.flatnonzero(bi_arr != nbt_arr - 1)
        if len(nl):
            lo = (iptr_arr[nl] & 0xFFFF).astype(np.int64)
            t[base_rows[nl] + NUM_ROUNDS - 1, s.idx("cy")] = (lo + 144 >= 65536)
        nf = np.flatnonzero(bi_arr > 0)
        if len(nf):
            sink.u16((iptr_arr[nf] & 0xFFFF).astype(np.uint32))
        return t
